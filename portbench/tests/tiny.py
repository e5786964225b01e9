"""A copy of the benchmark with tiny cells added from files alone, for the
CPU tests: each configuration file and mix gets a ``tiny_`` twin at 8
channels and a few blocks, and a cell ``tiny.<mix>`` in BENCHMARK.json.
The streamed mix has no cell in BENCHMARK.json; its tiny cell gets the
metrics a streamed cell would add (``STREAM_METRICS``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MIXES = {"stream_voice": "m17_lime48k", "session_voice": "m17_northstar4096",
         "session_hunt": "m17_northstar4096"}
LIMITS = {"stream_voice": "m17_northstar4096.session_voice",
          "session_voice": "m17_northstar4096.session_voice",
          "session_hunt": "m17_northstar4096.session_hunt"}


STREAM_METRICS = {
    "end_to_end": [{"name": "realtime_channels.stream", "unit": "channels",
                    "better": "higher", "bound": 0.25, "source": "host_clock"}],
    "per_layer": [{"name": n, "unit": "ms", "better": "lower", "source": "program_span",
                   "layer": "Streaming session", "moves": "realtime_channels.stream"}
                  for n in ("feed_ms_per_block", "finish_ms_per_session")],
}


def _rw(path: Path, **changes) -> dict:
    d = json.loads(path.read_text())
    d.update(changes)
    return d


def make_root(tmp: Path, channels: int = 8, check_channels: int = 4) -> Path:
    """A checkout-like root under ``tmp`` with the tiny cells added."""
    root = tmp / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    for mix, cfg in MIXES.items():
        stream = mix.startswith("stream")
        c = _rw(pb / "configs" / f"{cfg}.json", channels=channels,
                session_blocks=3 if stream else 2, chunk_blocks=2)
        (pb / "configs" / f"tiny_{mix}.json").write_text(json.dumps(c))
        t = _rw(pb / "traffic" / f"{mix}.json", warm_blocks=2, warm_calls=1,
                trace_from=1, trace_calls=1)
        (pb / "traffic" / f"tiny_{mix}.json").write_text(json.dumps(t))
        lim = _rw(pb / "limits" / f"{LIMITS[mix]}.json", check_channels=check_channels)
        if stream:   # the streamed mix has no cell: the voice cell's limits
            lim = {"check_channels": check_channels, "limits": lim["limits"]}
        else:
            lim.update(chain_calls=2, check_calls=1, check_call_range=4)
        (pb / "limits" / f"tiny.{mix}.json").write_text(json.dumps(lim))
        bench["configs"].append({"name": f"tiny_{mix}", "source": "tiny twin",
                                 "file": f"portbench/configs/tiny_{mix}.json",
                                 "reduced": ["channels", "session_blocks", "chunk_blocks"],
                                 "why": "CPU test size"})
        bench["workloads"].append({"name": f"tiny.{mix}", "config": f"tiny_{mix}",
                                   "traffic": f"tiny_{mix}", "chips": 1, "why": "CPU test"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m and any(w.endswith(mix) for w in m["workloads"]):
                m["workloads"].append(f"tiny.{mix}")
    for group, metrics in STREAM_METRICS.items():
        bench[group] += [dict(m, workloads=["tiny.stream_voice"]) for m in metrics]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
