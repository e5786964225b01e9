"""The port's benchmark: one run of one cell on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program, ``m17_sdr_tpu_torch``.  The run makes its input from the
seed on the card, warms up the cell's own shapes (the kernels build into
``build/`` on the checkout's first run), measures for ``--seconds``, checks
the outputs against the reference in ``portbench/ref``, and prints one
JSON line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "check"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the profiler's trace and the
harness's spans.  The numbers compared, each beside its limit, are the
last lines of standard error and the last key of the line.  The run exits
non-zero and prints no result without the card(s) the cell asks for, or
if the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # set-up is timed from here, before torch loads

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    # every build and kernel cache lives in the checkout, at a fixed path
    cache = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from portbench import cells, harness, hostinfo

    try:
        cell = cells.load_cell(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"cannot load the cell: {e}")
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return _fail(f"the cell needs {chips} CUDA card(s); this machine has "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import m17_sdr_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program is missing from this checkout: {e}")

    record = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
              **hostinfo.host_record(0)}
    print(f"host: {json.dumps(record)}", file=sys.stderr, flush=True)
    sampler = hostinfo.ClockSampler(0)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)   # noqa: E731
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                             T_START, log=log, sampler=sampler)
    record["clocks_during_window"] = sampler.summary()
    record["window"] = result.pop("_window")
    print(f"window: {json.dumps(record['window'])}", file=sys.stderr, flush=True)
    path = hostinfo.write_record(f"{args.workload}.{args.seed}.{args.trace}", record)
    print(f"card during the window: {json.dumps(record['clocks_during_window'])} "
          f"(record: {path})",
          file=sys.stderr, flush=True)

    found = harness.forbidden_modules()
    if found:
        return _fail(f"the process loaded forbidden modules: {', '.join(found)}")
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
