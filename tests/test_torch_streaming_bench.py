"""The port's streaming bench (m17_sdr_tpu_torch.tools.streaming_bench)
against the JAX tool (tools/streaming_bench.py), small and on the CPU.

The session the bench times is ``StreamingRx`` fed the tool's noise
blocks, so its decode must equal ``rx_stream`` of the same blocks; its
lines carry the JAX tool's keys (tools/streaming_bench.py:101-136, and
the legs recorded in STREAMING_r5.json).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream
from m17_sdr_tpu_torch.tools import streaming_bench as sb

torch.set_num_threads(2)
RECORD = json.loads((Path(__file__).resolve().parents[1] / "STREAMING_r5.json").read_text())
# tools/streaming_bench.py's two kinds of line
THROUGHPUT_KEYS = {"mode", "platform", "equalize", "batch", "rate", "blocks", "wall_s",
                   "channel_samples_per_s", "realtime_factor_per_channel",
                   "realtime_channels"}
LATENCY_KEYS = {"mode", "platform", "equalize", "batch", "rate", "chunk_blocks",
                "chunk_signal_ms", "chunks", "chunk_wall_ms", "realtime_margin_med"}


def test_noise_blocks():
    blocks = sb.noise_blocks(2, 48_000)
    rng = np.random.default_rng(0)
    assert len(blocks) == 50
    for blk in blocks:
        np.testing.assert_array_equal(blk, rng.integers(-8000, 8000, (2, 1920, 2),
                                                        dtype=np.int16))
    assert sb.noise_blocks(1, 384_000)[0].shape == (1, 15360, 2)


def test_throughput_session_equals_rx_stream():
    """B=2, 10 blocks, 5-block chunks: the timed session decodes as
    ``rx_stream`` does on the same blocks (equalizer "auto")."""
    results, srx = sb.run(2, 10, chunk_blocks=5, device="cpu")
    out, state, nblk = srx.finish()
    assert nblk == 10
    wire = np.stack(sb.noise_blocks(2, 48_000)[:10], axis=1)       # [2, 10, 1920, 2]
    iq = torch.as_tensor(wire).movedim(-1, -2)                       # [2, 10, 2, 1920]
    out_r, st_r = rx_stream(iq, RxSessionState.init(2, "cpu"), equalize="auto")
    for name in out_r._fields:
        np.testing.assert_array_equal(getattr(out, name), getattr(out_r, name).numpy(),
                                      err_msg=name)
    for name in st_r._fields:
        if name in ("frontend", "receiver", "eq"):
            for f in getattr(st_r, name)._fields:
                np.testing.assert_array_equal(getattr(getattr(state, name), f),
                                              getattr(getattr(st_r, name), f).numpy(),
                                              err_msg=f"{name}.{f}")
        else:
            np.testing.assert_array_equal(getattr(state, name), getattr(st_r, name).numpy(),
                                          err_msg=name)

    (r,) = results
    assert set(r) == THROUGHPUT_KEYS
    assert (r["mode"], r["platform"], r["equalize"], r["batch"], r["rate"], r["blocks"]) == \
        ("throughput", "cpu", "auto", 2, 48_000, 10)
    # the rate is the samples over the unrounded wall time, rounded to an
    # integer; wall_s is that time rounded to the ms
    n = 2 * 10 * 1920
    assert n / (r["wall_s"] + 5e-4) - 0.5 <= r["channel_samples_per_s"] \
        <= n / (r["wall_s"] - 5e-4) + 0.5
    # the record's throughput legs hold a subset of a line's keys
    assert set(RECORD["tpu_batch1_48k"]) <= THROUGHPUT_KEYS
    assert set(RECORD["tpu_batch256_48k_best"]) <= THROUGHPUT_KEYS


def test_chunk_latency_lines_and_384k_at_b1(capsys):
    """Chunk-latency lines: the JAX tool's keys, blocks // chunk_blocks
    chunks; the 384 kHz leg at B=1, through the CLI."""
    assert sb.main(["1", "10", "--chunk-blocks", "5", "--chunk-latency", "--rate", "384000",
                    "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    r = json.loads(line)
    assert set(r) == LATENCY_KEYS
    assert (r["mode"], r["platform"], r["batch"], r["rate"], r["chunk_blocks"], r["chunks"]) == \
        ("chunk_latency", "cpu", 1, 384_000, 5, 10 // 5)
    assert r["chunk_signal_ms"] == 200.0
    w = r["chunk_wall_ms"]
    assert set(w) == {"min", "med", "p90", "max"} and 0 < w["min"] <= w["med"] <= w["max"]
    for leg in ("cpu_live_chunk_latency_48k", "cpu_live_chunk_latency_384k",
                "tpu_batch256_chunk_latency_48k"):
        assert set(RECORD[leg]) <= LATENCY_KEYS, leg
        assert set(RECORD[leg]["chunk_wall_ms"]) == set(w), leg

    results, _ = sb.run(1, 7, chunk_blocks=3, chunk_latency=True, device="cpu",
                        blocks=sb.noise_blocks(1, 48_000)[:4])
    assert results[0]["chunks"] == 7 // 3


def test_device_cuda_without_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sb.main(["1", "5"]) == 1
    assert sb.main(["1", "5", "--device", "cuda"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
