"""Entry ``stream``: ``StreamingRx`` fed host int16 blocks directly.

A closed loop over a backlog of captures: each session is a new
``StreamingRx`` that takes ``session_blocks`` wire blocks ``[B, T, 2]``
through ``feed_block`` (the mix's periodic signal, cycled from its first
block) and ends in ``finish()``, the session's one read to the host; the
next session starts when it returns.  Sessions start while the window
lasts, and the one in flight when it ends finishes and counts.

Spans: ``feed`` around each ``feed_block``, ``finish`` around each
``finish()``.  With a trace, the window's first session runs under the
profiler.  Every session's outputs on the sampled channels are kept and
compared with one run of the reference over the same blocks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare
from portbench.ref.pipeline import rx as ref_rx
from portbench.signals import WIRE_SCALE


def _settings(run):
    c = run.config
    return dict(input_rate=int(c["input_rate"]), afc=bool(c["afc"]),
                equalize=c["equalize"], chunk_blocks=int(c["chunk_blocks"]))


def prepare(run) -> None:
    sig = run.signal                                   # [B, P, 2, T] int16, device
    run.blocks = list(sig.permute(1, 0, 3, 2).contiguous().cpu().numpy())   # P x [B, T, 2]
    run.session_blocks = int(run.config["session_blocks"])
    run.call_samples = int(run.cell.config["block_samples"])
    run.ref_input = sig[torch.as_tensor(run.sample, device=sig.device)].cpu()
    run.signal = None


def _session(run, n_blocks: int):
    from m17_sdr_tpu_torch.app.streaming import StreamingRx

    srx = StreamingRx(batch=len(run.blocks[0]), device=run.device, **_settings(run))
    for i in range(n_blocks):
        with run.spans.span("feed"):
            srx.feed_block(run.blocks[i % len(run.blocks)])
    with run.spans.span("finish"):
        out, state, _ = srx.finish()
    return out, state


def warm(run) -> None:
    n = int(run.cell.traffic["warm_blocks"])
    _session(run, n)
    run.spans.spans.clear()


def window(run, seconds: float) -> dict:
    kept, times = [], []
    sessions = 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        if run.profile is not None and sessions == 0:
            run.profile.start()
        out, state = _session(run, run.session_blocks)
        if run.profile is not None and run.profile.running:
            run.profile.stop()
            run.calls_traced = run.session_blocks
        kept.append((compare.flatten(out), compare.flatten(state)))
        kept[-1] = ({k: v[run.sample] for k, v in kept[-1][0].items()},
                    {k: v[run.sample] for k, v in kept[-1][1].items()})
        del out, state
        times.append(time.perf_counter() - ts)
        sessions += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    run.kept = kept
    b = len(run.blocks[0])
    return {"attempted": sessions, "failed": 0, "elapsed_s": elapsed, "session_s": times,
            "channel_samples": b * run.call_samples * run.session_blocks * sessions}


def reference(run, lowp: bool = False):
    """The reference over the session's blocks on the sampled channels ->
    (flat outputs [S, NB, ...], flat final state)."""
    wire = run.ref_input                                   # [S, P, 2, T] int16
    p = wire.shape[1]
    iq = [wire[:, i % p].to(torch.float32) * WIRE_SCALE for i in range(run.session_blocks)]
    outs, state = ref_rx.rx_blocks(iq, ref_rx.RxSessionState.init(wire.shape[0], "cpu"),
                                   afc_enabled=bool(run.config["afc"]),
                                   equalize=run.config["equalize"], lowp=lowp)
    out = {f: np.stack([o[i].numpy() for o in outs], axis=1)
           for i, f in enumerate(ref_rx.RxBlockOutput._fields)}
    return out, compare.flatten(state)


def check(run, ref) -> dict:
    """Every kept session against the reference."""
    ref_out, ref_state = ref
    return compare.merge([compare.compare(o, ref_out, s, ref_state) for o, s in run.kept])


def check_control(run, ref, low) -> dict:
    """The reference in bfloat16 judged against the reference."""
    return compare.compare(low[0], ref[0], low[1], ref[1])
