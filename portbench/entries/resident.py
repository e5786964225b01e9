"""Entry ``resident``: whole sessions through ``rx_block``, input on the card.

The north star's call: one ``rx_block`` call takes a whole session of
``session_blocks`` blocks of every channel ``[B, 2, session_blocks * T]``
(int16, made on the card once), followed by ``torch.cuda.synchronize()``,
with the state carried from call to call.  A closed loop: calls run back
to back while the window lasts, and the call in flight when it ends
finishes and counts.

Spans: ``call`` around each call, ``wait`` around each fence.  With a
trace, ``trace_calls`` calls from call ``trace_from`` on run under the
profiler.

The check, on the sampled channels, in two parts:

* the chain: the reference runs the window's first ``chain_calls`` calls
  on its own, from its own initial state, and each call's outputs and the
  state after it are compared with the program's; so the state carried
  from call to call is the reference's own for that many calls;
* the steps: ``check_calls`` calls drawn from the seed in
  ``[chain_calls, check_call_range)`` and the window's last call each
  keep the program's state before the call; the reference runs one call
  from that state, and the outputs and the state after it are compared
  (following every call of a window alone would take the reference
  longer than the window).

The sampled channels of a checked call are gathered on the card as the
call returns, and read to the host once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare
from portbench.ref.pipeline import rx as ref_rx


def prepare(run) -> None:
    sig = run.signal                                    # [B, P, 2, T] int16, device
    nb = int(run.config["session_blocks"])
    b, p, _, t = sig.shape
    idx = torch.arange(nb, device=sig.device) % p
    run.call_input = sig[:, idx].permute(0, 2, 1, 3).reshape(b, 2, nb * t).contiguous()
    run.call_samples = nb * t
    run.sample_idx = torch.as_tensor(run.sample, device=sig.device)
    run.ref_input = run.call_input[run.sample_idx].cpu()
    run.signal = None
    lim = run.cell.limits
    run.chain_calls = int(lim["chain_calls"])
    rng = np.random.default_rng(run.seed)
    run.step_calls = {int(k) for k in rng.integers(
        run.chain_calls, int(lim["check_call_range"]), int(lim["check_calls"]))}


def _call(run, state):
    from m17_sdr_tpu_torch.pipeline import rx

    with run.spans.span("call"):
        out, new = rx.rx_block(run.call_input, state, afc_enabled=bool(run.config["afc"]),
                               equalize=run.config["equalize"])
    with run.spans.span("wait"):
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    return out, new


def _init_state(run):
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState

    return RxSessionState.init(run.call_input.shape[0], run.device)


def warm(run) -> None:
    state = _init_state(run)
    for _ in range(int(run.cell.traffic["warm_calls"])):
        _, state = _call(run, state)
    run.spans.spans.clear()


def _pick(run, tree, call_axis: bool = False) -> dict:
    """The sampled channels of a tree, on its device; outputs get a call axis."""
    d = {k: v.index_select(0, run.sample_idx) for k, v in compare.leaves(tree).items()}
    return {k: v[:, None] for k, v in d.items()} if call_axis else d


def _host(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def window(run, seconds: float) -> dict:
    mix = run.cell.traffic
    trace_from, trace_calls = int(mix["trace_from"]), int(mix["trace_calls"])
    chain, steps = [], {}
    state = _init_state(run)
    k = 0
    t0 = time.perf_counter()
    while True:
        if run.profile is not None and k == trace_from:
            run.profile.start()
        before = _pick(run, state) if k in run.step_calls else None
        out, new = _call(run, state)
        if run.profile is not None and k == trace_from + trace_calls - 1:
            run.profile.stop()
            run.calls_traced = trace_calls
        if k < run.chain_calls:
            chain.append((_pick(run, out, True), _pick(run, new)))
        elif before is not None:
            steps[k] = (before, _pick(run, out, True), _pick(run, new))
        last = (state, out, new)
        state = new
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if run.profile is not None and run.profile.running:
        run.profile.stop()
        run.calls_traced = k - trace_from
    if k - 1 >= run.chain_calls:
        steps[k - 1] = (_pick(run, last[0]), _pick(run, last[1], True), _pick(run, last[2]))
    run.chain = [tuple(_host(d) for d in c) for c in chain]
    run.steps = [(c, *(_host(d) for d in steps[c])) for c in sorted(steps)]
    return {"attempted": k, "failed": 0, "elapsed_s": elapsed,
            "channel_samples": run.call_input.shape[0] * run.call_samples * k}


def _tree(template, flat: dict, prefix: str = ""):
    """Flat numpy dict -> a NamedTuple tree shaped like ``template`` (CPU tensors)."""
    return type(template)(*(
        _tree(x, flat, f"{prefix}{n}/") if isinstance(x, tuple)
        else torch.from_numpy(np.ascontiguousarray(flat[f"{prefix}{n}"]))
        for n, x in zip(template._fields, template)))


def reference(run, lowp: bool = False) -> dict:
    """The reference on the sampled channels: ``chain``, the window's first
    calls from its own initial state, and ``steps``, one call from the
    program's state before each drawn call; each call as (flat outputs
    [S, 1, ...], flat state after)."""
    s = len(run.sample)
    kw = dict(afc_enabled=bool(run.config["afc"]), equalize=run.config["equalize"],
              lowp=lowp)
    init = ref_rx.RxSessionState.init(s, "cpu")
    chain, state = [], init
    for _ in run.chain:
        out, state = ref_rx.rx_block(run.ref_input, state, **kw)
        chain.append(({k: v[:, None] for k, v in compare.flatten(out).items()},
                      compare.flatten(state)))
    steps = []
    if run.steps:
        states = [_tree(init, before) for _, before, _, _ in run.steps]
        state = type(init)(*(_cat([getattr(st, f) for st in states]) for f in init._fields))
        iq = run.ref_input.repeat(len(run.steps), 1, 1)
        out, after = ref_rx.rx_block(iq, state, **kw)
        out, after = compare.flatten(out), compare.flatten(after)
        steps = [({k: v[i * s:(i + 1) * s, None] for k, v in out.items()},
                  {k: v[i * s:(i + 1) * s] for k, v in after.items()})
                 for i in range(len(run.steps))]
    return {"chain": chain, "steps": steps}


def _cat(xs):
    if isinstance(xs[0], tuple):
        return type(xs[0])(*(_cat([x[i] for x in xs]) for i in range(len(xs[0]))))
    return torch.cat(xs)


def check(run, ref) -> dict:
    prog = run.chain + [(out, after) for _, _, out, after in run.steps]
    return compare.merge([compare.compare(out, r_out, after, r_after)
                          for (out, after), (r_out, r_after)
                          in zip(prog, ref["chain"] + ref["steps"])])


def check_control(run, ref, low) -> dict:
    """The reference in bfloat16 judged against the reference, call by call."""
    return compare.merge([compare.compare(lo, ro, la, ra)
                          for (lo, la), (ro, ra)
                          in zip(low["chain"] + low["steps"], ref["chain"] + ref["steps"])])
