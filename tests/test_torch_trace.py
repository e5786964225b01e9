"""The receiver's stage spans and decode counters (``m17_sdr_tpu_torch.trace``)
and the stage profiler's split of a profile by stage, on the CPU at B=8
with half blocks (960 samples) of the bench mix: four carry the state,
the fifth is the call under test."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from m17_sdr_tpu_torch import trace
from m17_sdr_tpu_torch.dsp.discriminator import rx_front_end
from m17_sdr_tpu_torch.frame.receiver import receive_block
from m17_sdr_tpu_torch.pipeline import rx
from m17_sdr_tpu_torch.pipeline.benchdata import make_bench_blocks
from m17_sdr_tpu_torch.tools.profile_stages import stage_split

torch.set_num_threads(2)
B = 8
STAGES = ["front_end", "scan", "compaction", "demap", "decode.lsf", "decode.stream",
          "decode.packet", "decode.bert", "session"]


@pytest.fixture(scope="module")
def call():
    """(the block under test [B, 2, T] int16, the state before it)."""
    blocks, _ = make_bench_blocks(64, 960, device="cpu")
    blocks = [b[:B].contiguous() for b in blocks]
    state = rx.RxSessionState.init(B, "cpu")
    for blk in blocks[:4]:
        _, state = rx.rx_block(blk, state)
    return blocks[4], state


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for name, x in zip(getattr(tree, "_fields", range(len(tree))), tree):
        out.update(_leaves(x, f"{prefix}/{name}"))
    return out


def _profiled(fn):
    """fn() under the profiler: (its result, the events, the counters)."""
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, prof.profiler.kineto_results.events(), trace.counters()


_TRACED: dict = {}


def _traced_call(call, equalize):
    """One profiled ``rx_block`` call a mode, shared by the tests."""
    if equalize not in _TRACED:
        blk, state = call
        _TRACED[equalize] = _profiled(lambda: rx.rx_block(blk, state, equalize=equalize))
    return _TRACED[equalize]


def _ranges(events, prefix):
    return sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in events if e.name().startswith(prefix)), key=lambda r: r[0])


@pytest.mark.parametrize("equalize", [False, "on", "auto"])
def test_stage_spans_tile_rx_block(call, equalize):
    """Each stage once, in order, inside ``m17.rx_block``, and every torch
    operator the call runs (each launch on a card) inside one stage."""
    _, events, _ = _traced_call(call, equalize)
    spans = _ranges(events, trace.PREFIX)
    want = list(STAGES)
    if equalize:
        want.insert(want.index("demap"), "equalize")
    assert [n for _, _, n in spans] == ["m17.rx_block"] + ["m17." + s for s in want]
    t0, t1, _ = spans[0]
    stages = spans[1:]
    assert all(t0 <= a <= b <= t1 for a, b, _ in stages)
    assert all(b <= a2 for (_, b, _), (a2, _, _) in zip(stages, stages[1:]))
    ops = [(a, b) for a, b, n in _ranges(events, "aten::") if t0 <= a <= t1]
    assert ops
    assert all(any(s <= a and b <= e for s, e, _ in stages) for a, b in ops)


def test_rx_block_soft_spans(call):
    blk, state = call
    soft, _, _ = rx_front_end(blk, state.frontend, state.receiver.flock)
    _, events, _ = _profiled(lambda: rx.rx_block_soft(soft, state))
    assert [n for _, _, n in _ranges(events, trace.PREFIX)] == (
        ["m17.rx_block"] + ["m17." + s for s in STAGES])


def test_no_profiler_no_range_and_no_count(call, monkeypatch):
    """With no profiler the spans are one shared no-op, no profiler range
    is made and nothing is counted."""
    def refuse(*_):
        raise AssertionError("a profiler range was made with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trace.reset_counters()
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("a") is trace.span("b")
    blk, state = call
    rx.rx_block(blk, state)
    assert trace.counters() == {}


def test_decode_counters(call):
    """``decode.slots`` is 4 B F; ``decode.frames`` the slots that hold a
    parsed frame, recomputed from ``receive_block``'s events."""
    blk, state = call
    (out, _), _, counters = _traced_call(call, False)
    soft, _, _ = rx_front_end(blk, state.frontend, state.receiver.flock)
    events, _ = receive_block(soft, state.receiver)
    f = events.frame_valid.shape[1]
    frames = int((events.frame_valid & events.frame_parse).sum())
    assert frames > 0
    assert counters == {"decode.slots": 4 * B * f, "decode.frames": frames}
    assert out.stream_valid.shape == (B, f)


def test_equalize_counters(call):
    """``equalize.slots`` is B F for a call with the equalizer on or
    automatic; ``equalize.armed`` counts the parsed slots of armed channels
    (every channel when on), recomputed from the events and the stage;
    nothing is counted without a profiler."""
    from m17_sdr_tpu_torch.dsp.equalize import eye_closure

    blk, state = call
    # an eye estimate that keeps every channel armed through the call
    armed = state._replace(eq_armed=torch.ones(B, dtype=torch.bool),
                           eye_est=torch.full((B,), 0.3))
    soft, _, _ = rx_front_end(blk, state.frontend, state.receiver.flock)
    events, _ = receive_block(soft, state.receiver)
    f = events.frame_valid.shape[1]
    valid = events.frame_valid & events.frame_parse
    for st, equalize in ((state, "on"), (state, "auto"), (armed, "auto")):
        _, _, counters = _profiled(lambda: rx.rx_block(blk, st, equalize=equalize))
        if equalize == "on":
            want = int(valid.sum())
        else:
            _, now = eye_closure(events.frames, valid, st.eye_est, st.eq_armed)
            want = int((valid & now[:, None]).sum())
        assert counters["equalize.slots"] == B * f
        assert counters["equalize.armed"] == want
    assert want == int(valid.sum()) > 0
    trace.reset_counters()
    rx.rx_block(blk, armed, equalize="auto")
    assert trace.counters() == {}


def test_outputs_equal_with_and_without_profiler(call):
    blk, state = call
    plain = rx.rx_block(blk, state, equalize="auto")
    traced, _, _ = _traced_call(call, "auto")
    a, b = _leaves(plain), _leaves(traced)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class _Ev:
    def __init__(self, name, cpu, corr, start, dur, tid=1, user=False):
        self.v = (name, cpu, corr, start, dur, tid, user)

    def name(self):
        return self.v[0]

    def device_type(self):
        return "DeviceType.CPU" if self.v[1] else "DeviceType.CUDA"

    def correlation_id(self):
        return self.v[2]

    def start_ns(self):
        return self.v[3]

    def duration_ns(self):
        return self.v[4]

    def start_thread_id(self):
        return self.v[5]

    def is_user_annotation(self):
        return self.v[6]


def test_stage_split_books_each_launch_to_its_innermost_stage():
    evs = [_Ev("call", True, 1, 0, 1000, user=True), _Ev("call", False, 1, 0, 900, user=True),
           _Ev("m17.rx_block", True, 2, 10, 900), _Ev("m17.front_end", True, 3, 20, 100),
           _Ev("m17.scan", True, 4, 200, 100),
           _Ev("cudaLaunchKernel", True, 50, 30, 5), _Ev("k_fe", False, 50, 300, 40),
           _Ev("cudaLaunchKernel", True, 51, 150, 5), _Ev("k_top", False, 51, 340, 10),
           _Ev("cuLaunchKernel", True, 52, 250, 5), _Ev("k_scan", False, 52, 350, 60),
           _Ev("cudaMemcpyAsync", True, 53, 950, 5), _Ev("Memcpy HtoD", False, 53, 955, 2),
           _Ev("cudaLaunchKernel", True, 54, 260, 5, tid=2), _Ev("k_other", False, 54, 420, 7),
           _Ev("k_untied", False, 99, 500, 3)]
    split, lags = stage_split(evs)
    assert split == {"front_end": 40, "rx_block": 10, "scan": 60, None: 9, "untied": 3}
    assert sorted(lags) == [5, 100, 160, 190, 270]
