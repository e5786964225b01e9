"""Host spans around the calls into the program, and the profiler's trace
of the device.

``Spans`` records, by the host clock, each call the harness makes into a
layer of the program (``feed``, ``finish``, ``call``, ``wait``); while the
profiler runs, each span is also a ``record_function`` range, so that the
trace can name what the host was doing in every idle gap of the card.

``Profile`` wraps ``torch.profiler`` over a part of the window and reduces
its events to what the per-layer readers take: the device operations
(kernels, copies, sets) with their times, the host spans in the trace's
clock, the busy time of the card and the length of the traced window.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    t0: float           # host clock, s
    t1: float
    traced: bool        # recorded while the profiler ran


class Spans:
    def __init__(self):
        self.spans: list[Span] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            import torch
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans.append(Span(name, t0, time.perf_counter(), self.profiling))

    def durations(self, name: str) -> list[float]:
        """Seconds of the untraced spans of this name, or of the traced ones
        where no untraced span exists."""
        sel = [s for s in self.spans if s.name == name]
        plain = [s for s in sel if not s.traced]
        return [s.t1 - s.t0 for s in (plain or sel)]


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    ops: list               # [DeviceOp] kernels, copies and sets on the card
    host: list              # [(name, start_ns, end_ns)] spans in the trace's clock
    window_s: float         # length of the traced window (host clock)
    busy_s: float           # seconds in which some operation ran on the card
    intervals: list         # merged busy intervals [(start_ns, end_ns)]
    t0_ns: int              # the traced window in the trace's clock
    t1_ns: int


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


def merge_intervals(ops: list) -> list:
    spans = sorted((o.start_ns, o.start_ns + o.dur_ns) for o in ops)
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_events(events, span_names, window_s: float) -> Trace:
    """Kineto events -> Trace.  Device operations are the events not on the
    CPU, less the device-side copies of the harness's own ranges; host
    spans are the CPU ranges named like a harness span."""
    ops, host = [], []
    for ev in events:
        name = ev.name()
        if str(ev.device_type()).endswith("CPU"):
            if name in span_names:
                s = _ns(ev, "start")
                host.append((name, s, s + _ns(ev, "duration")))
        elif name not in span_names:
            ops.append(DeviceOp(name, _ns(ev, "start"), _ns(ev, "duration")))
    intervals = merge_intervals(ops)
    busy = sum(b - a for a, b in intervals) / 1e9
    t0 = min([h[1] for h in host] + [iv[0] for iv in intervals] or [0])
    t1 = max([h[2] for h in host] + [iv[1] for iv in intervals] or [0])
    return Trace(ops, host, window_s, busy, intervals, t0, t1)


class Profile:
    """Start and stop ``torch.profiler`` around part of a window."""

    def __init__(self, spans: Spans, cuda: bool):
        self.spans = spans
        self.cuda = cuda
        self._prof = None
        self._done = None
        self._t0 = 0.0
        self._window_s = 0.0
        self.trace: Trace | None = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.spans.profiling = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Stop tracing; the events are reduced later, by ``reduce``."""
        import torch
        if self._prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._window_s = time.perf_counter() - self._t0
        self.spans.profiling = False
        self._prof.__exit__(None, None, None)
        self._done, self._prof = self._prof, None

    def reduce(self) -> Trace | None:
        """The stopped profile's events -> ``self.trace`` (after the window:
        the reduction takes seconds for a long trace)."""
        if self._done is not None:
            names = {s.name for s in self.spans.spans}
            self.trace = reduce_events(self._done.profiler.kineto_results.events(), names,
                                       self._window_s)
            self._done = None
        return self.trace

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start in a
        process initialises the device tracer, which takes seconds."""
        self.start()
        self.stop()
        self._done = None

    @property
    def running(self) -> bool:
        return self._prof is not None


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the card, each named by the host span open at its middle."""
    by_name: dict = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0) + o.dur_ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = []
    edges = [trace.t0_ns] + [x for iv in trace.intervals for x in iv] + [trace.t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) // 2
            # the harness's spans follow one another: the one that opened
            # last before the middle holds it, if it is still open
            i = bisect.bisect_right(starts, mid) - 1
            name = host[i][0] if i >= 0 and host[i][2] >= mid else "outside_any_span"
            gaps.append((name, b - a))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:96], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps[:top]]}
