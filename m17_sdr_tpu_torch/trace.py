"""Stage spans and counters of the receive path, for a profiler's trace.

``span(name)`` marks a stage of the receiver and ``count(name, value)``
adds to a counter.  Both do nothing unless a ``torch.profiler`` session
is recording in this process, which one cheap check decides: with no
profiler, ``span`` returns one shared no-op context and ``count`` keeps
nothing, so the receiver makes no extra launch, host read or profiler
call.

While a profiler records, a span is a profiler range named ``m17.<name>``
on the host: its start and end are in the profiler's clock, the range
open around it is its parent, and each device operation launched inside
it can be tied to it by the profiler's correlation ids.  The range is
recorded at function scope, not as a user annotation, so the profiler
makes no device-side copy of it: the trace's device lane holds the
receiver's own kernels, copies and sets alone.

A counter keeps each value by reference (a host int, or a device tensor
the receiver computes anyway) and sums them when ``counters()`` is read,
so counting adds no launch and no host read to the receiver.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "m17."

_OFF = contextlib.nullcontext()
_counts: dict[str, list] = {}


def span(name: str):
    """A context naming a stage of the receiver: ``m17.<name>`` in the
    profiler's trace, nothing when no profiler records."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or an integer tensor summed over all its
    elements) to the counter ``name`` while a profiler records."""
    if torch._C._autograd._profiler_enabled():
        _counts.setdefault(name, []).append(value)


def counters() -> dict[str, int]:
    """Each counter's total since the last ``reset_counters()``."""
    return {name: sum(int(v.sum()) if isinstance(v, torch.Tensor) else int(v) for v in vals)
            for name, vals in _counts.items()}


def reset_counters() -> None:
    _counts.clear()
