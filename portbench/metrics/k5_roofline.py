"""K5's share of its roofline, in %: the least time the traced calls' frame
compaction needs on this card, from the shapes, over the device time of
the kernels named here.  None where no such kernel ran (a program whose
compaction is eager PyTorch).

The work is a least count over a call of S2 scan steps and F frame slots
(both from the call's length): the slot values and flags read once, the
191-symbol history read and written once, the frames [F, 192] float32
written once, the four [F] masks (three bool, the int32 type) and the
block's aos, los and slip count.  The bytes bind: [4096, 4992] is 217.5
MB, 65 us at 3.35 TB/s; a step costs a few integer operations.
"""

FRAME_SYMBOLS = 192
HIST = FRAME_SYMBOLS - 1
KERNELS = ("compact_kernel",)


def work(channels: int, call_samples: int, steps, frame_slots) -> tuple[float, float]:
    """(bytes, ops) of one call's compaction at ``channels`` channels of
    ``call_samples`` input samples; ``steps`` and ``frame_slots`` give S2
    and F from the call's length."""
    s2, f = steps(call_samples), frame_slots(call_samples)
    nbytes = channels * (s2 * 4 * 2 + HIST * 4 * 2 + f * FRAME_SYMBOLS * 4
                         + f * (1 + 4 + 1 + 1) + 1 + 1 + 4)
    return float(nbytes), 0.0


def read(ctx):
    tr, run, rl = ctx["trace"], ctx["run"], ctx["roofline"]
    if tr is None or run.calls_traced <= 0:
        return None
    ns = sum(o.dur_ns for o in tr.ops if any(k in o.name for k in KERNELS))
    least = rl.bound_s(work(run.channels, run.call_samples, rl.steps, rl.frame_slots),
                       ctx["card"])
    if not ns or least is None:
        return None
    return 100.0 * least * run.calls_traced / (ns / 1e9)
