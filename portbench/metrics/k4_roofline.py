"""K4's share of its roofline, in %: the least time the traced calls' frame
equalizer needs on this card, from the shapes, over the device time of the
kernels named here.  None where no such kernel ran (a program whose
equalizer is eager PyTorch, or a cell that runs it off).

The work is a least count over the F frame slots of a call (F from the
call's length, as the receiver scan extracts them): every frame of 192
float32 symbols read once and written once, the parsed-slot mask, and the
state read and written once (5 taps, the eye estimate, the armed flag);
the operations of the filter (10 a symbol), the eye statistic (10) and
one tap update (40: 20 products and their sums) on every slot.  The bytes
bind: [16384, 15, 192] is 377 MB, 113 us at 3.35 TB/s, against 2.8 G
operations, 42 us at the float32 peak.
"""

FRAME_SYMBOLS = 192
TAPS = 5
KERNELS = ("equalize_kernel",)
OPS_PER_SYMBOL = 10 + 10 + 40
STATE_BYTES = TAPS * 4 + 4 + 1


def work(channels: int, call_samples: int, frame_slots) -> tuple[float, float]:
    """(bytes, ops) of one call's equalizer stage at ``channels`` channels of
    ``call_samples`` input samples; ``frame_slots(call_samples)`` gives F."""
    slots = channels * frame_slots(call_samples)
    nbytes = 2 * slots * FRAME_SYMBOLS * 4 + slots + 2 * channels * STATE_BYTES
    return float(nbytes), float(OPS_PER_SYMBOL * FRAME_SYMBOLS * slots)


def read(ctx):
    tr, run, rl = ctx["trace"], ctx["run"], ctx["roofline"]
    if tr is None or run.calls_traced <= 0:
        return None
    ns = sum(o.dur_ns for o in tr.ops if any(k in o.name for k in KERNELS))
    least = rl.bound_s(work(run.channels, run.call_samples, rl.frame_slots), ctx["card"])
    if not ns or least is None:
        return None
    return 100.0 * least * run.calls_traced / (ns / 1e9)
