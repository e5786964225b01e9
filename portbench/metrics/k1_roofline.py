"""K1's share of its roofline, in %: the least time the traced calls' four
typed Viterbi decodes need on this card (``roofline.k1_work`` from the
shapes) over the device time of the kernels named here."""

KERNELS = ("viterbi_kernel",)


def read(ctx):
    tr, run, rl = ctx["trace"], ctx["run"], ctx["roofline"]
    if tr is None or run.calls_traced <= 0:
        return None
    ns = sum(o.dur_ns for o in tr.ops if any(k in o.name for k in KERNELS))
    least = rl.bound_s(rl.k1_work(run.channels, run.call_samples), ctx["card"])
    if not ns or least is None:
        return None
    return 100.0 * least * run.calls_traced / (ns / 1e9)
