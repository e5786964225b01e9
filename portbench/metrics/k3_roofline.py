"""K3's share of its roofline, in %: the least time the traced calls' front
end needs on this card, from the shapes, over the device time of the
kernels named here.  None where no such kernel ran (a program whose front
end is eager PyTorch).

The work is a least count: every int16 input sample read once, the
decimated soft samples, the DC offset and the in-frame gate, and the
front-end state read and written once (the 2 x 2 discriminator tail, five
float32 scalars and the seeded flag); 20 float32 operations a sample
(scale, |iq|, limiter, discriminator, the two sums).
"""

KERNELS = ("front_end_kernel",)
DECIMATION = 5
OPS_PER_SAMPLE = 20
STATE_BYTES = 16 + 5 * 4 + 1


def work(channels: int, call_samples: int) -> tuple[float, float]:
    """(bytes, ops) of one call's front end at [channels, 2, call_samples] int16."""
    nbytes = (channels * call_samples * 2 * 2 + channels * call_samples // DECIMATION * 4
              + channels * 4 + channels + 2 * channels * STATE_BYTES)
    return float(nbytes), float(OPS_PER_SAMPLE * channels * call_samples)


def read(ctx):
    tr, run, rl = ctx["trace"], ctx["run"], ctx["roofline"]
    if tr is None or run.calls_traced <= 0:
        return None
    ns = sum(o.dur_ns for o in tr.ops if any(k in o.name for k in KERNELS))
    least = rl.bound_s(work(run.channels, run.call_samples), ctx["card"])
    if not ns or least is None:
        return None
    return 100.0 * least * run.calls_traced / (ns / 1e9)
