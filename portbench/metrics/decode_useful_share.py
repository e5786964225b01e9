"""Share of the traced calls' typed decodes that decoded a frame: every
frame slot goes through all four typed decodes, and a decode is useful
where its slot held a parsed frame of its own type.  Read from the
program's counters (``m17_sdr_tpu_torch.trace``: ``decode.frames`` over
``decode.slots``), which count only while the profiler records; a program
without them gives nothing."""


def read(ctx):
    if ctx["trace"] is None:
        return None
    try:
        from m17_sdr_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    slots = c.get("decode.slots", 0)
    return c.get("decode.frames", 0) / slots if slots else None
