"""Share of the traced calls' frame slots on which the automatic equalizer
adapted: the parsed slots of armed channels (``equalize.armed``) over the
slots that entered the equalizer stage (``equalize.slots``).  Read from
the program's counters (``m17_sdr_tpu_torch.trace``), which count only
while the profiler records; a program without them, or a cell that runs
the equalizer off, gives nothing."""


def read(ctx):
    if ctx["trace"] is None:
        return None
    try:
        from m17_sdr_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    slots = c.get("equalize.slots", 0)
    return c.get("equalize.armed", 0) / slots if slots else None
