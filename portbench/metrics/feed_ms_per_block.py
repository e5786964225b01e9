"""Host ms inside ``StreamingRx.feed_block`` a block (the harness's ``feed``
spans, outside the profiled session where there is one): dispatch of the
chunk's launches, and the wait for the staged upload."""


def read(ctx):
    d = ctx["run"].spans.durations("feed")
    return 1e3 * sum(d) / len(d) if d else None
