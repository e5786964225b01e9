"""Host ms of ``StreamingRx.finish()`` a session (the harness's ``finish``
spans): the last chunks, the concatenation and the one read to the host."""


def read(ctx):
    d = ctx["run"].spans.durations("finish")
    return 1e3 * sum(d) / len(d) if d else None
