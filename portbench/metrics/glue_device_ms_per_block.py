"""Device ms a 40 ms block of every kernel but the two hand-written ones
(K1, the Viterbi decoder; K2, the receiver scan): the eager glue of the
front end, the compaction, the demap, the typed decodes' bit work, the
equalizer and the session layer.  Copies are left out."""

HAND_WRITTEN = ("viterbi_kernel", "receiver_scan_kernel")
COPIES = ("Memcpy", "Memset")


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    if tr is None or run.blocks_traced <= 0:
        return None
    ns = sum(o.dur_ns for o in tr.ops
             if not o.name.startswith(COPIES) and not any(k in o.name for k in HAND_WRITTEN))
    return ns / 1e6 / run.blocks_traced if ns else None
