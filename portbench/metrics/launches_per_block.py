"""CUDA kernel launches a 40 ms block of signal: the kernels in the
profiler's trace (copies and sets left out) over the blocks the traced
calls took."""

COPIES = ("Memcpy", "Memset")


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    if tr is None or run.blocks_traced <= 0:
        return None
    n = sum(1 for o in tr.ops if not o.name.startswith(COPIES))
    return n / run.blocks_traced if n else None
