"""Share of the traced window in which no kernel, copy or set ran on the
card."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return max(0.0, 1.0 - tr.busy_s / tr.window_s)
