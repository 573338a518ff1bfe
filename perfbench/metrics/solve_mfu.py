"""Solve: the share of the chip's peak that the window's solves take, the
least time their work needs (the configuration's iteration work times
the iterations, plus its per-solve work, each the larger of bytes at the
peak bandwidth and operations at the peak float32 rate) over the traced
window's seconds."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["solves"]:
        return None
    w = ctx["cfg"]["work"]
    t = ctx["bound_s"](w["iteration"])
    if t is None:
        return None
    t *= ctx["iterations"]
    for name in w.get("solve", []):
        t += ctx["bound_s"](name)
    return 100.0 * t * ctx["solves"] / tr["window_s"]
