"""Solver engine: reads of a device flag by the host
(``runtime.host_read.count``) over the window, a solve."""


def read(ctx):
    c0, c1 = ctx["counters"]
    if not ctx["solves"] or "host_read" not in c0:
        return None
    return (c1["host_read"] - c0["host_read"]) / ctx["solves"]
