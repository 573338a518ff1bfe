"""Device: ms a solve that the card sat idle while the host was inside one
of the program's ranges (``pyxu.*``): the idle intervals' overlap with
those ranges, the part of ``device_idle_pct`` that the port's own host
work holds."""

import harness


def read(ctx):
    pt = harness.load_here("program_trace")
    pr = pt.of(ctx)
    if pr is None or not pr["program"] or not ctx["solves"]:
        return None
    ns = sum(t for n, t in pr["idle_by_span"].items()
             if n.startswith(pt.PROGRAM))
    return ns * 1e-6 / ctx["solves"]
