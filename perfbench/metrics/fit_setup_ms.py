"""Solver engine: host ms a solve inside the engine's set-up of a fit
(``pyxu.solver.init``: the fit's set-up, ``m_init`` with the step sizes
and the fusion match), from the program's ranges in the device trace."""

import harness


def read(ctx):
    pt = harness.load_here("program_trace")
    ivs = pt.ranges(ctx, "pyxu.solver.init")
    if ivs is None or not ctx["solves"]:
        return None
    return pt.total(ivs) * 1e-6 / ctx["solves"]
