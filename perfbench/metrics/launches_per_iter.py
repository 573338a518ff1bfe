"""Solvers and operators: device operations (kernels, copies, sets)
launched from inside the engine's blocks (``pyxu.solver.block``), an
iteration: what fusing an iteration's passes would cut."""

import harness


def read(ctx):
    pt = harness.load_here("program_trace")
    ivs = pt.ranges(ctx, "pyxu.solver.block")
    if ivs is None:
        return None
    launched = [t for t, _, _ in pt.of(ctx)["launches"]]
    return pt.per_iteration(ctx, pt.count_in(ivs, launched))
