"""Solvers and operators: the host's calls that wait on the card (stream,
device and event synchronises, synchronous copies, frees:
``program_trace.SYNCS``) made inside the engine's blocks
(``pyxu.solver.block``), an iteration."""

import harness


def read(ctx):
    pt = harness.load_here("program_trace")
    ivs = pt.ranges(ctx, "pyxu.solver.block")
    if ivs is None:
        return None
    starts = [s for _, s, _, _ in pt.of(ctx)["syncs"]]
    return pt.per_iteration(ctx, pt.count_in(ivs, starts))
