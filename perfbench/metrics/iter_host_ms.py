"""Solvers and operators: host ms an iteration inside the engine's blocks
(``pyxu.solver.block``: the iterations' operand calls and launches), from
the program's ranges in the device trace; against ``iter_device_ms`` it
says whether the host keeps ahead of the card."""

import harness


def read(ctx):
    pt = harness.load_here("program_trace")
    ivs = pt.ranges(ctx, "pyxu.solver.block")
    if ivs is None:
        return None
    return pt.per_iteration(ctx, pt.total(ivs) * 1e-6)
