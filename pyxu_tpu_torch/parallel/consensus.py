r"""Consensus ADMM over a device mesh (counterpart of
``pyxu_tpu/parallel/consensus.py``).

Workload 5: a giga-pixel problem split into B blocks,
``min_x sum_b f_b(x) + g(x)``, solved by consensus ADMM with the block axis
cut over a mesh axis::

    x_b+ = prox_{tau f_b}(z - u_b)              # each rank, its blocks
    z+   = prox_{tau/B g}(mean_b(x_b+ + u_b))   # one all-reduce
    u_b+ = u_b + x_b+ - z+

Each of the n ranks holds its ``B/n`` blocks of ``x, u`` as plain local
tensors; ``z`` is replicated.  The mean is a ``dist.all_reduce`` of the
local sum, divided by B.  With ``mesh=None`` it is the single-process
solver over all B blocks.  Workload 5's per-block functional
``SquaredL2Norm.asloss(y)`` is a ``QuadraticFunc`` whose prox is a CG
(``math/cg.py``); the blocks share their ``Q``, so the separable sum of
``operator/blocks.py`` takes its ``"quadratic"`` rule: one CG over the
rank's stacked blocks, each block stopping on its own residual, with one
host read of the stop flag a check for all of them (the JAX package vmaps
the blocks' CGs into one program).  ``g = L1Norm``'s prox is elementwise.
This path launches no hand-written kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.operator.blocks import block_diag
from pyxu_tpu_torch.opt.stop import RelError
from pyxu_tpu_torch.parallel.mesh import axis_index

__all__ = ["ConsensusADMM"]


class ConsensusADMM(Solver):
    def __init__(self, fs, g=None, mesh=None, mesh_axis: str = None,
                 **kwargs):
        """``fs``: the list of all B per-block proximable functionals (same
        dim_shape); each rank keeps its own ``B/n``.  ``g``: global
        proximable regularizer (optional).  ``mesh``: a ``DeviceMesh``;
        ``mesh_axis``: the name of its axis that cuts the blocks (default
        the first).
        """
        kwargs.setdefault("log_var", ("z",))
        super().__init__(**kwargs)
        if not isinstance(fs, (list, tuple)):
            raise TypeError("fs must be a list of per-block functionals")
        if not fs:
            raise ValueError("fs must be non-empty")
        self._B = len(fs)
        self._dim_shape = fs[0].dim_shape
        self._g = g
        self._mesh = mesh
        self._group = None
        local = list(fs)
        if mesh is not None:
            ax = axis_index(mesh, mesh_axis)
            self._mesh_axis = (mesh.mesh_dim_names or (None,))[ax]
            n_dev = mesh.size(ax)
            if self._B % n_dev != 0:
                raise ValueError(
                    f"ConsensusADMM: {self._B} blocks are not divisible by "
                    f"the {n_dev} devices on mesh axis {self._mesh_axis!r} — "
                    "pad fs to a multiple or use a smaller mesh axis")
            nb = self._B // n_dev
            i = mesh.get_local_rank(ax)
            local = local[i * nb:(i + 1) * nb]
            self._group = mesh.get_group(ax)
        self._fsum = block_diag(local)      # this rank's separable sum
        self._B_local = len(local)

    def _sum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the mesh axis (in place; ``t`` as it is
        without a mesh)."""
        if self._group is not None:
            dist.all_reduce(t, group=self._group)
        return t

    def m_init(self, z0, tau: float = 1.0):
        z0 = torch.as_tensor(z0)
        self._tau = float(tau)
        x = z0.expand((self._B_local,) + tuple(z0.shape))
        return {"x": x, "u": torch.zeros_like(x, memory_format=
                                              torch.contiguous_format),
                "z": z0}

    def m_step(self, mst):
        x, u, z = mst["x"], mst["u"], mst["z"]
        tau, B = self._tau, self._B
        xp = self._fsum.prox(z[None] - u, tau)       # this rank's blocks
        w = self._sum_ranks(torch.sum(xp + u, dim=0)) / B
        zp = self._g.prox(w, tau / B) if self._g is not None else w
        up = u + xp - zp[None]
        return {"x": xp, "u": up, "z": zp}

    def _check(self, stop, cstate, mstate, k):
        """The engine's check, with a device flag reduced by MAX over the
        ranks: every rank takes the same stop decision, or the next
        all-reduce would wait for a rank that left."""
        cstate, stop_now, row = super()._check(stop, cstate, mstate, k)
        if self._group is not None and isinstance(stop_now, torch.Tensor):
            flag = stop_now.to(torch.int32).reshape(1)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
            stop_now = flag[0] > 0
        return cstate, stop_now, row

    def default_stop_crit(self):
        return RelError(eps=1e-4, var="z", rank=len(self._dim_shape))

    def solution(self):
        return self._mstate.get("z")

    def objective_func(self, mst):
        z = mst["z"]
        val = self._fsum.apply(z.expand((self._B_local,) + tuple(z.shape)))
        val = self._sum_ranks(val.reshape(1).clone()).reshape(())
        if self._g is not None:
            val = val + self._g.apply(z)
        return val
