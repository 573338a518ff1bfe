"""``tv_deconv_4k`` through the port's public API.

Built once: the blur K (a 9-tap separable Gaussian Stencil), the gradient
D and h = lam ||.||_{2,1}, and g (``PositiveOrthant`` under the
``nonneg`` mix).  Each solve: the frame to the device, the data term
0.5 ||K x - y||^2 and a ``CondatVu`` solver, ``fit`` for the mix's
iterations from x0 = y, the solution back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _taps(sigma: float, ksize: int) -> np.ndarray:
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


class Problem:
    def __init__(self, cfg: dict, traffic: dict, device):
        import pyxu_tpu_torch.operator as O
        from pyxu_tpu_torch.opt.solver import CondatVu
        from pyxu_tpu_torch.opt.stop import MaxIter
        self.O, self.CondatVu, self.MaxIter = O, CondatVu, MaxIter
        self.shape = tuple(cfg["frame"])
        self.device = torch.device(device)
        k = _taps(cfg["blur_sigma"], cfg["blur_taps"])
        c = (len(k) - 1) // 2
        self.K = O.Stencil(self.shape, [k, k], [c, c], mode="symmetric")
        self.D = O.Gradient(self.shape, mode="symmetric")
        self.h = cfg["lam"] * O.L21Norm((2,) + self.shape, l2_axis=0)
        self.g = (O.PositiveOrthant(self.shape)
                  if traffic.get("constraint") == "nonneg" else None)
        self.iterations = int(traffic["iterations"])
        self.precision = None        # the control: a bf16 schedule

    def solve(self, y_host, span, out):
        """One solve; the solution is copied into the host buffer ``out``
        (from :meth:`new_output`), which is returned."""
        n = self.iterations
        with span("upload"):
            y = y_host.to(self.device)
        with span("build"):
            f = 0.5 * self.O.SquaredL2Norm(self.shape).asloss(y) * self.K
            slv = self.CondatVu(f=f, g=self.g, h=self.h, K=self.D,
                                stop_rate=n)
        with span("fit"):
            kw = {}
            if self.precision is not None:
                kw["precision_schedule"] = [(self.precision, None)]
            slv.fit(x0=y, stop_crit=self.MaxIter(n), max_iter=n, **kw)
        with span("download"):
            out.copy_(slv.solution())
        return out

    def new_output(self, pinned: bool):
        """A zeroed host buffer of one solution."""
        return torch.zeros(self.shape, dtype=torch.float32,
                           pin_memory=pinned)

    def counters(self) -> dict:
        from pyxu_tpu_torch import runtime
        return dict(host_read=runtime.host_read.count)


def build(cfg: dict, traffic: dict, shared, device) -> Problem:
    return Problem(cfg, traffic, device)
