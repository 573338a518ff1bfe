"""Plain reference and inputs of ``tv_deconv_4k``: TV-regularised
deconvolution by Condat-Vu (Condat, JOTA 158(2):460-479, 2013),

    min_x 0.5 ||K x - y||^2 + g(x) + lam ||D x||_{2,1}

with K a separable Gaussian blur and D the forward-difference gradient,
both over symmetric (edge-repeating) padding, g = 0 or the indicator of
x >= 0, x0 = y, z0 = 0 and rho = 1::

    x+ = prox_{tau g}(x - tau K^T (K x - y) - tau D^T z)
    z+ = proj_{||.||_2 <= lam per pixel}(z + sigma D (2 x+ - x))

The step sizes follow the operator algebra's declared bounds, worked out
here from the taps: ||S|| <= sqrt(m) ||k||_1 for a padded correlation S
whose padding repeats an entry at most m times (a product over the padded
axes), ||D||^2 <= sum of its partials' squared bounds, beta = ||K||^2 and
tau = sigma = (-beta/2 + sqrt(beta^2/4 + ||D||^2)) / ||D||^2.

Plain PyTorch in float64 on the frames' device, written from the
equations above; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gauss_taps(sigma: float, ksize: int) -> np.ndarray:
    """The normalised 1-D Gaussian, rounded to float32 as stated."""
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def sym_index(n: int, lo: int, hi: int) -> np.ndarray:
    """Source index of each entry of an axis of length n padded by
    (lo, hi) with its edge entries repeated (numpy's "symmetric")."""
    i = np.arange(-lo, n + hi)
    i = np.where(i < 0, -i - 1, i)
    return np.where(i >= n, 2 * n - i - 1, i)


class Corr1d:
    """out[i] = sum_t k[t] x[i + t - c] along ``axis``, symmetric padding;
    its adjoint and its declared bound sqrt(m) ||k||_1."""

    def __init__(self, taps, center: int, n: int, axis: int, device):
        self.k = [float(t) for t in np.asarray(taps, np.float64)]
        self.c, self.n, self.axis = int(center), int(n), int(axis)
        idx = sym_index(n, self.c, len(self.k) - 1 - self.c)
        self.idx = torch.as_tensor(idx, device=device)
        m = np.bincount(idx, minlength=n).max()
        self.bound = math.sqrt(m) * float(np.abs(self.k).sum())

    def apply(self, x):
        xp = x.index_select(self.axis, self.idx)
        out = None
        for t, kt in enumerate(self.k):
            term = kt * xp.narrow(self.axis, t, self.n)
            out = term if out is None else out + term
        return out

    def adjoint(self, y):
        shape = list(y.shape)
        shape[self.axis] = self.idx.numel()
        yp = torch.zeros(shape, dtype=y.dtype, device=y.device)
        for t, kt in enumerate(self.k):
            yp.narrow(self.axis, t, self.n).add_(kt * y)
        out = torch.zeros_like(y)
        return out.index_add_(self.axis, self.idx, yp)


class TVProblem:
    """The operators K, D and the steps of one frame size."""

    def __init__(self, cfg: dict, device):
        H, W = cfg["frame"]
        taps = gauss_taps(cfg["blur_sigma"], cfg["blur_taps"])
        c = (len(taps) - 1) // 2
        self.K = [Corr1d(taps, c, H, 0, device), Corr1d(taps, c, W, 1,
                                                          device)]
        self.D = [Corr1d([-1.0, 1.0], 0, H, 0, device),
                  Corr1d([-1.0, 1.0], 0, W, 1, device)]
        # declared bounds: a 2-D separable stencil pads both axes, so its
        # bound is the product of the axes'; a partial pads one axis
        LK = self.K[0].bound * self.K[1].bound
        LD = math.sqrt(sum(d.bound ** 2 for d in self.D))
        beta = LK ** 2
        self.tau = self.sigma = (-beta / 2 + math.sqrt(beta ** 2 / 4
                                                       + LD ** 2)) / LD ** 2
        self.lam = float(cfg["lam"])

    def Kf(self, x):
        return self.K[1].apply(self.K[0].apply(x))

    def Kt(self, y):
        return self.K[0].adjoint(self.K[1].adjoint(y))

    def Df(self, x):
        return torch.stack([d.apply(x) for d in self.D])

    def Dt(self, z):
        return self.D[0].adjoint(z[0]) + self.D[1].adjoint(z[1])

    def step(self, x, z, y, nonneg: bool):
        """One Condat-Vu iteration."""
        tau, sigma = self.tau, self.sigma
        xp = x - tau * self.Kt(self.Kf(x) - y) - tau * self.Dt(z)
        if nonneg:
            xp = torch.clamp(xp, min=0.0)
        v = z + sigma * self.Df(2 * xp - x)
        nrm = torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))
        zp = v * torch.clamp(self.lam / torch.clamp(nrm, min=1e-300),
                             max=1.0)
        return xp, zp


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The frame pool from ``seed``: each frame y = K x_true with x_true
    uniform on [0, 1) (the repo's TV recipe), made on the device by a
    seeded generator, then held on the host in pageable memory."""
    H, W = cfg["frame"]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    P = TVProblem(cfg, device)
    frames = []
    for _ in range(int(traffic["pool"])):
        xt = torch.rand((H, W), generator=gen, device=device,
                        dtype=torch.float32)
        frames.append(P.Kf(xt).cpu())
        del xt
    return dict(shared=None, frames=frames)


class Reference:
    """The plain solve of one frame in float64, and the comparison."""

    def __init__(self, cfg: dict, traffic: dict, shared, device):
        self.P = TVProblem(cfg, device)
        self.iters = int(traffic["iterations"])
        self.nonneg = traffic.get("constraint") == "nonneg"
        self.device = device

    def solve(self, frame):
        y = frame.to(device=self.device, dtype=torch.float64)
        x = y.clone()
        z = torch.zeros((2,) + tuple(y.shape), dtype=torch.float64,
                        device=self.device)
        for _ in range(self.iters):
            x, z = self.P.step(x, z, y, self.nonneg)
        return x

    def compare(self, frame, x_prog) -> dict:
        """``rel_err``: max |x - x_ref| over max |x_ref|."""
        xr = self.solve(frame)
        d = x_prog.to(device=xr.device, dtype=torch.float64) - xr
        return dict(rel_err=float(d.abs().max() / xr.abs().max()))
