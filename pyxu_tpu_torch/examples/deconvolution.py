"""TV-regularized deconvolution, end to end (the JAX package's
``examples/deconvolution.py`` over the port).

On the card, ``CondatVu`` runs each iteration as one launch of the fused
TV kernel (``solver.fused_path == "kernel"``).

Run: python -m pyxu_tpu_torch.examples.deconvolution
"""

import numpy as np
import torch

from pyxu_tpu_torch.operator import Gradient, L21Norm, SquaredL2Norm, Stencil
from pyxu_tpu_torch.opt.solver import CondatVu
from pyxu_tpu_torch.opt.stop import MaxIter, RelError
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.misc import peaks


def main(n=256, lam=0.005, sigma_blur=2.0, device=None):
    dev = resolve_device(device)
    # ground truth + blurred observation
    g = np.linspace(-2.5, 2.5, n)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    x_true = peaks(torch.from_numpy(xx), torch.from_numpy(yy)).to(
        dev, torch.float32)
    k = np.exp(-0.5 * ((np.arange(9) - 4) / sigma_blur) ** 2)
    k1 = (k / k.sum()).astype(np.float32)
    K = Stencil((n, n), [k1, k1], [4, 4], mode="symmetric")
    noise = np.random.default_rng(0).standard_normal((n, n))
    y = K.apply(x_true) + 0.01 * torch.from_numpy(
        noise.astype(np.float32)).to(dev)

    # min 0.5||Kx - y||^2 + lam ||grad x||_{2,1}
    f = 0.5 * SquaredL2Norm((n, n)).asloss(y) * K
    D = Gradient((n, n), mode="symmetric")
    h = lam * L21Norm((2, n, n), l2_axis=0)

    solver = CondatVu(f=f, h=h, K=D)
    solver.fit(x0=y, stop_crit=RelError(eps=1e-5, var="x", rank=2)
               | MaxIter(500), max_iter=500)
    x_hat = solver.solution()

    err_blur = float(torch.linalg.norm(y - x_true) / torch.linalg.norm(x_true))
    err_rec = float(torch.linalg.norm(x_hat - x_true)
                    / torch.linalg.norm(x_true))
    print(f"relative error: blurred {err_blur:.4f} -> reconstructed "
          f"{err_rec:.4f}")
    return x_hat


if __name__ == "__main__":
    main()
