"""Radio-interferometric imaging: NUFFT forward model + sparsity (the JAX
package's ``examples/radio_interferometry.py`` over the port; workload
4).  The set-up runs the 2-D NUFFT spread and interp kernels on the card.

Run: python -m pyxu_tpu_torch.examples.radio_interferometry
"""

import numpy as np

from pyxu_tpu_torch.models import radio_interferometry
from pyxu_tpu_torch.opt.stop import MaxIter, RelError


def main(n=128, n_vis=3000, device=None):
    solver, fit_kw, aux = radio_interferometry(shape=(n, n), n_vis=n_vis,
                                               lam=0.02, device=device)
    # real_sky=True (default): iterates are real (n, n) images (rank 2);
    # real_sky=False keeps the complex (n, n, 2) formulation (rank 3).
    rank = fit_kw["x0"].ndim
    solver.fit(stop_crit=RelError(eps=1e-6, var="x", rank=rank)
               | MaxIter(200), max_iter=200, **fit_kw)
    x = solver.solution().cpu().numpy()
    if x.ndim == 3:        # complex formulation: take the real channel
        x = x[..., 0]
    err = np.linalg.norm(x - aux["x_true"]) / np.linalg.norm(aux["x_true"])
    print(f"RI imaging from {n_vis} visibilities: rel err {err:.4f}")
    return x


if __name__ == "__main__":
    main()
