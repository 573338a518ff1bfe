"""Sparse-view CT with positivity + TV (the JAX package's
``examples/tomography.py`` over the port; workload 3).

``method="interp"`` (the default, as in the JAX program) projects with
``RadonTransform``; ``method="fourier"`` with ``FourierRadon``, whose set-up
runs the 2-D NUFFT spread and interp kernels on the polar grid.  The TV
term's gradient runs on the stencil kernel on the card.

Run: python -m pyxu_tpu_torch.examples.tomography
"""

import numpy as np

from pyxu_tpu_torch.models import sparse_view_ct
from pyxu_tpu_torch.opt.stop import MaxIter, RelError


def main(n=96, n_angles=24, method="interp", device=None):
    solver, fit_kw, aux = sparse_view_ct(shape=(n, n), n_angles=n_angles,
                                         lam=0.005, method=method,
                                         device=device)
    solver.fit(stop_crit=RelError(eps=1e-6, var="x", rank=2) | MaxIter(300),
               max_iter=300, **fit_kw)
    x = solver.solution().cpu().numpy()
    x_true = aux["x_true"].cpu().numpy()
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    print(f"{n_angles}-view CT reconstruction: rel err {err:.4f}, "
          f"min {x.min():.2e} (positivity)")
    return x


if __name__ == "__main__":
    main()
