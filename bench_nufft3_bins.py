#!/usr/bin/env python3
"""Time the 3-D NUFFT kernels of ``pyxu_tpu_torch`` over bin shapes, and the
spread over its dense-bin split threshold, on one NVIDIA GPU.

    python3 bench_nufft3_bins.py

At the MRI path's size (2^21 points, w = 7, float32, a 256^3 fine grid) on
``chip_smoke.py``'s three point sets (uniform, a kooshball of 8192 radial
spokes, a clustered Gaussian), and for the spread of ones of its Toeplitz
build on 512^3, it prints the device time of ``nufft_spread3`` and
``nufft_interp3`` (``chip_smoke._time_ms``) for the bin shapes 16x16x2
(cuFINUFFT's 3-D default), 8x8x8, 16x16x8, 16x16x16 and 16x16x32, and
which one ``ops.nufft.bin3`` picks.  The bin is the interp's subgrid and
the spread's task, so both move with it.  Then the spread at ``bin3``'s
bins for ``ops.nufft.SPLIT`` (the candidate points a task takes before
its bin is cut into slabs) of 4096, 16384 and 65536.  Each spread is
checked against its plain version as ``chip_smoke.py`` checks it.
"""

import os
import sys

import numpy as np
import torch

BINS = ((16, 16, 2), (8, 8, 8), (16, 16, 8), (16, 16, 16), (16, 16, 32))
SPLITS = (4096, 16384, 65536)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_nufft3_bins: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from pyxu_tpu_torch.operator.linop.nufft import _es_params
    from pyxu_tpu_torch.ops import nufft as nu
    smi = cs._smi()
    print(f"[device] {smi}", flush=True)
    nu.build()
    w, beta = _es_params(1e-6)
    bins3 = nu.bin3(w, torch.float32)
    print(f"[bins] w = {w}, float32: bin3 picks {bins3}", flush=True)
    rng = np.random.default_rng(1)
    M = cs.MRI_SPOKES * cs.MRI_READ
    cases = [(k, cs.NU3_GRID) for k in ("uniform", "koosh", "cluster")]
    cases.append(("koosh-ones", cs.TOEP3_GRID))
    split0 = nu.SPLIT
    for kind, grid in cases:
        x = torch.remainder(torch.from_numpy(
            cs._nu3_points(kind.split("-")[0], M, rng)).cuda(), 2 * np.pi)
        if kind.endswith("ones"):
            c = torch.zeros((1, M, 2), device="cuda")
            c[..., 0] = 1.0
        else:
            c = torch.randn((1, M, 2), device="cuda")
        g = torch.randn((1,) + grid + (2,), device="cuda")
        runs = [(b, split0) for b in BINS] + [
            (bins3, s) for s in SPLITS if s != split0]
        for bins, split in runs:
            nu.SPLIT = split
            p = nu._plan(x, grid, w, beta, torch.float32, bins)
            cs._nu_check(f"{kind} {bins} SPLIT={split}", nu.nufft_spread3,
                         nu.nufft_spread3_plain, c, p, torch.float32)
            spread = cs._time_ms(lambda: nu.nufft_spread3(c, p), reps=5)
            interp = cs._time_ms(lambda: nu.nufft_interp3(g, p), reps=5)
            print(f"[bins] {kind} {grid[0]}^3 bins {bins} SPLIT={split}: "
                  f"{cs._blocks(p, 'spread')}, {p.sub.shape[0]} "
                  f"subproblems; spread {spread:.4f} ms, interp "
                  f"{interp:.4f} ms", flush=True)
            del p
        nu.SPLIT = split0
        del x, c, g
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
