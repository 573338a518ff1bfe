#!/usr/bin/env python3
"""Time the NUFFT interp kernel of ``pyxu_tpu_torch`` over its design
switches, on one NVIDIA GPU.

    python3 bench_nufft_interp.py

Builds ``csrc/nufft.cu`` once for each variant of ``SWEEP`` (one ``nvcc``
each, all started together, the interp instantiated at w = 7 only by
``NU_INTERP_W7_ONLY``): the source's own choices, and each with one
switch flipped: the tap body of a dimension (``NU_INTERP_GROUP_2D`` /
``_3D``: a group of 16 lanes a point, or a thread a point), the
subgrid's rows copied by the tensor memory accelerator or by a
``cp.async`` a cell (``NU_INTERP_NO_BULK``), the threads of a block
(``NU_INTERP_THREADS_2D`` / ``_3D``) and the blocks an SM their
registers leave room for (``NU_INTERP_MINB_2D`` / ``_3D``).  On
``chip_smoke.py``'s point sets at the RI and MRI paths' sizes (10^6
points on a 2048^2 grid; 2^21 points on 256^3), and 2^18 uniform points
on a 128^3 grid that fits the 50 MB L2 cache, w = 7, float32, each
variant is held against the plain version as ``chip_smoke.py`` holds the
kernel, then timed
(``chip_smoke._time_ms``); a timing-only build that copies the subgrids
and stops (``NU_TIME_INTERP_LOAD_ONLY``) gives the load alone, in ms and
in TB/s of subgrid bytes.  One ``[sweep]`` line a case and variant.
"""

import concurrent.futures
import os
import sys

import numpy as np
import torch

W7 = ("NU_INTERP_W7_ONLY",)
SWEEP = (
    ("source", ()),
    ("3-D threads", ("NU_INTERP_GROUP_3D=0",)),
    ("2-D groups", ("NU_INTERP_GROUP_2D=1",)),
    ("no bulk copies", ("NU_INTERP_NO_BULK",)),
    ("3-D 256 threads", ("NU_INTERP_THREADS_3D=256",)),
    ("3-D 384 threads", ("NU_INTERP_THREADS_3D=384",)),
    ("3-D 1 block an SM", ("NU_INTERP_MINB_3D=1",)),
    ("2-D 64 threads", ("NU_INTERP_THREADS_2D=64",)),
    ("2-D 256 threads", ("NU_INTERP_THREADS_2D=256",)),
    ("2-D 1 block an SM", ("NU_INTERP_MINB_2D=1",)),
)
LOAD_ONLY = ("NU_TIME_INTERP_LOAD_ONLY",)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_nufft_interp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from pyxu_tpu_torch.operator.linop.nufft import _es_params
    from pyxu_tpu_torch.ops import _build
    from pyxu_tpu_torch.ops import nufft as nu
    smi = cs._smi()
    print(f"[device] {smi}", flush=True)
    builds = [W7 + v for _, v in SWEEP] + [LOAD_ONLY]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: _build.compile_source("nufft.cu", d),
                      builds))
    w, beta = _es_params(1e-6)
    assert w == 7, w
    rng = np.random.default_rng(0)
    M3 = cs.MRI_SPOKES * cs.MRI_READ
    cases = [(3, k, cs.NU3_GRID, cs._nu3_points(k, M3, rng))
             for k in ("uniform", "koosh", "cluster")]
    cases.append((3, "uniform", (128, 128, 128),
                  cs._nu3_points("uniform", 1 << 18, rng)))
    cases += [(2, k, cs.NU_GRID, cs._nu_points(k, cs.NU_M, rng))
              for k in ("uniform", "gauss", "cluster")]
    for d, kind, grid, pts in cases:
        x = torch.remainder(torch.from_numpy(pts).cuda(), 2 * np.pi)
        g = torch.randn((1,) + grid + (2,), device="cuda")
        p = (nu.plan3 if d == 3 else nu.plan2)(x, grid, w, beta,
                                               torch.float32)
        name = f"nufft_interp{d}"
        plain = getattr(nu, name + "_plain")
        where = f"{name}[{kind}, {'x'.join(map(str, grid))}]"

        def kernel(lib):
            def kern(a, q):
                out = torch.empty((a.shape[0], q.M, 2), dtype=a.dtype,
                                  device=a.device)
                nu._launch(f"{name}_launch", a, out, q, lib)
                return out
            return kern
        for label, defines in SWEEP:
            kern = kernel(nu._library(W7 + defines)[0])
            cs._nu_check(f"{where} {label}", kern, plain, g, p,
                         torch.float32, twice=True)
            ms = cs._time_ms(lambda: kern(g, p), reps=5)
            print(f"[sweep] {where} {label}: ms={ms:.4f}", flush=True)
        kern = kernel(nu._library(LOAD_ONLY)[0])
        ms = cs._time_ms(lambda: kern(g, p), reps=5)
        sub = nu.interp_subgrid(p.bins, w, torch.float32)["smem"]
        rate = p.sub.shape[0] * sub / ms / 1e9
        print(f"[sweep] {where} load only: ms={ms:.4f} ({p.sub.shape[0]} "
              f"subgrids of {sub} B: {rate:.3f} TB/s)", flush=True)
        del x, g, p
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
