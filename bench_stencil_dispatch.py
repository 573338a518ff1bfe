#!/usr/bin/env python3
"""Host time a call of the port's linear kernel wrappers, on one NVIDIA GPU.

    python3 bench_stencil_dispatch.py [--root DIR] [--build-only]

Imports ``pyxu_tpu_torch`` from ``DIR`` (by default this script's own
directory), so that two trees of the package, say a commit and its parent,
can be timed in turn on the same card.  ``--build-only`` compiles
``csrc/stencil.cu`` and ``csrc/nufft.cu`` of that tree and exits.

Each case is a call a host-bound solver makes every iteration: the
stencil wrapper ``separable_correlate2d`` on a 256x256 float32 image (the
LASSO bench leg's shape) and on 2160x3840, with the workload's 9+9-tap
symmetric blur, apply and adjoint; the same through the wrapper's autograd
rule ``_Correlate.apply`` under ``torch.no_grad`` where the tree has one;
and ``nufft_interp2`` / ``nufft_spread2`` on a plan of 20 000 uniform
points on a 512x512 fine grid (the RI bench leg's), w = 7.  A run is
``CALLS`` calls enqueued behind a ``torch.cuda._sleep`` long enough that the
device never holds the host back; the host clock around the calls, divided
by ``CALLS``, is the run's host time a call.  Prints one JSON line: the
median and the spread over ``RUNS`` runs of each case, in microseconds,
with the card's name and power limit.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

CALLS, RUNS = 200, 50
SLEEP_CYCLES = 60_000_000       # ~30 ms: longer than CALLS calls' host time


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _host_us(torch, fn):
    """Median and range of the host microseconds a call of ``fn``."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(RUNS):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        per.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return {"median": statistics.median(per), "min": min(per),
            "max": max(per)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_stencil_dispatch: no CUDA device", file=sys.stderr)
        return 2
    from pyxu_tpu_torch.ops import nufft as nu
    from pyxu_tpu_torch.ops import stencil as st
    assert os.path.dirname(st.__file__).startswith(os.path.abspath(
        args.root)), st.__file__
    st.build()
    nu.build()
    if args.build_only:
        return 0
    k = np.exp(-0.5 * ((np.arange(9) - 4) / 2.0) ** 2)
    k = tuple(float(v) for v in k / k.sum())
    p = st.SepTaps(k, 4, k, 4, "symmetric")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    with torch.no_grad():
        for shape in ((256, 256), (2160, 3840)):
            x = torch.rand(shape, generator=gen, device="cuda")
            tag = f"{shape[0]}x{shape[1]}"
            for adj in (False, True):
                name = f"stencil {tag}{' adjoint' if adj else ''}"
                cases[name] = _host_us(
                    torch, lambda x=x, adj=adj: st.separable_correlate2d(
                        x, p, adj))
            if hasattr(st, "_Correlate"):
                cases[f"stencil {tag} through _Correlate.apply"] = _host_us(
                    torch, lambda x=x: st._Correlate.apply(x, p, False))
        rng = np.random.default_rng(0)
        pts = torch.from_numpy(rng.uniform(0, 2 * math.pi, (20_000, 2))).to(
            "cuda")
        plan = nu.plan2(pts, (512, 512), 7, 2.3 * 7, torch.float32)
        c = torch.randn((1, 20_000, 2), generator=gen, device="cuda")
        g = torch.randn((1, 512, 512, 2), generator=gen, device="cuda")
        cases["nufft_spread2 512^2 / 20000"] = _host_us(
            torch, lambda: nu.nufft_spread2(c, plan))
        cases["nufft_interp2 512^2 / 20000"] = _host_us(
            torch, lambda: nu.nufft_interp2(g, plan))
    print(json.dumps({"root": os.path.abspath(args.root), "card": _smi(),
                      "torch": torch.__version__, "calls": CALLS,
                      "runs": RUNS, "host_us_a_call": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
