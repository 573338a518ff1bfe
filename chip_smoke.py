#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyxu_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:

1. device line (name and power limit from ``nvidia-smi``, torch and CUDA
   versions) and the build of the CUDA kernels from ``pyxu_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together before torch is
   imported); the NUFFT spread kernels' registers and spills (and the
   interps' at w = 7), and the count of atomic instructions in the SASS of
   both (``cuobjdump``), which must be 0;
2. kernels at 2160x3840: the fused-TV kernels with the workload's taps and
   step sizes (f32 state, and bf16 dual storage; ``tv_step`` and
   ``tv_stepk`` at the TV path's depth, or at ``KSTEP_CHECK`` when the path
   takes single steps), the same in constant mode with asymmetric taps at
   2153x3833, which no tile divides, and the separable stencil kernel with
   the workload's blur (apply and adjoint, constant and symmetric mode, in
   f32 and f64; then off-centre 4x3 taps at 2153x3833), each against its
   plain PyTorch version on the card, timed with CUDA events; the
   stencil's launch geometry at 4K and 256x256, a plain copy of the frame
   and one ``conv2d`` call beside it; the K sweep: device ms an iteration
   of the fused step at K = 1-4, each held against its plain version, and
   the stencil's geometry sweep (``ST_SWEEP``, each variant built with its
   own ``-D`` overrides and held against the plain version), one
   ``[sweep]`` line each;
3. the TV path: ``tv_deconvolution((2160, 3840))`` solved by
   ``CondatVu.fit(stop_crit=MaxIter(300))`` with ``stop_rate=100``, which
   must run through the fused-TV kernels of its depth
   (``fused_tv.N_STEPS``; launch counts checked), then 30
   iterations of the fused and of the generic operator path, which must
   agree within 2e-4; the generic path runs its Stencils through the
   stencil kernel (launches checked);
4. the LASSO path: ``lasso_deconvolution((2160, 3840))`` solved by
   ``PGD.fit(stop_crit=MaxIter(300))`` with ``stop_rate=100`` through the
   stencil kernel (two launches per iteration, checked), then the 256x256
   leg of the JAX bench (2000 iterations in one segment), each with the
   device time of one iteration and the stencil's part of it, and 100
   iterations at 256x256 on the card against the same solve on the CPU;
5. the 2-D NUFFT kernels at full size (a 2048x2048 fine grid, 10^6 points,
   w = 7) on three point sets (uniform, the RI workload's Gaussian uv, a
   clustered set), the spread of ones that builds the RI path's
   Toeplitz kernel (the Gaussian uv on its 4096x4096 grid), and the CT
   path's polar set (60 views x 1024 detector bins: the Toeplitz build's
   spread of its Nyquist-halved weights on 2048x2048, the Hankel build's
   spread of ones at the 60 Nyquist points on its widened grid, A^T y's
   spread and y's interp on 1024x1024; the ``variants`` of the kernels
   line), each against
   its plain version in float32 and float64, timed in float32; each
   spread and interp launched twice must give the same bits; a spread's
   time is split by two timing-only builds (``NU_PHASES``: the walk over
   the candidates, the staging, the adds), an interp's by three
   (``NU_INTERP_PHASES``: the subgrid load, the taps, the point data read
   and results stored), ``[split]`` lines; the ``kernels`` line gives each
   kernel's times as the RI path's launch-weighted mix of these cases;
6. the NUFFT's type 1 and type 2 at N = 256x256, M = 4000 against a direct
   NUDFT in float64 on the card;
7. the RI path: ``radio_interferometry((1024, 1024), n_vis=10**6)`` (set-up
   timed: the plan, the Toeplitz builds, y; then broken down into its
   parts, ``[setup]`` lines, with cuFFT's plan cache emptied and again
   with it full), a warm fit, then
   ``ADMM.fit(stop_crit=MaxIter(150))`` in one segment, with the NUFFT
   kernels' launch counts of the whole path checked and an event-timed
   iteration breakdown; then the JAX bench's 256x256 / 20000-visibility
   leg, 150 iterations on the card against the same solve on the CPU;
8. the 3-D NUFFT kernels at full size (a 256^3 fine grid, 2^21 points,
   w = 7) on three point sets (uniform, the MRI path's kooshball of 8192
   radial spokes through the origin, a clustered set), and the spread of
   ones that builds the MRI path's Toeplitz kernel (the kooshball on its
   512^3 grid), each against its plain version in float32 and float64,
   timed in float32, the spreads checked and split as in 5; the
   ``kernels`` line gives each kernel's times as the MRI path's
   launch-weighted mix of these cases;
9. the 3-D NUFFT's type 1 and type 2 at N = 32^3, M = 4000 against a
   direct NUDFT in float64 on the card;
10. the MRI path: a 128^3 single-coil non-Cartesian reconstruction from a
   kooshball (8192 spokes x 256 samples), ``A = NUFFT.type2(k, N)``,
   ``CG(A.gram() + lam * IdentityOp).fit(b=A^H y)`` (set-up timed: the
   plan, the Toeplitz build, y, A^H y; then broken down as in 7), a warm
   fit, then 100 iterations in
   one segment, with the 3-D NUFFT kernels' launch counts of the whole
   path checked and an event-timed iteration breakdown; then the same
   problem at 32^3 (512 spokes x 64 samples), 50 iterations on the card
   against the same solve on the CPU;
11. the CT path: ``sparse_view_ct((512, 512), n_angles=60,
   method="fourier")`` (set-up timed, then broken down as in 7), a warm
   fit, then ``PD3O.fit(stop_crit=MaxIter(400))`` in one segment, with the
   launches of the set-up (4 spreads: the FourierRadon gram's weighted
   Toeplitz and Nyquist Hankel builds, twice; 1 interp: y), the warm fit
   (one more spread: A^T y) and the timed fit (no NUFFT, 4 stencils an
   iteration) checked and an event-timed iteration breakdown (gram,
   stencils, the rest, idle) and the stencil kernel held against its
   plain version with the gradient's taps at the path's shape; then the
   JAX bench's 256x256 / 60-view leg, checked in the same way;
   FourierRadon at 64x64 / 16 views (100 iterations) and RadonTransform
   at 128x128 / 30 views (50) on the card against the CPU, and
   FourierRadon and its gram at 9x13, whose fine grid has an odd side,
   with their launches counted.
   Phase 5 holds the 2-D kernels on this path's polar set too.

Each phase prints its host time (``[time]``).  It prints one
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and no result line is printed.  Without a CUDA
device it exits with code 2.
"""

import time

T_START = time.perf_counter()

import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

SOURCES = ("fused_tv.cu", "stencil.cu", "nufft.cu")
# the stencil kernel's geometry sweep: -D overrides of csrc/stencil.cu
# (band ST_BW = 32 ST_CPT columns, strip rows ST_SR, halved to reach
# ST_FILL warps, ring depth ST_NBUF, warps a block ST_WARPS); () is the
# source's own choice
ST_SWEEP = ((), ("ST_NBUF=8",), ("ST_NBUF=2",), ("ST_SR=16", "ST_FILL=1"),
            ("ST_SR=64", "ST_FILL=1"), ("ST_CPT=2",), ("ST_CPT=8",),
            ("ST_WARPS=4",))
# timing-only builds of csrc/nufft.cu's spread (wrong sums): without the
# adds into the cells, and without the staging too (the walk over the
# candidates and the output's stores)
NU_PHASES = (("NU_TIME_NO_ACC",), ("NU_TIME_NO_STAGE",))
# timing-only builds of csrc/nufft.cu's interp (wrong values): the subgrid
# loaded and zeros written, the taps run on whatever shared memory holds,
# and neither (the point data read and the results' stores)
NU_INTERP_PHASES = (("NU_TIME_INTERP_NO_TAPS",), ("NU_TIME_INTERP_NO_LOAD",),
                    ("NU_TIME_INTERP_NO_TAPS", "NU_TIME_INTERP_NO_LOAD"))


def _start_builds():
    """Start compiling the kernels' sources, one ``nvcc`` each (and one for
    each stencil variant of ``ST_SWEEP``), all at once, before torch is
    imported: ``pyxu_tpu_torch/ops/_build.py`` is loaded by its path, so
    that the package, and torch with it, is not imported first.  Returns a
    future of ``(library, compiler output, seconds)`` per ``(source,
    defines)``; the
    wrappers' ``build()`` then loads the libraries."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pyxu_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jobs = [(src, ()) for src in SOURCES] + [
        ("stencil.cu", d) for d in ST_SWEEP if d] + [
        ("nufft.cu", d) for d in NU_PHASES + NU_INTERP_PHASES]

    def timed(job):
        t0 = time.perf_counter()
        so, log = mod.compile_source(*job)
        return so, log, time.perf_counter() - t0
    pool = concurrent.futures.ThreadPoolExecutor(len(jobs))
    return {job: pool.submit(timed, job) for job in jobs}


if __name__ == "__main__":
    BUILDS = _start_builds()

import torch  # noqa: E402

SHAPE = (2160, 3840)
ODD_SHAPE = (2153, 3833)        # no fused-TV tile divides it
KSTEP_CHECK = 2                 # tv_stepk's depth when the path takes none
PATH_ITERS, STOP_RATE = 300, 100
PARITY_ITERS, PARITY_RATE = 30, 10
BENCH_SHAPE, BENCH_ITERS = (256, 256), 2000     # bench.py's LASSO leg
CHECK_ITERS = 100                               # LASSO card vs CPU
RI_SHAPE, RI_VIS = (1024, 1024), 1_000_000       # one snapshot channel
RI_BENCH_SHAPE, RI_BENCH_VIS = (256, 256), 20_000   # bench.py's RI leg
RI_ITERS = 150                                      # the bench's depth
NU_GRID, NU_M, NU_W = (2048, 2048), 1_000_000, 7    # A's fine grid at 1024^2
TOEP_GRID = (4096, 4096)        # the Toeplitz builds' fine grid at 1024^2
MRI_N, MRI_SPOKES, MRI_READ = (128, 128, 128), 8192, 256   # 3-D kooshball
MRI_ITERS = 100
MRI_SMALL = ((32, 32, 32), 512, 64, 50)     # shape, spokes, samples, iters
MRI_LAM = 1e-3          # Tikhonov weight over the gram's largest eigenvalue
NU3_GRID = (256, 256, 256)      # A's fine grid at 128^3
TOEP3_GRID = (512, 512, 512)    # the Toeplitz build's fine grid at 128^3
CT_SHAPE, CT_ANGLES = (512, 512), 60     # the clinical CT matrix, 60 views
CT_BENCH_SHAPE = (256, 256)              # bench.py's CT leg (60 angles)
CT_ITERS = 400                           # the bench's depth, one segment
CT_GRID = (1024, 1024)          # A's fine grid at 512^2 (n_det 1024)
CT_TOEP_GRID = (2048, 2048)     # the weighted Toeplitz build's fine grid
CT_CHECKS = (((64, 64), 16, "fourier", 100),     # card vs CPU: shape,
             ((128, 128), 30, "interp", 50))     # angles, method, iters
CT_ODD = ((9, 13), 4, 12)       # shape, angles, n_det: a fine-grid side 27
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
SLEEP_CYCLES = 40_000_000      # ~20 ms at 1.98 GHz: longer than the host
                               # takes to enqueue one timed run


def _kernel_resources(log, names):
    """The ``ptxas -v`` registers and spills of each kernel whose mangled
    name contains one of ``names``, one line each."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and any(n in fn for n in names) and (
                "spill" in line or "registers" in line):
            out.append(f"{fn}: {line.strip()}")
    return out


def _sass_atomics(so, names):
    """Count of atomic and reduction instructions (ATOM, ATOMS, ATOMG, RED)
    in the SASS of each kernel of the library ``so`` whose mangled name
    contains one of ``names``; empty where ``cuobjdump`` is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if any(n in fn for n in names):
                out[fn] = 0
        elif fn in out and re.search(r"\b(ATOMS|ATOMG|ATOM|RED)\b", line):
            out[fn] += 1
    return out


def _mark(phase):
    """Print the host time since the script started, after ``phase``."""
    print(f"[time] {phase} done at {time.perf_counter() - T_START:.2f} s",
          flush=True)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps=20, runs=5, warmup=3):
    """Device time of one ``fn()`` (ms): the median over ``runs`` of CUDA
    events around ``reps`` back-to-back calls, divided by ``reps`` (the
    plain versions, 1-11 ms a call, take 5).  A
    ``torch.cuda._sleep`` ahead of each run keeps the device busy while the
    host enqueues the calls, so the host's launch overhead stays out of the
    events' span."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def _bf16_ulp(v):
    """One bf16 ulp of each value (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _bound(H, W, p, n_steps, z_bytes):
    """Least time (ms) for one launch: x, z, b read once and x, z written
    once, or the f32 operations of n_steps iterations, whichever is larger."""
    nbytes = H * W * (4 + 4 + 4 + 2 * z_bytes + 2 * z_bytes)
    ops = H * W * n_steps * (4 * (len(p.k0) + len(p.k1)) + 26)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def kernel_phase(ft, p, x, z, b, cases, timed=True, label=""):
    """Each fused-TV kernel of ``cases`` ((name, n_steps) pairs) against its
    plain version, with f32 and with bf16 z; returns per-kernel records."""
    H, W = x.shape
    xmax = float(x.abs().max())
    out = {}
    for name, n_steps in cases:
        for zdt in (torch.float32, torch.bfloat16):
            zs = z.to(zdt)
            if n_steps == 1:
                def kern():
                    return ft.tv_step(x, zs, b, p)

                def plain():
                    return ft.tv_step_plain(x, zs, b, p)
            else:
                def kern():
                    return ft.tv_stepk(x, zs, b, p, n_steps)

                def plain():
                    return ft.tv_stepk_plain(x, zs, b, p, n_steps)
            xk, zk = kern()
            xp, zp = plain()
            torch.cuda.synchronize()
            err_x = float((xk - xp).abs().max())
            dz = (zk.float() - zp.float()).abs()
            err_z = float(dz.max())
            tol = 1e-5 * xmax
            if zdt == torch.float32:
                ok = err_x <= tol and err_z <= tol
                tol_s = f"1e-5*max|x| = {tol:.3e}"
            else:
                # z: one bf16 ulp of the stored value.  x stays f32, but a
                # one-ulp flip of an intermediate z reaches the next level's
                # x through D^T z (4 neighbours, times tau)
                tol_x = tol + 4 * p.tau * (n_steps - 1) * float(
                    _bf16_ulp(zp.abs().max()))
                # z: one ulp of the stored value, plus for K levels what
                # the earlier levels' flips carry in (one ulp of max|z| each)
                tol_z = _bf16_ulp(zp) + tol + (n_steps - 1) * float(
                    _bf16_ulp(zp.abs().max()))
                ok = err_x <= tol_x and bool((dz <= tol_z).all())
                tol_s = (f"x: {tol_x:.3e}; z: 1 bf16 ulp of the stored "
                         f"value + {n_steps - 1} ulp of max|z|")
            tag = "f32" if zdt == torch.float32 else "bf16z"
            print(f"[kernel] {name}[{tag}{label}] K={n_steps} max_abs_err "
                  f"x={err_x:.3e} z={err_z:.3e} tol {tol_s}: "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"{name}[{tag}{label}] disagrees with its "
                                 "plain version")
            rec = dict(max_abs_err=max(err_x, err_z))
            if timed:
                ms, plain_ms = _time_ms(kern), _time_ms(plain, reps=5)
                bound_ms, bound_by = _bound(H, W, p, n_steps,
                                            4 if zdt == torch.float32 else 2)
                print(f"[kernel] {name}[{tag}] ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                      f"({bound_by})", flush=True)
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            out[(name, tag)] = rec
    return out


def k_sweep(ft, p, x, z, b):
    """Device ms an iteration of the fused TV step at each depth K (K = 1:
    ``tv_step``, else ``tv_stepk``) with f32 state, each launch first held
    against its plain version; returns {K: ms an iteration}."""
    tol = 1e-5 * float(x.abs().max())
    out = {}
    for K in (1, 2, 3, 4):
        if not ft.window_fits(tuple(x.shape), p, K):
            print(f"[sweep] K={K}: window does not fit", flush=True)
            continue
        if K == 1:
            def kern():
                return ft.tv_step(x, z, b, p)
        else:
            def kern(K=K):
                return ft.tv_stepk(x, z, b, p, K)
        xk, zk = kern()
        xp, zp = ft.tv_stepk_plain(x, z, b, p, K)
        err = max(float((xk - xp).abs().max()), float((zk - zp).abs().max()))
        if err > tol:
            raise SystemExit(f"sweep K={K}: max_abs_err {err:.3e} > {tol:.3e}")
        ms = _time_ms(kern)
        inner, total = ft.interior_blocks(tuple(x.shape), p, K)
        print(f"[sweep] K={K} tile={ft._tile(K)} ms_per_launch={ms:.4f} "
              f"ms_per_iteration={ms / K:.4f} interior_blocks={inner}/{total}"
              f" max_abs_err={err:.3e}", flush=True)
        out[K] = ms / K
    return out


ST_OFF_TAPS = ((0.1, 0.2, 0.3, 0.4), 3, (0.5, 0.3, 0.2), 0)   # 4x3, off-centre


def _st_bound(shape, p, elem):
    """Least time (ms) of one stencil launch: each pixel read and written
    once, or 2 (L0 + L1) f32 operations a pixel, whichever is larger."""
    H, W = shape[-2:]
    t_b = 2 * H * W * elem / HBM_BYTES_PER_S
    t_o = 2 * (len(p.k0) + len(p.k1)) * H * W / F32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _st_variants(st, p, x, label, lib=None, plain_timed=True, verbose=True):
    """Apply and adjoint, constant and symmetric mode, of taps ``p`` on
    ``x`` through the kernel (``lib``'s build, by default the source's
    own) against the plain version: max error within 1e-5 max|x| (f32) or
    1e-12 max|x| (f64) times sum|k0| sum|k1|; device times of the kernel
    and (``plain_timed``) of the plain version; ``verbose``: a line for
    each variant, else for a failure only."""
    eps = 1e-5 if x.dtype == torch.float32 else 1e-12
    tol = eps * float(x.abs().max()) * max(
        1.0, sum(map(abs, p.k0)) * sum(map(abs, p.k1)))
    bound_ms, bound_by = _st_bound(x.shape, p, x.element_size())
    out = {}
    for mode in ("constant", "symmetric"):
        q = st.SepTaps(p.k0, p.c0, p.k1, p.c1, mode)
        for adj in (False, True):
            tag = f"{mode}{'-adjoint' if adj else ''}"

            def kern(q=q, adj=adj):
                if lib is None:
                    return st.separable_correlate2d(x, q, adj)
                return st._launch(lib, x, q, adj)

            def plain(q=q, adj=adj):
                return st.separable_correlate2d_plain(x, q, adj)
            err = float((kern() - plain()).abs().max())
            torch.cuda.synchronize()
            ok = err <= tol
            if verbose or not ok:
                print(f"[kernel] stencil{label}[{tag}] max_abs_err="
                      f"{err:.3e} tol {tol:.3e}: {'ok' if ok else 'FAIL'}",
                      flush=True)
            if not ok:
                raise SystemExit(f"stencil{label}[{tag}] disagrees with its "
                                 "plain version")
            rec = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                       ms=_time_ms(kern))
            if plain_timed:
                rec["plain_ms"] = _time_ms(plain, reps=5)
            if verbose:
                print(f"[kernel] stencil{label}[{tag}] ms={rec['ms']:.4f} "
                      f"plain_ms={rec.get('plain_ms', float('nan')):.4f} "
                      f"bound_ms={bound_ms:.4f} ({bound_by}, "
                      f"{bound_ms / rec['ms']:.1%} of it)", flush=True)
            out[tag] = rec
    return out


def stencil_phase(st, p, x):
    """The stencil kernel against its plain version, apply and adjoint in
    both modes: at the workload's shape and taps in f32 (timed) and f64,
    and at 2153x3833 with off-centre 4x3 taps; its launch geometry; the
    ``ST_SWEEP`` variants (``[sweep]`` lines, the LASSO path's symmetric
    apply and adjoint); then one ``conv2d`` of the same constant-mode
    apply (cuDNN, TF32 off).  Returns the f32 records, the f64 records,
    the sweep and the ``conv2d`` time."""
    out = _st_variants(st, p, x, "")
    out64 = _st_variants(st, p, x.double(), " f64")
    k0, c0, k1, c1 = ST_OFF_TAPS
    gen = torch.Generator(device="cuda").manual_seed(1)
    xo = torch.rand(ODD_SHAPE, generator=gen, device="cuda")
    _st_variants(st, st.SepTaps(k0, c0, k1, c1), xo,
                 f" 4x3off {ODD_SHAPE[0]}x{ODD_SHAPE[1]}", plain_timed=False)
    xc = torch.empty_like(x)
    copy_ms = _time_ms(lambda: xc.copy_(x))
    print(f"[kernel] copy of the 4K frame (x.copy_, the bytes the stencil "
          f"must move): {copy_ms:.4f} ms", flush=True)
    for shape in (SHAPE, BENCH_SHAPE):
        for adj in (False, True):
            plan = st.launch_plan(shape, p, adj)
            print(f"[kernel] stencil plan {shape[0]}x{shape[1]}"
                  f"{' adjoint' if adj else ''}: " + " ".join(
                      f"{k}={plan[k]}" for k in (
                          "band", "bands", "sr", "strips", "warps",
                          "stream_blocks", "edge_blocks", "smem_bytes")),
                  flush=True)
    sweep = {}
    for defines in ST_SWEEP:
        lib = st._library(defines)[0]
        q = st.SepTaps(p.k0, p.c0, p.k1, p.c1, "symmetric")
        plan = st.kernel_plan(lib, SHAPE, q, False)
        tag = " ".join(defines) or "source"
        rec = _st_variants(st, p, x, f" sweep {tag}", lib=lib,
                           plain_timed=False, verbose=False)
        ms = {k: v["ms"] for k, v in rec.items()}
        mix = statistics.fmean((ms["symmetric"], ms["symmetric-adjoint"]))
        sweep[tag] = dict(ms, mix=mix, sr=plan["sr"], warps=plan["warps"],
                          blocks=plan["stream_blocks"])
        print(f"[sweep] stencil {tag}: sr={plan['sr']} warps={plan['warps']}"
              f" stream_blocks={plan['stream_blocks']} ms " + " ".join(
                  f"{k}={v:.4f}" for k, v in ms.items())
              + f" path_mix={mix:.4f}", flush=True)
    assert not torch.backends.cudnn.allow_tf32
    w = torch.outer(torch.tensor(p.k0), torch.tensor(p.k1)).to(x)[None, None]
    x4 = x[None, None]

    def lib_call():
        return torch.nn.functional.conv2d(x4, w, padding=(p.c0, p.c1))
    err = float((lib_call()[0, 0] - st.separable_correlate2d(
        x, st.SepTaps(p.k0, p.c0, p.k1, p.c1, "constant"))).abs().max())
    library_ms = _time_ms(lib_call)
    print(f"[kernel] stencil conv2d library_ms={library_ms:.4f} "
          f"(max_abs_diff to the kernel {err:.3e})", flush=True)
    return out, out64, sweep, library_ms


def _breakdown(st, slv, p, wall_ms, tag):
    """Device time of one solver iteration (``_time_ms`` around back-to-back
    ``m_step`` calls, 10 of them fit behind the sleep), the stencil
    kernel's part of it (one apply and one adjoint of ``p`` on the
    iterate), and the device's idle share of the timed solve (1 - device /
    host time per iteration)."""
    state = slv._mstate
    x = state["x"]
    with torch.no_grad():
        dev_ms = _time_ms(lambda: slv.m_step(state), reps=10)
        sten_ms = sum(_time_ms(lambda adj=adj: st.separable_correlate2d(
            x, p, adj)) for adj in (False, True))
    print(f"[breakdown] {tag}: per iteration device {dev_ms:.4f} ms, stencil "
          f"kernel {sten_ms:.4f} ms ({sten_ms / dev_ms:.1%}), other "
          f"kernels {dev_ms - sten_ms:.4f} ms; host {wall_ms:.4f} ms, "
          f"device idle {1 - dev_ms / wall_ms:.1%}", flush=True)


def _reset(counters):
    for c in counters:
        c.launches = 0


def lasso_phase(st, lasso_deconvolution, MaxIter):
    """The LASSO path at 4K and the bench's 256x256 leg, with their
    stencil launch counts and iteration breakdowns; then 256x256 on the
    card against the CPU."""
    rates = {}
    for shape, iters, rate in ((SHAPE, PATH_ITERS, STOP_RATE),
                               (BENCH_SHAPE, BENCH_ITERS, BENCH_ITERS)):
        # set-up launches, none of them in the timed fit: the factory's
        # y = K x_true (1) and, in the warm fit, the constant-gradient cache
        # c = K^T grad (1), which later fits reuse
        slv, fit, ex = lasso_deconvolution(shape, device="cuda",
                                           stop_rate=rate)
        assert ex["K"].kernel_path == "kernel", ex["K"].kernel_path
        slv.fit(stop_crit=MaxIter(rate), max_iter=rate, **fit)        # warm
        torch.cuda.synchronize()
        _reset([st.separable_correlate2d])
        t0 = time.perf_counter()
        slv.fit(stop_crit=MaxIter(iters), max_iter=iters, **fit)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = st.separable_correlate2d.launches
        assert launches == 2 * iters, (launches, 2 * iters)
        xs = slv.solution()
        assert xs.shape == shape and bool(torch.isfinite(xs).all())
        obj0 = float(slv.objective_func({"x": fit["x0"]}))
        obj = float(slv.objective_func(slv._mstate))
        assert obj < obj0, (obj, obj0)
        rates[shape] = iters / dt
        print(f"[lasso] {shape[0]}x{shape[1]}: {iters} iterations in "
              f"{dt:.4f} s: {rates[shape]:.2f} it/s; stencil launches "
              f"{launches} (2 per iteration, 0 set-up); objective "
              f"{obj0:.6e} -> {obj:.6e}; nnz {int((xs != 0).sum())}",
              flush=True)
        if shape == SHAPE:
            path_launches = launches
        _breakdown(st, slv, ex["K"]._taps, 1e3 * dt / iters,
                   f"lasso {shape[0]}x{shape[1]}")
    # the same 256x256 solve on the card (kernel) and the CPU (plain)
    sols = {}
    for dev in ("cuda", "cpu"):
        slv, fit, _ = lasso_deconvolution(BENCH_SHAPE, device=dev,
                                          stop_rate=CHECK_ITERS)
        slv.fit(stop_crit=MaxIter(CHECK_ITERS), max_iter=CHECK_ITERS, **fit)
        sols[dev] = slv.solution().cpu()
    diff = float((sols["cuda"] - sols["cpu"]).abs().max())
    print(f"[lasso] {CHECK_ITERS} iterations at 256x256, card vs CPU: "
          f"max_abs_diff={diff:.3e} (atol 2e-4)", flush=True)
    assert diff <= 2e-4, diff
    return rates, path_launches


def _nu_points(kind, M, rng):
    """The kernel phase's point sets, in [-pi, pi]."""
    import numpy as np
    if kind == "uniform":
        return rng.uniform(-np.pi, np.pi, (M, 2))
    if kind == "gauss":        # the RI workload's uv density
        return rng.normal(0, np.pi / 3, (M, 2)).clip(-np.pi, np.pi)
    return np.clip(rng.normal(0.3, 0.35, (M, 2)), -np.pi, np.pi)


def _nu_bound(M, n_grid, w, elem, d=2):
    """Least time (ms) of one spread or interp in d dimensions: the plan's
    point data (perm, d left taps, d offsets) and the values read once and
    the grid written or read once, or M (w^d complex-by-real multiply-adds
    and their weight products, 5 operations a tap, plus d w ES evaluations
    of 8 operations), whichever is larger."""
    nbytes = M * (4 + 4 * d + d * elem + 2 * elem) + n_grid * 2 * elem
    ops = M * (5 * w ** d + 8 * d * w)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _blocks(p, name):
    """The launch's blocks a batch element: the spread's tasks by the
    cells a thread owns (a split bin's parts own fewer), the interp's
    subproblems."""
    from pyxu_tpu_torch.ops.nufft import spread_tasks
    if "spread" not in name:
        return f"{p.sub.shape[0]} subproblems"
    runs, n = torch.unique(spread_tasks(p)["run"], return_counts=True)
    return f"{p.tasks.shape[0]} tasks (cells a thread: " + ", ".join(
        f"{r} x {k}" for r, k in zip(runs.tolist(), n.tolist())) + ")"


def _spread_phases(nu, name, a, p, ms):
    """The spread's time split by the ``NU_PHASES`` builds: the walk over
    the candidates and the stores alone, the staging, the adds (the
    remainder of ``ms``, the source's own build).  Returns a dict."""
    t = {}
    for defines in NU_PHASES:
        lib = nu._library(defines)[0]

        def run(lib=lib):
            g = torch.empty((a.shape[0],) + p.nf + (2,), dtype=a.dtype,
                            device=a.device)
            nu._launch(f"{name}_launch", a, g, p, lib)
        t[defines[0]] = _time_ms(run, reps=5)
    walk, no_acc = t["NU_TIME_NO_STAGE"], t["NU_TIME_NO_ACC"]
    return dict(walk_ms=walk, stage_ms=no_acc - walk, add_ms=ms - no_acc)


def _interp_phases(nu, name, a, p, ms):
    """The interp's time split by the ``NU_INTERP_PHASES`` builds: the
    stores alone (the point data read, the results written), the subgrid
    load and the taps, each over the stores, and the overlap of load and
    taps (their sum over the stores against ``ms``, the source's own
    build).  Returns a dict."""
    t = {}
    for defines in NU_INTERP_PHASES:
        lib = nu._library(defines)[0]

        def run(lib=lib):
            out = torch.empty((a.shape[0], p.M, 2), dtype=a.dtype,
                              device=a.device)
            nu._launch(f"{name}_launch", a, out, p, lib)
        t[defines] = _time_ms(run, reps=5)
    stores = t[NU_INTERP_PHASES[2]]
    load = t[NU_INTERP_PHASES[0]] - stores
    taps = t[NU_INTERP_PHASES[1]] - stores
    return dict(load_ms=load, taps_ms=taps, stores_ms=stores,
                overlap_ms=load + taps + stores - ms)


def _nu_check(tag, kern, plain, a, p, dt, twice=False):
    """Hold one NUFFT kernel call against its plain version run in float64
    on the same plan (``Plan.astype``; a float32 running sum of the
    thousands of products in one cell drifts further than the kernels'
    two-level sums).  Two limits, tol = 1e-5 at f32 and 1e-12 at f64: the
    largest error <= tol max|plain|, and the relative l2 error <= tol,
    which also holds the bulk of a grid whose peak stands far above its
    typical cell (the kooshball's centre).  ``twice``: a second launch
    must give the same bits.  Prints the plain version's peak, rms and
    99th percentile of |value|; returns the largest error."""
    want = plain(a.double(), p.astype(torch.float64))
    got = kern(a, p)
    if twice:
        same = torch.equal(got, kern(a, p))
        print(f"[kernel] {tag} two launches bit-identical: {same}",
              flush=True)
        if not same:
            raise SystemExit(f"{tag}: two launches differ")
    diff = got.double() - want
    del got
    err = float(diff.abs().max())
    rel2 = float(torch.linalg.vector_norm(diff)
                 / torch.linalg.vector_norm(want))
    del diff
    mag = torch.linalg.vector_norm(want, dim=-1).flatten()
    peak = float(want.abs().max())
    rms = float(torch.sqrt(torch.mean(mag * mag)))
    step = -(-mag.numel() // (1 << 24))        # torch.quantile's limit
    p99 = float(torch.quantile(mag[::step], 0.99))
    del mag, want
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 1e-12
    ok = err <= tol * peak and rel2 <= tol
    print(f"[kernel] {tag} max_abs_err={err:.3e} tol {tol:g}*max|plain| = "
          f"{tol * peak:.3e}; rel_l2_err={rel2:.3e} tol {tol:g}; |plain| "
          f"rms {rms:.4g}, p99 {p99:.4g}, max {peak:.4g} (tap order): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{tag} disagrees with its plain version")
    return err


def nufft_kernel_phase(nu):
    """Spread and interp against their plain versions on three point sets
    at full size, the spread of ones of the RI path's Toeplitz builds (the
    Gaussian uv set on their 4096^2 grid), and the CT 512^2 path's polar
    set as its FourierRadon folds it (the weighted Toeplitz build's spread
    of its Nyquist-halved weights on the 2048^2 grid, the Hankel build's
    spread of ones at the 60 Nyquist points on its widened grid, A^T y's
    spread and y's interp on A's 1024^2 grid); f32 (timed) and f64
    (checked).  Returns per-case records per kernel."""
    import numpy as np
    from pyxu_tpu_torch.operator.linop.nufft import _es_params
    from pyxu_tpu_torch.utils.misc import next_fast_len
    w, beta = _es_params(1e-6)
    assert w == NU_W, w
    # the fine grid of the (2N - 1)^2 mode grid at upsampfac 2
    assert TOEP_GRID == tuple(next_fast_len(2 * (2 * n - 1))
                              for n in RI_SHAPE), TOEP_GRID
    from pyxu_tpu_torch.operator.linop.xray import FourierRadon
    rng = np.random.default_rng(0)
    recs = {"nufft_spread2": {}, "nufft_interp2": {}}
    # the CT path's polar points as its FourierRadon folds them, and the
    # fine grids of its gram's weighted Toeplitz and Nyquist Hankel builds
    R = FourierRadon(CT_SHAPE, np.linspace(0, np.pi, CT_ANGLES,
                                           endpoint=False), device="cuda")
    G = R.gram()
    n_det = R.codim_shape[1]
    assert R._nufft._t1op._nf == CT_GRID, R._nufft._t1op._nf
    assert G._t._build_params.fft_shape == CT_TOEP_GRID
    hankel_grid = G._h._build_params.fft_shape
    ct_pts = R._nufft._t1op._xh
    del R, G
    sets = [(kind, torch.from_numpy(_nu_points(kind, NU_M, rng)))
            for kind in ("uniform", "gauss", "cluster")]
    sets += [("ct", ct_pts),
             ("ct-hankel", ct_pts.reshape(CT_ANGLES, n_det, 2)[:, n_det // 2])]
    for kind, pts in sets:
        x = torch.remainder(pts.to("cuda"), 2 * np.pi).contiguous()
        M = x.shape[0]
        for dt in (torch.float32, torch.float64):
            gen = torch.Generator(device="cuda").manual_seed(1)
            grid_k = CT_GRID if kind == "ct" else NU_GRID
            c = torch.randn((1, M, 2), generator=gen, device="cuda",
                            dtype=dt)
            g = torch.randn((1,) + grid_k + (2,), generator=gen,
                            device="cuda", dtype=dt)
            cases = [(kind, grid_k, "nufft_spread2", c),
                     (kind, grid_k, "nufft_interp2", g)]
            if kind == "ct-hankel":
                # the Hankel build: a spread of ones on its widened grid
                ones = torch.zeros_like(c)
                ones[..., 0] = 1.0
                cases = [(kind, hankel_grid, "nufft_spread2", ones)]
            if kind in ("gauss", "ct"):
                ones = torch.zeros_like(c)
                ones[..., 0] = 1.0
                if kind == "ct":
                    ones[0, n_det // 2::n_det, 0] = 0.5     # Nyquist bins
                cases.append((f"{kind}-toeplitz" if kind == "ct"
                              else "toeplitz",
                              CT_TOEP_GRID if kind == "ct" else TOEP_GRID,
                              "nufft_spread2", ones))
            for case, grid, name, a in cases:
                p = nu.plan2(x, grid, NU_W, beta, dt)
                kern = getattr(nu, name)
                plain = getattr(nu, name + "_plain")
                tag = (f"{name}[{case}, {grid[0]}x{grid[1]}, "
                       f"{str(dt)[6:]}]")
                err = _nu_check(tag, kern, plain, a, p, dt, twice=True)
                if dt == torch.float32:
                    ms = _time_ms(lambda: kern(a, p))
                    plain_ms = _time_ms(lambda: plain(a, p), reps=2, runs=3)
                    bound_ms, bound_by = _nu_bound(M, grid[0] * grid[1],
                                                   NU_W, 4)
                    print(f"[kernel] {tag} ms={ms:.4f} plain_ms="
                          f"{plain_ms:.4f} bound_ms={bound_ms:.4f} "
                          f"({bound_by}); {_blocks(p, name)}", flush=True)
                    recs[name][case] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=plain_ms,
                                            bound_ms=bound_ms,
                                            bound_by=bound_by)
                    split = (_spread_phases if "spread" in name
                             else _interp_phases)
                    ph = split(nu, name, a, p, ms)
                    print(f"[split] {tag} " + " ".join(
                        f"{k}={v:.4f}" for k, v in ph.items()), flush=True)
                    recs[name][case]["phases"] = ph
                else:
                    recs[name][case]["max_abs_err_f64"] = err
                del p
            del c, g
    return recs


def nudft_phase(N, x, rng):
    """NUFFT type 1 and type 2 (float32 plan, eps 1e-6) at modes N for the
    points x ((M, d) numpy) against a direct NUDFT in float64 on the card,
    on values drawn from ``rng``: relative l-inf <= 1e-5."""
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    M, d = x.shape
    c = rng.standard_normal((M, 2))
    f = rng.standard_normal(N + (2,))
    op = NUFFT.type1(x, N, isign=1, eps=1e-6, dtype=torch.float32,
                     device="cuda")
    got1 = op.apply(torch.from_numpy(c).float().cuda()).double()
    got2 = op.adjoint(torch.from_numpy(f).float().cuda()).double()
    xt = torch.from_numpy(x).cuda()
    k = [torch.arange(-(n // 2), (n + 1) // 2, device="cuda",
                      dtype=torch.float64) for n in N]
    K = torch.stack(torch.meshgrid(*k, indexing="ij"), -1).reshape(-1, d)
    ct = torch.view_as_complex(torch.from_numpy(c).cuda())
    ft = torch.view_as_complex(torch.from_numpy(f).cuda()).reshape(-1)
    ref1 = torch.zeros(K.shape[0], dtype=torch.complex128, device="cuda")
    ref2 = torch.zeros(M, dtype=torch.complex128, device="cuda")
    for i in range(0, K.shape[0], 8192):
        E = torch.exp(1j * (K[i:i + 8192] @ xt.T))        # (chunk, M)
        ref1[i:i + 8192] = E @ ct
        ref2 += E.conj().T @ ft[i:i + 8192]
    errs = []
    for got, ref in ((got1, ref1.reshape(N)), (got2, ref2)):
        diff = torch.view_as_complex(got.contiguous()) - ref
        errs.append(float(diff.abs().max() / ref.abs().max()))
    shape = "x".join(map(str, N))
    print(f"[nudft] type 1 rel l-inf {errs[0]:.3e}, type 2 {errs[1]:.3e} "
          f"(N={shape}, M={M}, eps 1e-6; tol 1e-5)", flush=True)
    assert max(errs) <= 1e-5, errs


def _ri_breakdown(slv, wall_ms, tag):
    """Device time of one ADMM iteration (back-to-back ``m_step`` calls),
    the Toeplitz gram's part of it (4 applies: the CG's initial residual
    and 3 steps), and the device's idle share of the timed solve."""
    state = slv._mstate
    G = slv._f._quad_spec()[0]
    with torch.no_grad():
        # 5 iterations fit behind the sleep (~1.5 ms of host time each)
        dev_ms = _time_ms(lambda: slv.m_step(state), reps=5)
        gram_ms = _time_ms(lambda: G.apply(state["x"]))
    print(f"[breakdown] {tag}: per iteration device {dev_ms:.4f} ms, "
          f"Toeplitz gram {gram_ms:.4f} ms per apply x 4 = "
          f"{4 * gram_ms:.4f} ms ({4 * gram_ms / dev_ms:.1%}), other "
          f"{dev_ms - 4 * gram_ms:.4f} ms; host {wall_ms:.4f} ms, device "
          f"idle {1 - dev_ms / wall_ms:.1%}", flush=True)
    return dev_ms, gram_ms


def ri_phase(nu, radio_interferometry, MaxIter):
    """The RI path at 1024^2 / 10^6 visibilities and the bench's 256^2 /
    20000 leg, with the NUFFT kernels' launch counts over each whole path
    (factory, warm fit, timed fit); then the 256^2 leg on the card against
    the CPU.  Returns rates and the 1024^2 path's launches."""
    out = {}
    for shape, n_vis in ((RI_SHAPE, RI_VIS), (RI_BENCH_SHAPE, RI_BENCH_VIS)):
        tag = f"ri {shape[0]}x{shape[1]}, {n_vis} visibilities"
        torch.cuda.synchronize()
        _reset([nu.nufft_spread2, nu.nufft_interp2])
        t0 = time.perf_counter()
        slv, fit, ex = radio_interferometry(shape, n_vis=n_vis,
                                            device="cuda",
                                            stop_rate=RI_ITERS)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        assert ex["A"].kernel_path == "kernel", ex["A"].kernel_path
        slv.fit(stop_crit=MaxIter(RI_ITERS), max_iter=RI_ITERS, **fit)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slv.fit(stop_crit=MaxIter(RI_ITERS), max_iter=RI_ITERS, **fit)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"nufft_spread2": nu.nufft_spread2.launches,
                    "nufft_interp2": nu.nufft_interp2.launches}
        # spread: the Toeplitz build of A.gram() in estimate_lipschitz and
        # in the loss, and A^H y (the loss's constant gradient, cached by
        # the warm fit); interp: y = A x_true.  The iterations run FFTs only
        want = {"nufft_spread2": 3, "nufft_interp2": 1}
        assert launches == want, (launches, want)
        xs = slv.solution()
        assert xs.shape == shape and bool(torch.isfinite(xs).all())
        obj0 = float(slv.objective_func({"x": fit["x0"]}))
        obj = float(slv.objective_func(slv._mstate))
        assert obj < obj0, (obj, obj0)
        rate = RI_ITERS / dt
        print(f"[ri] {tag}: set-up {setup:.4f} s; {RI_ITERS} iterations in "
              f"{dt:.4f} s: {rate:.2f} it/s; launches {launches} (expected "
              f"{want}, none in the iterations); objective {obj0:.6e} -> "
              f"{obj:.6e}; nnz {int((xs != 0).sum())}", flush=True)
        dev_ms, gram_ms = _ri_breakdown(slv, 1e3 * dt / RI_ITERS, tag)
        out[shape] = dict(rate=rate, setup_s=setup, launches=launches,
                          dev_ms=dev_ms, gram_ms=gram_ms)
        del slv, fit, ex
        if shape == RI_SHAPE:
            out[shape]["setup_breakdown"] = _setup_breakdown(
                f"ri {shape[0]}x{shape[1]}", lambda span: radio_interferometry(
                    shape, n_vis=n_vis, device="cuda", stop_rate=RI_ITERS))
    sols = {}
    for dev in ("cuda", "cpu"):
        slv, fit, _ = radio_interferometry(RI_BENCH_SHAPE,
                                           n_vis=RI_BENCH_VIS, device=dev,
                                           stop_rate=RI_ITERS)
        slv.fit(stop_crit=MaxIter(RI_ITERS), max_iter=RI_ITERS, **fit)
        sols[dev] = slv.solution().cpu()
    diff = float((sols["cuda"] - sols["cpu"]).abs().max())
    print(f"[ri] {RI_ITERS} iterations at 256x256 / {RI_BENCH_VIS} "
          f"visibilities, card vs CPU: max_abs_diff={diff:.3e} (atol 2e-4)",
          flush=True)
    assert diff <= 2e-4, diff
    return out


def _koosh(n_spokes, n_read, rng):
    """A 3-D radial (kooshball) acquisition: ``n_spokes`` spokes of
    ``n_read`` samples each through the origin, along directions drawn
    uniformly on the sphere; samples at pi (j - n_read/2) / (n_read/2), so
    every spoke has one at k = 0.  (n_spokes n_read, 3) numpy points."""
    import numpy as np
    v = rng.standard_normal((n_spokes, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    kr = np.pi * (np.arange(n_read) - n_read // 2) / (n_read // 2)
    return (kr[None, :, None] * v[:, None, :]).reshape(-1, 3)


def _nu3_points(kind, M, rng):
    """The 3-D kernel phase's point sets, in [-pi, pi]."""
    import numpy as np
    if kind == "uniform":
        return rng.uniform(-np.pi, np.pi, (M, 3))
    if kind == "koosh":
        return _koosh(M // MRI_READ, MRI_READ, rng)
    return np.clip(rng.normal(0.3, 0.35, (M, 3)), -np.pi, np.pi)


def nufft3_kernel_phase(nu):
    """The 3-D spread and interp against their plain versions on three
    point sets at the MRI path's size (2^21 points on its 256^3 grid), and
    the spread of ones of its Toeplitz build (the kooshball on 512^3);
    f32 (timed) and f64 (checked).  Returns per-case records per
    kernel."""
    import numpy as np
    from pyxu_tpu_torch.operator.linop.nufft import _es_params
    from pyxu_tpu_torch.utils.misc import next_fast_len
    w, beta = _es_params(1e-6)
    assert NU3_GRID == tuple(next_fast_len(2 * n) for n in MRI_N)
    assert TOEP3_GRID == tuple(next_fast_len(2 * (2 * n - 1))
                               for n in MRI_N), TOEP3_GRID
    M = MRI_SPOKES * MRI_READ
    rng = np.random.default_rng(0)
    recs = {"nufft_spread3": {}, "nufft_interp3": {}}
    for kind in ("uniform", "koosh", "cluster"):
        x = torch.remainder(torch.from_numpy(
            _nu3_points(kind, M, rng)).to("cuda"), 2 * np.pi)
        for dt in (torch.float32, torch.float64):
            gen = torch.Generator(device="cuda").manual_seed(1)
            c = torch.randn((1, M, 2), generator=gen, device="cuda", dtype=dt)
            g = torch.randn((1,) + NU3_GRID + (2,), generator=gen,
                            device="cuda", dtype=dt)
            cases = [(kind, NU3_GRID, "nufft_spread3", c),
                     (kind, NU3_GRID, "nufft_interp3", g)]
            if kind == "koosh":
                ones = torch.zeros_like(c)
                ones[..., 0] = 1.0
                cases.append(("toeplitz", TOEP3_GRID, "nufft_spread3", ones))
            for case, grid, name, a in cases:
                p = nu.plan3(x, grid, w, beta, dt)
                kern = getattr(nu, name)
                plain = getattr(nu, name + "_plain")
                tag = f"{name}[{case}, {grid[0]}^3, {str(dt)[6:]}]"
                err = _nu_check(tag, kern, plain, a, p, dt, twice=True)
                if dt == torch.float32:
                    ms = _time_ms(lambda: kern(a, p), reps=5)
                    plain_ms = _time_ms(lambda: plain(a, p), reps=2, runs=3)
                    bound_ms, bound_by = _nu_bound(M, grid[0] ** 3, w, 4, 3)
                    print(f"[kernel] {tag} ms={ms:.4f} plain_ms="
                          f"{plain_ms:.4f} bound_ms={bound_ms:.4f} "
                          f"({bound_by}); bins {p.bins}, {_blocks(p, name)}",
                          flush=True)
                    recs[name][case] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=plain_ms,
                                            bound_ms=bound_ms,
                                            bound_by=bound_by)
                    split = (_spread_phases if "spread" in name
                             else _interp_phases)
                    ph = split(nu, name, a, p, ms)
                    print(f"[split] {tag} " + " ".join(
                        f"{k}={v:.4f}" for k, v in ph.items()), flush=True)
                    recs[name][case]["phases"] = ph
                else:
                    recs[name][case]["max_abs_err_f64"] = err
                del p
            del c, g
    return recs


def _phantom3(N, rng, n_ell=10):
    """A (*N, 2) float64 CPU image: the real part a sum of ``n_ell``
    ellipsoids with random centres, semi-axes and values; imaginary part
    0."""
    ax = [torch.linspace(-1, 1, n, dtype=torch.float64) for n in N]
    X = torch.stack(torch.meshgrid(*ax, indexing="ij"), -1)
    img = torch.zeros(N, dtype=torch.float64)
    for _ in range(n_ell):
        c = torch.from_numpy(rng.uniform(-0.4, 0.4, 3))
        a = torch.from_numpy(rng.uniform(0.1, 0.5, 3))
        img += float(rng.uniform(-0.5, 1.0)) * (
            (((X - c) / a) ** 2).sum(-1) <= 1)
    return torch.stack([img, torch.zeros_like(img)], -1)


def _mri_data(N, n_spokes, n_read, seed=0):
    """The MRI problem's data from ``seed``: kooshball points, the true
    image and 1% complex Gaussian noise (relative to the samples' rms, the
    scale set by the phantom's mean)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pts = _koosh(n_spokes, n_read, rng)
    xt = _phantom3(N, rng)
    noise = rng.standard_normal((pts.shape[0], 2))
    return pts, xt, noise


def _mri_problem(pts, N, xt, noise, device, span=None):
    """The 3-D Tikhonov reconstruction through the public API, float32:
    ``A = NUFFT.type2``, ``Q = A.gram() + lam * IdentityOp``, ``y = A x +
    noise``, ``b = A^H y``; ``span(name)``: a context around each step (the
    set-up breakdown).  Returns ``(A, G, Q, b)``."""
    from pyxu_tpu_torch.operator.linop import IdentityOp
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    span = span or (lambda name: contextlib.nullcontext())
    with span("A = NUFFT.type2(k, N)"):
        A = NUFFT.type2(pts, N, eps=1e-6, dtype=torch.float32,
                        device=device)
    with span("G = A.gram()"):
        G = A.gram()
    Q = G + MRI_LAM * G.lipschitz * IdentityOp(G.dim_shape)
    with span("y = A x + noise"):
        y = A.apply(xt.to(device=device, dtype=torch.float32))
        scale = 0.01 * torch.sqrt(torch.mean(y * y))
        y = y + scale * torch.from_numpy(noise).to(device=device,
                                                   dtype=torch.float32)
    with span("b = A^H y"):
        b = A.adjoint(y)
    return A, G, Q, b


class _SetupTimer:
    """Named parts of a problem's set-up: host ms from a synchronise to a
    synchronise, and device ms between two CUDA events; a part's name is
    prefixed by the parts it runs in (``G = A.gram() > plan``).  Installed
    as ``operator.linop.nufft.SPAN`` it times the NUFFT's own parts."""

    def __init__(self):
        self.stack, self.rows = [], []

    @contextlib.contextmanager
    def __call__(self, name):
        torch.cuda.synchronize()
        self.stack.append(name)
        row = [" > ".join(self.stack), 0.0, 0.0]
        self.rows.append(row)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        try:
            yield
        finally:
            e1.record()
            torch.cuda.synchronize()
            row[1] = 1e3 * (time.perf_counter() - t0)
            row[2] = e0.elapsed_time(e1)
            self.stack.pop()


def _setup_breakdown(tag, build):
    """``build(span)`` twice under a :class:`_SetupTimer`: first with
    cuFFT's plan cache emptied, as a process's first problem finds it, then
    again with the plans cached; prints every part, host and device ms.
    Returns ``{"cold" | "warm": [(part, host ms, device ms), ...]}``."""
    from pyxu_tpu_torch.operator.linop import nufft as tnu
    out = {}
    for run in ("cold", "warm"):
        if run == "cold":
            torch.backends.cuda.cufft_plan_cache.clear()
        timer = _SetupTimer()
        tnu.SPAN = timer
        try:
            with timer("set-up"):
                build(timer)
        finally:
            tnu.SPAN = None
        for name, host, dev in timer.rows:
            print(f"[setup] {tag} {run}: {name}: host {host:.2f} ms, device "
                  f"{dev:.2f} ms", flush=True)
        out[run] = [tuple(r) for r in timer.rows]
        torch.cuda.empty_cache()
    return out


def mri_phase(nu, MaxIter):
    """The 128^3 kooshball reconstruction by CG: set-up, a warm fit and a
    timed 100-iteration fit with the 3-D NUFFT kernels' launches over the
    whole path, an event-timed iteration breakdown; then the 32^3 problem
    on the card against the CPU.  Returns the rates and launches."""
    from pyxu_tpu_torch.opt.solver import CG
    pts, xt, noise = _mri_data(MRI_N, MRI_SPOKES, MRI_READ)
    torch.cuda.synchronize()
    _reset([nu.nufft_spread3, nu.nufft_interp3])
    t0 = time.perf_counter()
    A, G, Q, b = _mri_problem(pts, MRI_N, xt, noise, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    launches = {"nufft_spread3": nu.nufft_spread3.launches,
                "nufft_interp3": nu.nufft_interp3.launches}
    assert A.kernel_path == "kernel", A.kernel_path
    slv = CG(Q, stop_rate=MRI_ITERS)
    slv.fit(b=b, stop_crit=MaxIter(MRI_ITERS), max_iter=MRI_ITERS)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slv.fit(b=b, stop_crit=MaxIter(MRI_ITERS), max_iter=MRI_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert launches == {"nufft_spread3": nu.nufft_spread3.launches,
                        "nufft_interp3": nu.nufft_interp3.launches}
    # spread: the Toeplitz build of A.gram() and A^H y; interp: y = A x.
    # The iterations run FFTs only
    want = {"nufft_spread3": 2, "nufft_interp3": 1}
    assert launches == want, (launches, want)
    xs = slv.solution()
    assert xs.shape == MRI_N + (2,) and bool(torch.isfinite(xs).all())
    res0 = float(torch.sqrt(torch.sum(b * b)))
    res = float(slv.objective_func(slv._mstate))
    assert res < 1e-2 * res0, (res, res0)
    xt = xt.to("cuda")
    rel = float(torch.linalg.vector_norm(xs - xt)
                / torch.linalg.vector_norm(xt))
    rate = MRI_ITERS / dt
    print(f"[mri] {MRI_N[0]}^3 kooshball, {MRI_SPOKES} spokes x {MRI_READ} "
          f"samples: set-up {setup:.4f} s; {MRI_ITERS} iterations in "
          f"{dt:.4f} s: {rate:.2f} it/s; launches {launches} (expected "
          f"{want}, none in the iterations); residual {res0:.6e} -> "
          f"{res:.6e}; relative error to the phantom {rel:.4f}", flush=True)
    state = slv._mstate
    with torch.no_grad():
        dev_ms = _time_ms(lambda: slv.m_step(state), reps=10)
        gram_ms = _time_ms(lambda: G.apply(state["p"]))
    wall_ms = 1e3 * dt / MRI_ITERS
    print(f"[breakdown] mri {MRI_N[0]}^3: per iteration device {dev_ms:.4f}"
          f" ms, Toeplitz gram {gram_ms:.4f} ms ({gram_ms / dev_ms:.1%}), "
          f"other {dev_ms - gram_ms:.4f} ms; host {wall_ms:.4f} ms, device "
          f"idle {1 - dev_ms / wall_ms:.1%}", flush=True)
    del slv, A, G, Q, b, xs
    breakdown = _setup_breakdown(
        f"mri {MRI_N[0]}^3", lambda span: _mri_problem(
            pts, MRI_N, xt.cpu(), noise, "cuda", span))
    del xt
    N, n_spokes, n_read, iters = MRI_SMALL
    pts, xt, noise = _mri_data(N, n_spokes, n_read)
    sols = {}
    for dev in ("cuda", "cpu"):
        _, _, Q, b = _mri_problem(pts, N, xt, noise, dev)
        s = CG(Q, stop_rate=iters)
        s.fit(b=b, stop_crit=MaxIter(iters), max_iter=iters)
        sols[dev] = s.solution().cpu()
    diff = float((sols["cuda"] - sols["cpu"]).abs().max())
    print(f"[mri] {iters} iterations at {N[0]}^3 ({n_spokes} spokes x "
          f"{n_read} samples), card vs CPU: max_abs_diff={diff:.3e} "
          "(atol 2e-4)", flush=True)
    assert diff <= 2e-4, diff
    return dict(rate=rate, setup_s=setup, launches=launches, dev_ms=dev_ms,
                gram_ms=gram_ms, setup_breakdown=breakdown)


def _ct_counts(nu, st):
    return {"nufft_spread2": nu.nufft_spread2.launches,
            "nufft_interp2": nu.nufft_interp2.launches,
            "stencil": st.separable_correlate2d.launches}


def _ct_breakdown(slv, wall_ms, tag):
    """Device time of one PD3O iteration (back-to-back ``m_step`` calls),
    its FourierRadon gram (one apply of the loss's Q: two rfft/irfft
    pairs), its four stencil launches (one apply and one adjoint of the
    gradient) and the rest, and the device's idle share of the timed
    solve."""
    state = slv._mstate
    Q, D = slv._f._quad_spec()[0], slv._K
    with torch.no_grad():
        dev_ms = _time_ms(lambda: slv.m_step(state), reps=5)
        gram_ms = _time_ms(lambda: Q.apply(state["x"]))
        st_ms = (_time_ms(lambda: D.apply(state["x"]))
                 + _time_ms(lambda: D.adjoint(state["z"])))
    rest = dev_ms - gram_ms - st_ms
    print(f"[breakdown] {tag}: per iteration device {dev_ms:.4f} ms, gram "
          f"{gram_ms:.4f} ms ({gram_ms / dev_ms:.1%}), stencils x 4 "
          f"{st_ms:.4f} ms ({st_ms / dev_ms:.1%}), other {rest:.4f} ms; "
          f"host {wall_ms:.4f} ms, device idle {1 - dev_ms / wall_ms:.1%}",
          flush=True)
    return dict(dev_ms=dev_ms, gram_ms=gram_ms, stencil_ms=st_ms,
                rest_ms=rest, idle=1 - dev_ms / wall_ms)


def ct_phase(nu, st, sparse_view_ct, MaxIter):
    """The CT path (sparse-view CT by PD3O over FourierRadon) at 512^2 / 60
    views and the bench's 256^2 leg: set-up, a warm fit and a timed fit of
    ``CT_ITERS`` in one segment, with the kernels' launches counted over
    the set-up, the warm fit and the timed fit; an event-timed iteration
    breakdown; the stencil kernel against its plain version at each
    shape with the gradient's own taps, in f32 and f64; the 512^2 set-up by
    part.  Then the card against the CPU: ``CT_CHECKS`` (FourierRadon at
    64^2, RadonTransform at 128^2), and FourierRadon and its gram at
    ``CT_ODD``, whose A grid has an odd side, with their launches counted.
    Returns per-shape records."""
    from pyxu_tpu_torch.operator.linop.xray import (FourierRadon,
                                                    _FourierRadonGram)
    counters = [nu.nufft_spread2, nu.nufft_interp2, st.separable_correlate2d]
    per_it = 4           # Gradient: 2 stencils in K^T z, 2 in K(.)
    out = {}
    for shape in (CT_SHAPE, CT_BENCH_SHAPE):
        tag = f"ct {shape[0]}x{shape[1]}, {CT_ANGLES} angles"
        torch.cuda.synchronize()
        _reset(counters)
        t0 = time.perf_counter()
        slv, fit, ex = sparse_view_ct(shape, n_angles=CT_ANGLES,
                                      method="fourier", device="cuda",
                                      stop_rate=CT_ITERS)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        A = ex["A"]
        assert A.kernel_path == "kernel", A.kernel_path
        leaf = slv._f._quad_spec()[0]
        while hasattr(leaf, "_op"):
            leaf = leaf._op
        assert isinstance(leaf, _FourierRadonGram), type(leaf)
        assert ex["D"]._ops[0].kernel_path == "kernel"
        # spread: the weighted Toeplitz and the Nyquist Hankel builds of
        # A.gram(), once in the Lipschitz estimate and once in the loss;
        # interp: y = A x_true
        got = [_ct_counts(nu, st)]
        want = [{"nufft_spread2": 4, "nufft_interp2": 1, "stencil": 0}]
        slv.fit(stop_crit=MaxIter(CT_ITERS), max_iter=CT_ITERS, **fit)
        torch.cuda.synchronize()
        # the warm fit adds A^T y (the loss's constant gradient, cached)
        got.append(_ct_counts(nu, st))
        want.append({"nufft_spread2": 5, "nufft_interp2": 1,
                     "stencil": per_it * CT_ITERS})
        _reset(counters)
        t0 = time.perf_counter()
        slv.fit(stop_crit=MaxIter(CT_ITERS), max_iter=CT_ITERS, **fit)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got.append(_ct_counts(nu, st))
        want.append({"nufft_spread2": 0, "nufft_interp2": 0,
                     "stencil": per_it * CT_ITERS})
        assert got == want, (got, want)
        # the stencil's launches of the timed fit (as the LASSO path counts
        # its own); the NUFFT kernels' of the set-up and the warm fit (the
        # timed fit makes none)
        launches = {k: got[2][k] if k == "stencil" else got[1][k]
                    for k in got[2]}
        D = ex["D"]
        errs = []
        for fdt in (torch.float32, torch.float64):
            gen = torch.Generator(device="cuda").manual_seed(3)
            xk = torch.rand(shape, generator=gen, device="cuda", dtype=fdt)
            for i, op in enumerate(D._ops):
                rec = _st_variants(st, op._taps, xk, f" ct-D{i} {shape[0]}"
                                   f"x{shape[1]} {str(fdt)[6:]}",
                                   plain_timed=False, verbose=False)
                errs.append(max(r["max_abs_err"] for r in rec.values()))
        print(f"[kernel] stencil at the CT path's taps (both partials of "
              f"the gradient) and shape {shape[0]}x{shape[1]}, apply and "
              f"adjoint, constant and symmetric, f32 and f64: largest "
              f"max_abs_err {max(errs):.3e}: ok", flush=True)
        xs = slv.solution()
        assert xs.shape == shape and bool(torch.isfinite(xs).all())
        assert float(xs.min()) >= 0.0
        obj0 = float(slv.objective_func({"x": fit["x0"]}))
        obj = float(slv.objective_func(slv._mstate))
        assert obj < obj0, (obj, obj0)
        xt = ex["x_true"]
        rel = float(torch.linalg.vector_norm(xs - xt)
                    / torch.linalg.vector_norm(xt))
        rate = CT_ITERS / dt
        print(f"[ct] {tag}, n_det {A.codim_shape[1]}: set-up {setup:.4f} s; "
              f"{CT_ITERS} iterations in {dt:.4f} s: {rate:.2f} it/s; "
              f"launches set-up {got[0]}, warm fit {got[1]}, timed fit "
              f"{got[2]} (as expected: no NUFFT in the iterations, "
              f"{per_it} stencils an iteration); objective {obj0:.6e} -> "
              f"{obj:.6e}; relative error to the phantom {rel:.4f}",
              flush=True)
        out[shape] = dict(rate=rate, setup_s=setup, launches=launches,
                          **_ct_breakdown(slv, 1e3 * dt / CT_ITERS, tag))
        del slv, fit, ex, A, leaf, xs, D, xk
        if shape == CT_SHAPE:
            def build(span):
                slv, fit, _ = sparse_view_ct(CT_SHAPE, n_angles=CT_ANGLES,
                                             method="fourier",
                                             device="cuda")
                with span("A^T y"):
                    slv._f.grad(fit["x0"])
            out[shape]["setup_breakdown"] = _setup_breakdown(
                f"ct {shape[0]}x{shape[1]}", build)
    for shape, n_ang, method, iters in CT_CHECKS:
        sols = {}
        for dev in ("cuda", "cpu"):
            slv, fit, _ = sparse_view_ct(shape, n_angles=n_ang,
                                         method=method, device=dev,
                                         stop_rate=iters)
            slv.fit(stop_crit=MaxIter(iters), max_iter=iters, **fit)
            sols[dev] = slv.solution().cpu()
        diff = float((sols["cuda"] - sols["cpu"]).abs().max())
        print(f"[ct] {iters} iterations at {shape[0]}x{shape[1]} / {n_ang} "
              f"angles, method={method}, card vs CPU: max_abs_diff="
              f"{diff:.3e} (atol 2e-4)", flush=True)
        assert diff <= 2e-4, diff
    (H, W), n_ang, n_det = CT_ODD
    angles = [float(a) for a in torch.linspace(0, torch.pi, n_ang + 1)[:-1]]
    x = torch.rand((2, H, W), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64).float()
    res = {}
    for dev in ("cuda", "cpu"):
        R = FourierRadon((H, W), angles, n_det=n_det, dtype=torch.float32,
                         device=dev)
        nf = R._nufft._t1op._nf
        _reset(counters)
        res[dev] = (R.apply(x.to(dev)).cpu(),
                    R.gram().apply(x.to(dev)).cpu())
        # the apply's interp; the gram's Toeplitz and Hankel builds
        want = ({"nufft_spread2": 2, "nufft_interp2": 1, "stencil": 0}
                if dev == "cuda" else
                {"nufft_spread2": 0, "nufft_interp2": 0, "stencil": 0})
        assert _ct_counts(nu, st) == want, (dev, _ct_counts(nu, st))
    assert any(n % 2 for n in nf), nf
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(res["cuda"], res["cpu"])]
    print(f"[ct] FourierRadon {H}x{W}, n_det {n_det} (A's fine grid {nf}): "
          f"card vs CPU relative l-inf apply {errs[0]:.3e}, gram "
          f"{errs[1]:.3e} (tol 1e-5)", flush=True)
    assert max(errs) <= 1e-5, errs
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from pyxu_tpu_torch.models import (
        lasso_deconvolution,
        radio_interferometry,
        sparse_view_ct,
        tv_deconvolution,
    )
    from pyxu_tpu_torch.ops import fused_tv as ft
    from pyxu_tpu_torch.ops import nufft as nu
    from pyxu_tpu_torch.ops import stencil as st
    from pyxu_tpu_torch.opt.stop import MaxIter

    # the builds started before torch was imported run on while the
    # device is queried
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    _mark("imports and device query")
    for (src, defines), fut in BUILDS.items():
        so, log, sec = fut.result()
        print(f"[build] {src} {' '.join(defines)} built in {sec:.2f} s",
              flush=True)
        # nufft.cu's 70 kernels: the named lines below
        quiet = defines or src == "nufft.cu"
        for line in log.splitlines() if not quiet else ():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {line.strip()}", flush=True)
    # the NUFFT kernels: registers and spills (the spreads, and the interps
    # at the paths' w = 7 in float32), and no atomic in the SASS
    so, log, _ = BUILDS[("nufft.cu", ())].result()
    w7 = ("nu_interp_kernelIfLi2ELi7E", "nu_interp_kernelIfLi3ELi7E")
    for line in _kernel_resources(log, ("nu_spread",) + w7):
        print(f"[build] {line}", flush=True)
    sass = _sass_atomics(so, ("nu_spread", "nu_interp"))
    for fn, n in sass.items():
        if "nu_spread" in fn:
            print(f"[sass] {fn}: {n} ATOM/ATOMS/ATOMG/RED instructions",
                  flush=True)
    interps = [n for fn, n in sass.items() if "nu_interp" in fn]
    if interps:
        print(f"[sass] nu_interp_kernel ({len(interps)} instantiations): "
              f"{sum(interps)} ATOM/ATOMS/ATOMG/RED instructions", flush=True)
    if not sass:
        print("[sass] cuobjdump not found: atomics not counted", flush=True)
    assert not any(sass.values()), sass
    for mod in (ft, st, nu):
        mod.build()                     # loads the built library
    _mark("build")

    # ---- phase 2: kernels vs plain at the workload's shape -------------
    H, W = SHAPE
    slv, fit, ex = tv_deconvolution(SHAPE, device="cuda", stop_rate=STOP_RATE)
    slv.m_init(**fit)
    assert slv.fused_path == "kernel", slv.fused_path
    p, b = slv._fused.params, slv._fused.b
    x = fit["x0"].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = 0.01 * torch.randn((2, H, W), generator=gen, device="cuda")
    # the path's depth (None: single steps only); tv_stepk is held at it,
    # else at KSTEP_CHECK
    kstep = ft.match_fused_tv2(slv._fused, SHAPE)
    kcheck = kstep or KSTEP_CHECK
    cases = (("tv_step", 1), ("tv_stepk", kcheck))
    recs = kernel_phase(ft, p, x, z, b, cases)
    # constant mode, asymmetric taps, a shape no tile divides
    pa = dataclasses.replace(p, k0=(0.2, 0.5, 0.3), k1=(0.1, 0.6, 0.2, 0.1),
                             c0=1, c1=2, mode_k="constant",
                             mode_d="constant")
    Ha, Wa = ODD_SHAPE
    xa = torch.rand(ODD_SHAPE, generator=gen, device="cuda")
    za = 0.1 * torch.randn((2, Ha, Wa), generator=gen, device="cuda")
    ba = 0.1 * torch.randn(ODD_SHAPE, generator=gen, device="cuda")
    kernel_phase(ft, pa, xa, za, ba, cases, timed=False,
                 label=f" constant asym {Ha}x{Wa}")
    sweep = k_sweep(ft, p, x, z, b)
    print(f"[sweep] fastest K={min(sweep, key=sweep.get)}; the path runs "
          f"K={kstep or 1} (tiles {ft._TILES})", flush=True)
    st_recs, st_recs64, st_sweep, st_library_ms = stencil_phase(
        st, ex["K"]._taps, x)
    _mark("kernel phase")

    # ---- phase 3: the TV path ------------------------------------------
    counters = [ft.tv_step, ft.tv_stepk, st.separable_correlate2d]
    slv.fit(stop_crit=MaxIter(STOP_RATE), max_iter=STOP_RATE, **fit)  # warm
    torch.cuda.synchronize()
    _reset(counters)
    t0 = time.perf_counter()
    slv.fit(stop_crit=MaxIter(PATH_ITERS), max_iter=PATH_ITERS, **fit)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"tv_step": ft.tv_step.launches,
                "tv_stepk": ft.tv_stepk.launches}
    kk = slv._m_step2_iters
    segs = PATH_ITERS // STOP_RATE
    if kk:
        want = {"tv_stepk": segs * (STOP_RATE // kk),
                "tv_step": segs * (STOP_RATE % kk)}
    else:
        want = {"tv_stepk": 0, "tv_step": PATH_ITERS}
    print(f"[path] fused_path={slv.fused_path} K={kk or 1} "
          f"launches={launches} expected={want}", flush=True)
    assert slv.fused_path == "kernel" and (kk or None) == kstep, (
        slv.fused_path, kk, kstep)
    assert launches == want, launches
    assert all(launches[k] > 0 for k, n in want.items() if n), launches
    xs = slv.solution()
    assert xs.shape == SHAPE and bool(torch.isfinite(xs).all())
    obj0 = float(slv.objective_func({"x": fit["x0"]}))
    obj = float(slv.objective_func(slv._mstate))
    assert obj < obj0, (obj, obj0)
    rate = PATH_ITERS / dt
    print(f"[path] {PATH_ITERS} iterations in {dt:.4f} s: {rate:.2f} it/s; "
          f"objective {obj0:.6e} -> {obj:.6e}", flush=True)

    # ---- fused vs generic operator path --------------------------------
    sols, rates = {}, {}
    for fuse in (True, False):
        s, fk, _ = tv_deconvolution(SHAPE, device="cuda",
                                    stop_rate=PARITY_RATE, fuse=fuse)
        s.fit(stop_crit=MaxIter(PARITY_RATE), max_iter=PARITY_RATE, **fk)
        torch.cuda.synchronize()
        _reset(counters)
        t0 = time.perf_counter()
        s.fit(stop_crit=MaxIter(PARITY_ITERS), max_iter=PARITY_ITERS, **fk)
        torch.cuda.synchronize()
        rates[fuse] = PARITY_ITERS / (time.perf_counter() - t0)
        assert s.fused_path == ("kernel" if fuse else None), s.fused_path
        if not fuse:
            # K^T K x (2), D^T z (2) and D v (2): six Stencils an iteration
            n = st.separable_correlate2d.launches
            assert n == 6 * PARITY_ITERS, n
            assert ft.tv_step.launches == ft.tv_stepk.launches == 0
        sols[fuse] = s.solution()
    diff = float((sols[True] - sols[False]).abs().max())
    print(f"[parity] {PARITY_ITERS} iterations fused vs generic: "
          f"max_abs_diff={diff:.3e} (atol 2e-4); fused {rates[True]:.2f} it/s,"
          f" generic {rates[False]:.2f} it/s through the stencil kernel "
          f"(219 it/s before the stencil kernel) on {smi}", flush=True)
    assert diff <= 2e-4, diff
    _mark("TV path and parity")

    # ---- phase 4: the LASSO path ---------------------------------------
    lasso_rates, st_launches = lasso_phase(st, lasso_deconvolution, MaxIter)
    _mark("LASSO path")

    # ---- phases 5-7: the NUFFT kernels, the NUDFT check, the RI path ----
    nu_recs = nufft_kernel_phase(nu)
    _mark("NUFFT kernel phase")
    rng = np.random.default_rng(2)
    nudft_phase((256, 256), _nu_points("gauss", 4000, rng), rng)
    _mark("NUDFT check")
    ri = ri_phase(nu, radio_interferometry, MaxIter)
    _mark("RI path")

    # ---- phases 8-10: the 3-D NUFFT kernels, NUDFT check, the MRI path --
    nu3_recs = nufft3_kernel_phase(nu)
    _mark("3-D NUFFT kernel phase")
    rng = np.random.default_rng(3)
    nudft_phase((32, 32, 32), rng.uniform(-np.pi, np.pi, (4000, 3)), rng)
    _mark("3-D NUDFT check")
    mri = mri_phase(nu, MaxIter)
    _mark("MRI path")

    # ---- phase 11: the CT path -----------------------------------------
    ct = ct_phase(nu, st, sparse_view_ct, MaxIter)
    _mark("CT path")

    kernels = []
    for kname, replaces, n_steps in (
            ("tv_step", "pyxu_tpu/ops/fused_tv.py:390", 1),
            ("tv_stepk", "pyxu_tpu/ops/fused_tv.py:926", kcheck)):
        r, rb = recs[(kname, "f32")], recs[(kname, "bf16z")]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "pyxu_tpu_torch/csrc/fused_tv.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "n_steps": n_steps,
            "bf16z": {k: rb[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms")},
        })
    # the LASSO path's launches are symmetric applies and adjoints, half each
    path_mix = [st_recs[t] for t in ("symmetric", "symmetric-adjoint")]
    kernels.append({
        "name": "stencil", "route": "cuda",
        "source": "pyxu_tpu_torch/csrc/stencil.cu",
        "replaces": "pyxu_tpu/ops/pallas_stencil.py:76",
        "launches": st_launches,
        "max_abs_err": max(v["max_abs_err"] for v in st_recs.values()),
        "ms": statistics.fmean(r["ms"] for r in path_mix),
        "plain_ms": statistics.fmean(r["plain_ms"] for r in path_mix),
        "bound_ms": path_mix[0]["bound_ms"],
        "bound_by": path_mix[0]["bound_by"], "library_ms": st_library_ms,
        "variants": {k: {f: v[f] for f in ("ms", "plain_ms", "max_abs_err")}
                     for k, v in st_recs.items()},
        "f64": {k: {f: v[f] for f in ("ms", "plain_ms", "max_abs_err",
                                      "bound_ms")}
                for k, v in st_recs64.items()},
        "sweep": st_sweep,
        "ct_launches": ct[CT_SHAPE]["launches"]["stencil"],
    })
    # the RI 1024^2 path spreads twice on the Toeplitz grid and once (A^H y)
    # on A's; it interpolates once (y) on A's grid.  The MRI 128^3 path
    # spreads once on the Toeplitz grid and once (A^H y) on A's; it
    # interpolates once (y) on A's grid
    nu_mix = {"nufft_spread2": {"toeplitz": 2, "gauss": 1},
              "nufft_interp2": {"gauss": 1},
              "nufft_spread3": {"toeplitz": 1, "koosh": 1},
              "nufft_interp3": {"koosh": 1}}
    for kname, replaces, path, recs_k in (
            ("nufft_spread2", "pyxu_tpu/ops/pallas_nufft.py:126 (slab_spread)"
             ", :711 (strip_spread2), :842 (ragged_spread2)", ri[RI_SHAPE],
             nu_recs),
            ("nufft_interp2", "pyxu_tpu/ops/pallas_nufft.py:193 (slab_interp)"
             ", :778 (strip_interp2), :897 (ragged_interp2)", ri[RI_SHAPE],
             nu_recs),
            ("nufft_spread3", "pyxu_tpu/ops/pallas_nufft.py:272 "
             "(slab_spread3), :407 (pencil_spread3), :563 (strip_spread3), "
             ":961 (ragged_spread3), :1097 (ragged_pencil_spread3)", mri,
             nu3_recs),
            ("nufft_interp3", "pyxu_tpu/ops/pallas_nufft.py:325 "
             "(slab_interp3), :474 (pencil_interp3), :625 (strip_interp3), "
             ":1017 (ragged_interp3), :1159 (ragged_pencil_interp3)", mri,
             nu3_recs)):
        rs, mix = recs_k[kname], nu_mix[kname]
        assert sum(mix.values()) == path["launches"][kname], mix
        top = max(mix, key=mix.get)

        def mixed(f):
            return sum(n * rs[k][f] for k, n in mix.items()) / sum(
                mix.values())
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "pyxu_tpu_torch/csrc/nufft.cu", "replaces": replaces,
            "launches": path["launches"][kname],
            "max_abs_err": max(v["max_abs_err"] for v in rs.values()),
            "ms": mixed("ms"), "plain_ms": mixed("plain_ms"),
            "bound_ms": mixed("bound_ms"), "bound_by": rs[top]["bound_by"],
            "library_ms": None, "path_mix": mix,
            "ct_launches": ct[CT_SHAPE]["launches"].get(kname, 0),
            "variants": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                "max_abs_err", "phases")
                             if f in v}
                         for k, v in rs.items()},
        })
    print(json.dumps({"kernels": kernels, "path_it_per_s": rate,
                      "fused_it_per_s": rates[True],
                      "tv_ms_per_iteration_by_k": sweep,
                      "generic_it_per_s": rates[False],
                      "lasso_4k_it_per_s": lasso_rates[SHAPE],
                      "lasso_256_it_per_s": lasso_rates[BENCH_SHAPE],
                      "ri_1024_it_per_s": ri[RI_SHAPE]["rate"],
                      "ri_256_it_per_s": ri[RI_BENCH_SHAPE]["rate"],
                      "ri_1024_setup_s": ri[RI_SHAPE]["setup_s"],
                      "mri3d_128_it_per_s": mri["rate"],
                      "mri3d_128_setup_s": mri["setup_s"],
                      "ct_512_it_per_s": ct[CT_SHAPE]["rate"],
                      "ct_256_it_per_s": ct[CT_BENCH_SHAPE]["rate"],
                      "ct_512_setup_s": ct[CT_SHAPE]["setup_s"]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
