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
12. the solver engine and the last two solvers (``engine_phase``; each
   timed fit after a warm fit, each held to its full iteration count read
   from its history): TV 2160x3840 under ``precision_schedule=[(bf16,
   200), (f32, None)]`` (300 ``tv_step`` launches, ``fused_path`` "kernel"
   in both phases, x and z stored in bf16 in the first, the same bits as
   the two phases run as two fits, the objective within 1e-2 of the f32
   solve's; each phase's it/s, then both as warm fits of 100 with the
   cast outside the window, and ``tv_step`` timed on f32 and on bf16 x
   and z); LASSO 2160x3840 sessions (``RelError |
   MaxIter`` reads the device once a block but the last; 150 + 150
   warm-started iterations give a cold 300's bits; ``update_operands``
   onto seed 1's loss gives a fresh solve's bits; ``track_objective``'s
   last row is ``objective_func``; ``writeback`` under the ``npz`` and
   ``torch`` backends reads back the same bits; a schedule with a bf16
   phase raises the stencil kernel's ValueError); NLCG on Tikhonov
   deconvolution with the 9-tap blur and ProxAdam (adam, ``inner_iter``
   10) on LASSO, 30 iterations each at 2160x3840 with their stencil
   launches checked, line-search trials and host reads an iteration, and
   their 64x48 forms card vs CPU within 2e-4, also from ``a0 = 10/L``,
   where the line search backtracks (the same trials and steps on the
   card as on the CPU); CT 512^2 in ASYNC mode with
   ``ManualStop``, stopped after 0.5 s (iterations multiples of
   ``stop_rate``, 4 stencils an iteration, x finite and >= 0), and 20
   MANUAL steps against a 20-iteration BLOCK fit (same bits).
13. wide-field synthesis imaging (``t3_phase``, HVOX-style: sky pixels on
   the sphere against non-coplanar visibilities, one 3-D type-3 NUFFT):
   131 072 pixels on a 4 deg cap, 258 048 visibilities (64 antennas, 2016
   baselines x 128 steps of an 8 h track at 1.4 GHz), ``A =
   NUFFT.type3(pixels, 2 pi uvw, isign=-1)`` on its 1536x1536x60 grid
   (f32, eps 1e-6, w = 7); both 3-D kernels on the plan's two clouds (x'
   on half of each ring, s' on the frequency ring) against their plain
   versions in float64, timed; A against a float64 direct sum at 1024
   visibilities (f32 and a float64 plan) and the dot test; the chunked
   plan (``fft_mem_mb=256, max_blocks=16``) against the monolithic apply;
   the 2-D coplanar form against the direct sum on the 2-D kernels; CG on
   ``(A^H A + 1e-2 K I) x = A^H y``, a warm fit and a timed fit of 20
   iterations with 2 + 2 launches an iteration asserted (and the initial
   residual's), an iteration's device time by part, the set-up by part
   (``[setup]``); the same problem at 2000 pixels / 3000 visibilities
   card against CPU.  The ``kernels`` line's NUFFT entries carry
   ``t3_launches`` (the 3-D kernels' in the timed fit, the 2-D kernels'
   in the coplanar form's apply and adjoint) and ``t3`` (per cloud: ms,
   plain and bound ms, errors).
14. Bayesian uncertainty for 4K deblurring by MYULA (``uq_phase``; Durmus,
   Moulines & Pereyra, SIAM J. Imaging Sci. 11(1), 2018, section 4): at
   2160x3840, f32, workload 1's sparse image blurred by the 9-tap sigma = 2
   Stencil (symmetric padding) with 1% noise, f = 0.5 ||Kx - y||^2 / 0.01^2
   and g = 0.05 ||x||_1 / 0.01^2, ``MYULA(f, g)`` with its default lamb and
   gamma (printed, with f's diff-Lipschitz constant); a warm chain, then
   500 burn-in steps and 2000 samples through ``samples()`` into
   ``OnlineMoment(1)`` and ``OnlineStd()`` (steps/s, samples/s, device ms a
   step by CUDA events, idle share; mean and std finite, std > 0), 2
   stencil launches a step asserted; ``run(n=16, thin=8)`` against a
   two-pass mean and std of its stack (1e-5 relative); the drift against
   ``f.grad + g.moreau_envelope(lamb).grad`` (1e-6 relative); the same
   seed twice, the same bits; the 64x48 form, 100 steps with the CPU's
   noise fed to both devices (2e-4 of max|x|).  Then Tikhonov deblurring,
   ``K.pinv(y, damp=1e-2)`` at 2160x3840: the same bits as
   ``K.dagger(1e-2).apply(y)``, the relative normal-equation residual
   within 2 rtol, the stencil's launches (1 for K^T y, 2 for the initial
   residual, 2 a CG iteration, the iterations a multiple of
   ``math.cg.CHECK_RATE``), CG iterations/s, and the 64x48 form card vs
   CPU.  The stencil's entry on the ``kernels`` line gains
   ``uq_launches`` and ``pinv_launches``; the JSON line
   ``myula_4k_it_per_s`` and ``pinv_4k_it_per_s``.
15. Hessian-Frobenius deconvolution (``hf_phase``; Lefkimmiatis,
   Bourquard & Unser, IEEE TIP 21(3), 2012, section III): at 2160x3840,
   f32, the ``peaks`` surface clipped at 0 and normalised, workload 1's
   9-tap sigma = 2 blur K (symmetric padding) with 1% noise from
   ``numpy.random.default_rng(0)``, f = 0.5 ||Kx - y||^2, g the positive
   orthant, L = vstack([Hessian (0, 0), sqrt(2) Hessian (0, 1), Hessian
   (1, 1)]) (symmetric mode), h = 2e-3 ||.||_{2,1} over L's 3 channels, so
   that h(Lx) is lam sum ||Hess x||_F; ``CondatVu(f=f, g=g, h=h, K=L)`` on
   the generic path (``fused_path`` None), a warm fit and a timed fit of
   300 iterations, ``stop_rate`` 100, with 8 stencil launches an iteration
   asserted (3 partials forward, 3 adjoint, the blur's gram 2); it/s, an
   iteration's device time, the stencil's part of it and the idle share;
   x >= 0 and finite; the objective below its value at y and at max(y, 0);
   the 64x48 form (30 iterations) card vs CPU within 2e-4 of max|x|.
   Phase 2 holds the stencil kernel at the Hessian's three tap sets too
   ([1, -2, 1] x [1], sqrt(2) [-1/2, 0, 1/2] x [-1/2, 0, 1/2], [1] x [1,
   -2, 1]; apply and adjoint, both modes, f32 and f64, at 2160x3840,
   ``[kernel] stencil hessian`` lines, each set's ``conv2d`` time).
16. the rest of the operator library on the card (``library_phase``,
   small and untimed): SubSample, Trim, Sum, kron, khatri_rao, stack,
   hstack, block_diag (operators, and a separable sum's prox), coo_block,
   Jacobian, Divergence, Laplacian, the four directional forms with a
   per-pixel field, a Gaussian-derivative Gradient, the element-wise maps
   and their Jacobians, Sobel(axis=None) and StructureTensor (apply and
   Jacobian), each against the same operator on the CPU within 2e-4 of
   max|y|; then SparseExplicitLinOp, the 5-point Laplacian of a 512^2
   image as a scipy CSR matrix (1 308 672 nonzeros), apply and adjoint
   against ``Laplacian(mode="constant")`` within 1e-5 of max|y|, its ms an
   apply beside the dense operator's (cuSPARSE, no kernel row).  The
   stencil's entry on the ``kernels`` line gains ``hf_launches`` and
   ``hessian_taps``; the JSON line ``hf_4k_it_per_s``.
17. the parallel layer on the card (``parallel_phase``) over a NCCL group
   of world size 1 on a ``file://`` store (the backend asserted): workload
   5, ``consensus_tiles`` (consensus ADMM, the tiles' mean all-reduced over
   the mesh) at the JAX bench's leg, 8 tiles of 512x512, 1000 iterations in
   one segment (a warm fit, the best of two timed fits; printed as
   ``consensus_admm_8x512_1dev``) and at 1.07 G pixels, 64 tiles of
   4096x4096, 50 iterations (a warm fit of 2, one timed fit): it/s,
   device ms an iteration (``torch.profiler``: the tiles' proxes are one
   CG over the stacked tiles, the separable sum's ``batched_path``
   "quadratic" (asserted), which reads its flag on the host once a
   check), host reads an iteration (asserted at most 1), idle share, peak
   memory, no kernel launched, z against the closed form
   soft(mean y, lam/2) (asserted within 1e-4 after 1000 iterations); the
   2-tile 64x48 form card vs CPU (2e-4 of max|z|).  Out-of-core TV
   (``StreamedCondatVu``) at 16384x16384 f32 with workload 1's 9-tap blur,
   lam 0.01, 8 bands of 2048 rows, 3 iterations: seconds an iteration,
   bytes moved host<->device an iteration against the pinned copy rates and
   a host memcpy's (measured), each iteration's host-clock split into
   staging, device part and write-back, the band step's device time, 6
   stencil launches a band step (asserted), the result against the
   in-memory iteration on the card (5e-6 of max(1, max|x|)), and the
   stencil kernel against its plain version at the band's shape
   (2068x16384) with the blur's and the Gradient's taps.  ShardedStencil
   (both modes, 2160x3840, the 9-tap blur), ShardedNUFFT (types 1 and 2 on
   the RI 1024^2 / 10^6-point geometry and at d = 3) and ShardedNUFFT3
   (d = 3, one z-block) against their unsharded operators (1e-5 of
   max|y|), ShardedNUFFT at d = 3 against float64 direct sums at 1024
   modes and 1024 points (1e-5), and ShardedNUFFT3 with 8 z-blocks against
   a float64 direct sum (1e-4), each call's launches asserted.  The stencil's and the NUFFT kernels' entries
   on the ``kernels`` line gain ``sharded_launches`` (the stencil also
   ``ooc_launches``); the JSON line ``consensus_admm_8x512_1dev``,
   ``consensus_admm_64x4096_1dev``, ``ooc_tv_16k_s_per_iter`` and
   ``parallel``.  Then the streamed blur (``overlap_phase``): workload
   1's 9-tap blur over a 16384x16384 f32 host array through
   ``streamed_map_overlap`` (8 bands of 2048 rows, depth 5, one band in
   flight): first a serial loop that times each part of each band alone
   (the host fill into a page-locked buffer and the write-back into the
   output on the host clock; the copy up, the blur and the copy down by
   CUDA events), then the overlapped call, warm, timed 3 times (its
   result the serial loop's bits, one stencil launch a band, asserted):
   ``[overlap]`` lines with one band's parts, their sums over the bands,
   the serial sum against the call's wall time, and the largest part's
   share of it; the JSON key ``ooc_blur_16k_overlap``, the stencil
   entry's ``ooc_overlap_launches``.
18. 3-channel chromatic deblurring at 2160x3840 (``chromatic_phase``): a
   simple lens blurs each colour channel by its own 9-tap Gaussian (sigma
   1.2, 1.6, 2.0; Heide et al., ACM TOG 32(5), 2013), composed through the
   public API as ``K = block_diag`` of the channels' Stencils (its
   ``batched_path`` "stencil" asserted), ``SquaredL2Norm.asloss(y) * K``
   and ``lam L1Norm``, solved by FISTA (``PGD``), 300 iterations in f32
   from seed 0: 2 launches an iteration of the stencil kernel with a tap
   set a channel (asserted; a loop over the channels would make 6), it/s,
   device ms an iteration, the kernel's part and the idle share; the
   3x64x48 form card vs CPU (2e-4).  Phase 2 holds that kernel against its
   plain version at 8x512x512 (8 sigmas) and 3x2160x3840 (the path's
   sigmas), apply and adjoint in both modes, f32 (1e-5 max|x|, timed,
   beside the single-tap-set launch on the same batch and one grouped
   ``conv2d``) and f64 (1e-12 max|x|).  The stencil's entry on the
   ``kernels`` line gains ``chromatic_launches``, ``chromatic`` and
   ``members``; the JSON line ``chromatic_4k_it_per_s``.
19. the six example programs (``examples_phase``,
   ``pyxu_tpu_torch/examples/``) at their default sizes on the card, each
   timed on the host clock with its printout (``[example]`` lines) and
   its launches: deconvolution 256x256 (CondatVu on the fused TV kernel,
   ``tv_step`` launched, the reconstruction's error below the blurred
   one's), tomography 96x96 / 24 views by RadonTransform (the stencil
   kernel) and by FourierRadon (also the 2-D spread and interp), radio
   interferometry 128x128 / 3000 visibilities (spread and interp),
   out-of-core 1024x768 (4 bands of the overlapped blur, then 20
   StreamedCondatVu iterations of 4 band steps: 484 stencil launches,
   asserted), the distributed program at one NCCL rank (ShardedStencil,
   consensus ADMM, the 2-D type-3 ShardedNUFFT3: stencil, spread and
   interp launched), and the notebook's code cells (``fused_path``
   "kernel", its error below 0.5); then each at the CPU tests' sizes on
   the card against the CPU, within 2e-4 of max(1, max|x|).  The kernels
   line's entries gain ``examples_launches``, the JSON line
   ``examples``.

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
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
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
ENGINE_SMALL = (64, 48)         # NLCG / ProxAdam card vs CPU
# wide-field synthesis imaging (phase 13): a 64-antenna array at latitude
# -30.7 deg tracking declination -30 deg for 8 h at 1.4 GHz, a 4 deg sky cap
T3_PIXELS, T3_ANTENNAS, T3_STEPS = 131_072, 64, 128
T3_RADIUS_M, T3_LAMBDA_M, T3_CAP_DEG = 150.0, 0.21, 4.0
T3_LAT_DEG, T3_DEC_DEG, T3_HOURS = -30.7, -30.0, 8.0
T3_NF = (1536, 1536, 60)        # the plan's fine grid at this size
T3_ITERS, T3_SOURCES, T3_LAM = 20, 200, 1e-2     # lam over K, diag(A^H A)
T3_SMALL = (2000, 16, 25)       # card vs CPU: pixels, antennas, time steps
T3_CHECK_VIS = 1024             # visibilities held against the direct sum
# Bayesian uncertainty for 4K deblurring by MYULA (phase 14): noise sigma,
# the L1 weight, the chain's lengths, run()'s stack, the Tikhonov damping
UQ_SIGMA, UQ_LAM = 0.01, 0.05
UQ_WARM, UQ_BURN, UQ_SAMPLES = 200, 500, 2000
UQ_RUN_N, UQ_RUN_THIN, UQ_SAME_BITS = 16, 8, 20
UQ_SMALL, UQ_SMALL_STEPS = (64, 48), 100
UQ_DAMP = 1e-2
# Hessian-Frobenius deconvolution (phase 15): the weight, the noise level,
# the card-vs-CPU form; the Hessian's tap sets (name, k0, c0, k1, c1);
# phase 16's operators' shape and the sparse Laplacian's side
HF_LAM, HF_SIGMA = 2e-3, 0.01
HF_SMALL, HF_SMALL_ITERS = (64, 48), 30
HESS_TAPS = (("d00", (1.0, -2.0, 1.0), 1, (1.0,), 0),
             ("d01", tuple(math.sqrt(2) * v for v in (-0.5, 0.0, 0.5)), 1,
              (-0.5, 0.0, 0.5), 1),
             ("d11", (1.0,), 0, (1.0, -2.0, 1.0), 1))
LIB_SHAPE, SPARSE_N = (96, 80), 512
# the parallel layer (phase 17): workload 5 at the JAX bench's leg
# (consensus_tiles' lam) and at 1.07 G pixels, its 64x48 form; the
# out-of-core TV frame; the sharded 3-D NUFFT and type-3 sizes
CONS_TILE, CONS_TILES, CONS_ITERS, CONS_LAM = (512, 512), 8, 1000, 0.02
GIGA_TILE, GIGA_TILES, GIGA_ITERS = (4096, 4096), 64, 50
CONS_SMALL, CONS_SMALL_ITERS = (64, 48), 100
OOC_SHAPE, OOC_BLOCK, OOC_ITERS, OOC_LAM = (16384, 16384), 2048, 3, 0.01
OVL_DEPTH, OVL_RUNS = 5, 3      # the streamed blur's halo rows, timed calls
SH3_N, SH3_M = (64, 64, 64), 2 ** 18
T3S_M, T3S_K, T3S_MB = 100_000, 100_000, 1.0
# the stencil kernel with a tap set a member (phase 2) and the chromatic
# deblurring path (phase 18): a simple lens whose blur differs by colour
# channel (Heide et al., "High-quality computational imaging through simple
# lenses", ACM TOG 32(5), 2013), a 9-tap Gaussian of each sigma a channel;
# the point sources' density, the L1 weight, the noise, the card-vs-CPU
# form; the per-member kernel's second shape, 8 members of 512x512
CHROMA_SIGMAS = (1.2, 1.6, 2.0)
CHROMA_DENSITY, CHROMA_LAM, CHROMA_NOISE = 0.01, 0.01, 0.01
CHROMA_SMALL, CHROMA_SMALL_ITERS = (64, 48), 100
MEMBERS_SMALL, MEMBERS_SMALL_SIGMAS = (8, 512, 512), (1.0, 1.2, 1.4, 1.6,
                                                      1.8, 2.0, 2.2, 2.4)
# the example programs (phase 19): card vs CPU at the CPU tests' sizes,
# within the f32 conformance tolerance of max(1, max|x|)
EX_TOL = 2e-4
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


def _conv2d_ms(st, x, p):
    """One ``conv2d`` call (cuDNN, TF32 off) of the constant-mode apply of
    taps ``p``: its ms and its max difference to the kernel."""
    assert not torch.backends.cudnn.allow_tf32
    w = torch.outer(torch.tensor(p.k0), torch.tensor(p.k1)).to(x)[None, None]
    x4 = x[None, None]
    pad = (max(p.c0, len(p.k0) - 1 - p.c0), max(p.c1, len(p.k1) - 1 - p.c1))

    def lib_call():
        return torch.nn.functional.conv2d(x4, w, padding=pad)
    H, W = x.shape
    r0, r1 = pad[0] - p.c0, pad[1] - p.c1
    got = lib_call()[0, 0, r0:r0 + H, r1:r1 + W]
    err = float((got - st.separable_correlate2d(
        x, st.SepTaps(p.k0, p.c0, p.k1, p.c1, "constant"))).abs().max())
    return _time_ms(lib_call), err


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
    library_ms, err = _conv2d_ms(st, x, p)
    print(f"[kernel] stencil conv2d library_ms={library_ms:.4f} "
          f"(max_abs_diff to the kernel {err:.3e})", flush=True)
    return out, out64, sweep, library_ms


def hessian_taps_phase(st, x):
    """The stencil kernel at the Hessian's three tap sets (``HESS_TAPS``)
    against its plain version, apply and adjoint in both modes, f32 and
    f64 at the frame's shape, and one ``conv2d`` at each set."""
    out = {}
    for name, k0, c0, k1, c1 in HESS_TAPS:
        p = st.SepTaps(k0, c0, k1, c1)
        rec = {"f32": _st_variants(st, p, x, f" hessian {name}"),
               "f64": _st_variants(st, p, x.double(), f" hessian {name} f64")}
        rec["bound_ms"], rec["bound_by"] = _st_bound(x.shape, p,
                                                     x.element_size())
        rec["library_ms"], err = _conv2d_ms(st, x, p)
        print(f"[kernel] stencil hessian {name} conv2d library_ms="
              f"{rec['library_ms']:.4f} (max_abs_diff to the kernel "
              f"{err:.3e})", flush=True)
        out[name] = rec
    return out


def _gauss9(sigma):
    """The 9-tap Gaussian of ``sigma``, normalised, in float32."""
    import numpy as np
    k = np.exp(-0.5 * ((np.arange(9) - 4) / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _member_taps(st, sigmas, mode):
    return st.MemberTaps([st.SepTaps(tuple(map(float, _gauss9(s))), 4,
                                     tuple(map(float, _gauss9(s))), 4, mode)
                          for s in sigmas])


def members_phase(st):
    """The stencil kernel with a tap set a member against its plain
    version (apply and adjoint, both modes; f32 within 1e-5 max|x| and f64
    within 1e-12 max|x|, the taps' sums being 1) at 8x512x512 (8 sigmas)
    and 3x2160x3840 (the chromatic path's 3 sigmas), 9 taps: the kernel's
    and the plain version's ms in f32, the single-tap-set launch's ms on
    the same batch, the byte bound, and one grouped ``conv2d`` of the
    constant-mode apply (cuDNN, TF32 off).  Returns a record per shape."""
    assert not torch.backends.cudnn.allow_tf32
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for shape, sigmas in ((MEMBERS_SMALL, MEMBERS_SMALL_SIGMAS),
                          ((len(CHROMA_SIGMAS),) + SHAPE, CHROMA_SIGMAS)):
        tag = "x".join(map(str, shape))
        x32 = torch.rand(shape, generator=gen, device="cuda")
        rec = {}
        for x in (x32, x32.double()):
            f64 = x.dtype == torch.float64
            tol = (1e-12 if f64 else 1e-5) * float(x.abs().max())
            for mode in ("constant", "symmetric"):
                mt = _member_taps(st, sigmas, mode)
                for adj in (False, True):
                    name = f"{mode}{'-adjoint' if adj else ''}"

                    def kern(mt=mt, adj=adj, x=x):
                        return st.separable_correlate2d_members(x, mt, adj)

                    def plain(mt=mt, adj=adj, x=x):
                        return st.separable_correlate2d_members_plain(
                            x, mt, adj)
                    err = float((kern() - plain()).abs().max())
                    torch.cuda.synchronize()
                    ok = err <= tol
                    print(f"[kernel] stencil members {tag}"
                          f"{' f64' if f64 else ''}[{name}] max_abs_err="
                          f"{err:.3e} tol {tol:.3e}: "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise SystemExit(f"stencil members {tag}[{name}] "
                                         "disagrees with its plain version")
                    if f64:
                        rec[f"f64 {name}"] = dict(max_abs_err=err)
                        continue
                    p0 = mt.taps[0]
                    rec[name] = r = dict(
                        max_abs_err=err, ms=_time_ms(kern),
                        plain_ms=_time_ms(plain, reps=5),
                        single_ms=_time_ms(
                            lambda p0=p0, adj=adj: st.separable_correlate2d(
                                x, p0, adj)))
                    print(f"[kernel] stencil members {tag}[{name}] ms="
                          f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                          f"single-tap-set launch on the batch "
                          f"{r['single_ms']:.4f} ms", flush=True)
        elem = x32.element_size()
        t_b = 2 * x32.numel() * elem / HBM_BYTES_PER_S
        t_o = 2 * 18 * x32.numel() / F32_FLOPS_PER_S
        rec["bound_ms"] = max(t_b, t_o) * 1e3
        rec["bound_by"] = "bytes" if t_b >= t_o else "operations"
        # grouped conv2d: one group a member, the constant-mode apply
        w = torch.stack([torch.outer(torch.from_numpy(_gauss9(s)),
                                     torch.from_numpy(_gauss9(s)))
                         for s in sigmas]).to(x32)[:, None]
        x4 = x32[None]

        def lib_call():
            return torch.nn.functional.conv2d(x4, w, padding=4,
                                              groups=len(sigmas))
        diff = float((lib_call()[0] - st.separable_correlate2d_members(
            x32, _member_taps(st, sigmas, "constant"))).abs().max())
        rec["library_ms"] = _time_ms(lib_call)
        print(f"[kernel] stencil members {tag}: bound_ms="
              f"{rec['bound_ms']:.4f} ({rec['bound_by']}); grouped conv2d "
              f"library_ms={rec['library_ms']:.4f} (max_abs_diff to the "
              f"kernel {diff:.3e})", flush=True)
        out[tag] = rec
        del x32, x4
    return out


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
    ``n_grid`` cells of the grid written or read once (phase 13 counts an
    interp's as the cells its points reach), or M (w^d complex-by-real
    multiply-adds and their weight products, 5 operations a tap, plus d w
    ES evaluations of 8 operations), whichever is larger."""
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


def _profiled_device_ms(fn, n):
    """Device time of one ``fn()`` (ms) from ``torch.profiler``: the kernels'
    self device time over ``n`` calls, divided by ``n``; None where the
    profiler records no device time.  For a step that reads the host (the
    line search), whose device idles while the host waits, so that CUDA
    events around back-to-back calls would time the host too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # the kernels' own events only: an operator's event on the host
    # carries its kernels' time too
    us = sum(getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0)
             for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n if us > 0 else None


def _last_iteration(slv):
    return int(slv.stats()[1]["iteration"][-1])


def _timed_fit(slv, want, **kw):
    """Host seconds of ``slv.fit(**kw)`` ending in a synchronize; the fit
    must have run ``want`` iterations (read from its history: a segment
    that raised would keep its last good state and stop short)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slv.fit(**kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert _last_iteration(slv) == want, (_last_iteration(slv), want)
    return dt


def engine_phase(ft, st):
    """Phase 12: the rest of the solver engine and NLCG / ProxAdam at full
    width (see the module docstring)."""
    import tempfile

    from pyxu_tpu_torch.abc import Mode
    from pyxu_tpu_torch.math.linesearch import backtracking_linesearch
    from pyxu_tpu_torch.models import (lasso_deconvolution, sparse_view_ct,
                                       tv_deconvolution)
    from pyxu_tpu_torch.operator.func import SquaredL2Norm
    from pyxu_tpu_torch.opt.solver import NLCG, PGD, ProxAdam
    from pyxu_tpu_torch.opt.stop import ManualStop, MaxIter, RelError
    from pyxu_tpu_torch.runtime import host_read
    dev, shape, ct_shape, small = "cuda", SHAPE, CT_SHAPE, ENGINE_SMALL
    counters = [ft.tv_step, ft.tv_stepk, st.separable_correlate2d]
    out = {}

    def assert_launches(got, want):
        assert got == want, (got, want)

    def launches():
        return {"tv_step": ft.tv_step.launches,
                "tv_stepk": ft.tv_stepk.launches,
                "stencil": st.separable_correlate2d.launches}

    # ---- TV 4K under a precision schedule ------------------------------
    sched = [(torch.bfloat16, 200), (torch.float32, None)]
    iters, rate = PATH_ITERS, STOP_RATE
    slv, fit, _ = tv_deconvolution(shape, device=dev, stop_rate=rate)
    slv.fit(stop_crit=MaxIter(rate), max_iter=rate, **fit)          # warm
    slv.fit(stop_crit=MaxIter(2 * rate), max_iter=2 * rate,
            precision_schedule=[(torch.bfloat16, rate),
                                (torch.float32, None)], **fit)      # warm
    dt32 = _timed_fit(slv, iters, stop_crit=MaxIter(iters), max_iter=iters,
                      **fit)
    obj32 = float(slv.objective_func(slv._mstate))
    _reset(counters)
    dts = _timed_fit(slv, iters - sched[0][1], stop_crit=MaxIter(iters),
                     max_iter=iters, precision_schedule=sched, **fit)
    sched_launches = launches()
    assert_launches(sched_launches, {"tv_step": iters, "tv_stepk": 0,
                                     "stencil": 0})
    paths = [p["fused_path"] for p in slv.phase_log]
    assert paths == ["kernel", "kernel"], paths
    assert [p["iterations"] for p in slv.phase_log] == [200, 100]
    xs = slv.solution()
    assert xs.dtype == torch.float32 and bool(xs.isfinite().all())
    objs = float(slv.objective_func(slv._mstate))
    rel = abs(objs - obj32) / abs(obj32)
    assert rel < 1e-2, (objs, obj32)
    # the same two phases as two fits, each timed: the bf16 phase stores x
    # and z in bf16, and the two fits give the schedule's bits
    d16 = _timed_fit(slv, 200, stop_crit=MaxIter(200), max_iter=200,
                     precision_schedule=[sched[0]], **fit)
    assert slv._mstate["x"].dtype == slv._mstate["z"].dtype == torch.bfloat16
    d32 = _timed_fit(slv, 100, stop_crit=MaxIter(100), max_iter=100,
                     warm_start=True,
                     precision_schedule=[(torch.float32, None)])
    assert torch.equal(slv.solution(), xs)
    # the phases' rates compared: warm fits of equal length, the state cast
    # outside the window, in the order bf16, f32, f32, bf16
    n_ph = 100
    ph = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for dtype in (torch.bfloat16, torch.float32, torch.float32,
                  torch.bfloat16):
        slv._mstate = {k: v.to(dtype) if (isinstance(v, torch.Tensor)
                                          and v.ndim and v.is_floating_point())
                       else v for k, v in slv._mstate.items()}
        torch.cuda.synchronize()
        ph[dtype] += _timed_fit(slv, n_ph, stop_crit=MaxIter(n_ph),
                                max_iter=n_ph, warm_start=True,
                                precision_schedule=[(dtype, None)])
        assert slv.fused_path == "kernel"
    # and the kernel alone on each storage (CUDA events, as the kernel table)
    fz = slv._fused
    H, W = shape
    tv_ms = {}
    for dtype, nb in ((torch.float32, 4), (torch.bfloat16, 2)):
        xk = slv._mstate["x"].to(dtype).contiguous()
        zk = slv._mstate["z"].to(dtype).contiguous()
        ms = _time_ms(lambda: ft.tv_step(xk, zk, fz.b, fz.params))
        # x and z read and written once, b read once
        tv_ms[str(dtype).replace("torch.", "")] = {
            "ms": ms, "bound_ms": H * W * (4 + 6 * nb) / HBM_BYTES_PER_S * 1e3}
    out["tv_schedule"] = {"it_per_s": iters / dts,
                          "bf16_phase_it_per_s": 200 / d16,
                          "f32_phase_it_per_s": 100 / d32,
                          "warm_bf16_it_per_s": 2 * n_ph / ph[torch.bfloat16],
                          "warm_f32_it_per_s": 2 * n_ph / ph[torch.float32],
                          "tv_step": tv_ms,
                          "f32_solve_it_per_s": iters / dt32,
                          "objective_rel_to_f32": rel}
    print(f"[engine] TV {shape[0]}x{shape[1]} schedule bf16 x200 + f32 x100:"
          f" {iters / dts:.2f} it/s (bf16 phase {200 / d16:.2f} it/s, f32 "
          f"phase {100 / d32:.2f} it/s; the f32 solve {iters / dt32:.2f} "
          f"it/s); fused_path {paths}; launches {sched_launches}; objective "
          f"{objs:.6e} against f32 {obj32:.6e} (rel {rel:.3e}, limit 1e-2)",
          flush=True)
    print(f"[engine] TV {shape[0]}x{shape[1]} warm fits of {n_ph}, cast "
          f"outside the window (bf16, f32, f32, bf16): bf16 "
          f"{2 * n_ph / ph[torch.bfloat16]:.2f} it/s, f32 "
          f"{2 * n_ph / ph[torch.float32]:.2f} it/s; tv_step on x and z in "
          + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f})"
                      for k, v in tv_ms.items()), flush=True)
    del slv, fit, xs, fz, xk, zk

    # ---- LASSO 4K sessions ---------------------------------------------
    rate = iters // 6          # blocks that divide the 150 + 150 split
    slv, fit, ex = lasso_deconvolution(shape, device=dev, stop_rate=rate)
    slv.fit(stop_crit=MaxIter(rate), max_iter=rate, **fit)          # warm
    _reset(counters)
    n0 = host_read.count
    dt_cold = _timed_fit(slv, iters,
                         stop_crit=RelError(0.0) | MaxIter(iters),
                         max_iter=iters, **fit)
    reads = host_read.count - n0
    # a block's stop flag is read once, but MaxIter decides the last
    # block on the host
    assert reads == iters // rate - 1, reads
    assert_launches(launches(), {"tv_step": 0, "tv_stepk": 0,
                                 "stencil": 2 * iters})
    cold = slv.solution().clone()
    _timed_fit(slv, iters // 2, stop_crit=MaxIter(iters // 2),
               max_iter=iters // 2, **fit)
    dt_warm = _timed_fit(slv, iters // 2, stop_crit=MaxIter(iters // 2),
                         max_iter=iters // 2, warm_start=True)
    assert torch.equal(slv.solution(), cold)
    other, fit1, _ = lasso_deconvolution(shape, seed=1, device=dev,
                                         stop_rate=rate)
    other.fit(stop_crit=MaxIter(iters), max_iter=iters, **fit1)
    slv.update_operands(f=other._f)
    _timed_fit(slv, iters, stop_crit=MaxIter(iters), max_iter=iters, **fit)
    assert torch.equal(slv.solution(), other.solution())
    dt_obj = _timed_fit(slv, iters, stop_crit=MaxIter(iters),
                        max_iter=iters, track_objective=True, **fit)
    last = float(slv.stats()[1]["objective"][-1])
    want = float(slv.objective_func(slv._mstate))
    assert abs(last - want) <= 1e-6 * abs(want), (last, want)
    ckpt = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("npz", "torch"):
            s = PGD(f=slv._f, g=slv._g, stop_rate=rate, writeback_rate=rate,
                    folder=os.path.join(tmp, backend),
                    checkpoint_backend=backend)
            dtb = _timed_fit(s, iters, stop_crit=MaxIter(iters),
                             max_iter=iters, **fit)
            mstate, hist = PGD.read_checkpoint(os.path.join(tmp, backend))
            got = torch.as_tensor(mstate["x"]).to(s.solution().device)
            assert torch.equal(got, s.solution()), backend
            assert list(hist["iteration"]) == list(range(rate, iters + 1,
                                                         rate))
            ckpt[backend] = iters / dtb
    del other, fit1
    # no bf16 in the stencil kernel and no fallback: the schedule raises
    try:
        slv.fit(stop_crit=MaxIter(iters), max_iter=iters,
                precision_schedule=[(torch.bfloat16, rate),
                                    (torch.float32, None)], **fit)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError("a bf16 phase ran on the stencil path")
    assert "float32 or float64" in refused and slv.phase_log == [], refused
    print(f"[engine] LASSO {shape[0]}x{shape[1]} schedule with a bf16 phase "
          f"raises: {refused}", flush=True)
    out["lasso_sessions"] = {
        "it_per_s": iters / dt_cold, "warm_it_per_s": (iters // 2) / dt_warm,
        "track_objective_it_per_s": iters / dt_obj,
        "writeback_it_per_s": ckpt, "host_reads": reads}
    print(f"[engine] LASSO {shape[0]}x{shape[1]}: {iters / dt_cold:.2f} it/s "
          f"with RelError | MaxIter ({reads} host reads, "
          f"{iters // rate} blocks); 150 + 150 warm-started = 300 cold "
          f"(same bits); update_operands = a fresh solve on seed 1 (same "
          f"bits); track_objective {iters / dt_obj:.2f} it/s; writeback "
          f"every {rate} iterations: "
          + ", ".join(f"{b} {v:.2f} it/s" for b, v in ckpt.items())
          + "; read_checkpoint gives the same bits", flush=True)

    # ---- NLCG and ProxAdam at full width, their small forms card vs CPU --
    K, y = ex["K"], ex["y"]
    lam = 1e-2

    def tikhonov(K, y):
        return (0.5 * SquaredL2Norm(K.dim_shape).asloss(y) * K
                + 0.5 * lam * SquaredL2Norm(K.dim_shape))
    f = tikhonov(K, y)
    nit, nrate = 30, 10
    f.apply(y), f.grad(y)       # fills the constant-gradient cache
    _reset(counters)
    f.apply(y)
    per_apply = launches()["stencil"]
    f.grad(y)
    per_grad = launches()["stencil"] - per_apply
    nl = NLCG(f, stop_rate=nrate)
    nl.fit(x0=torch.zeros_like(y), stop_crit=MaxIter(nrate), max_iter=nrate)
    _reset(counters)
    t0, r0 = backtracking_linesearch.trials, host_read.count
    dt_nl = _timed_fit(nl, nit, x0=torch.zeros_like(y),
                       stop_crit=MaxIter(nit), max_iter=nit)
    trials = backtracking_linesearch.trials - t0
    reads = host_read.count - r0
    n_st = launches()["stencil"]
    # a step: f.apply at x, at the first trial point and at each further
    # trial, f.grad at the new point; m_init takes one gradient
    assert_launches(n_st, per_apply * (2 * nit + trials)
                    + per_grad * (nit + 1))
    obj0 = float(nl.objective_func({"x": torch.zeros_like(y)}))
    obj = float(nl.objective_func(nl._mstate))
    assert obj < obj0 and bool(nl.solution().isfinite().all())
    host_ms = 1e3 * dt_nl / nit
    state = dict(nl._mstate)
    dev_ms = _profiled_device_ms(lambda: nl.m_step(state), 5)
    out["nlcg"] = {"it_per_s": nit / dt_nl, "host_ms": host_ms,
                   "device_ms": dev_ms, "stencil_per_it": n_st / nit,
                   "trials_per_it": trials / nit, "reads_per_it": reads / nit}
    print(f"[engine] NLCG {shape[0]}x{shape[1]} Tikhonov (lam {lam}): "
          f"{nit / dt_nl:.2f} it/s; host {host_ms:.4f} ms an iteration, "
          f"device {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
          f" (torch.profiler); stencil launches {n_st / nit:.2f} an "
          f"iteration; line-search trials {trials / nit:.2f} an iteration; "
          f"host reads {reads / nit:.2f} an iteration; objective {obj0:.6e}"
          f" -> {obj:.6e}", flush=True)
    g = slv._g
    _reset(counters)
    slv._f.grad(y)
    per_grad_lasso = launches()["stencil"]      # K^T K x; K^T y is cached
    pa = ProxAdam(slv._f, g, stop_rate=nrate)
    pa.fit(x0=torch.zeros_like(y), variant="adam", inner_iter=10,
           stop_crit=MaxIter(nrate), max_iter=nrate)
    _reset(counters)
    dt_pa = _timed_fit(pa, nit, x0=torch.zeros_like(y), variant="adam",
                       inner_iter=10, stop_crit=MaxIter(nit), max_iter=nit)
    n_st = launches()["stencil"]
    assert_launches(n_st, per_grad_lasso * nit)
    assert bool(pa.solution().isfinite().all())
    state = dict(pa._mstate)
    pa_ms = _time_ms(lambda: pa.m_step(state), reps=10)
    out["prox_adam"] = {"it_per_s": nit / dt_pa, "device_ms": pa_ms,
                        "host_ms": 1e3 * dt_pa / nit,
                        "stencil_per_it": n_st / nit}
    print(f"[engine] ProxAdam (adam, inner_iter 10) {shape[0]}x{shape[1]} "
          f"LASSO: {nit / dt_pa:.2f} it/s; host {1e3 * dt_pa / nit:.4f} ms an"
          f" iteration, device {pa_ms:.4f} ms; "
          f"stencil launches {n_st / nit:.2f} an iteration", flush=True)
    del nl, pa, state, slv, fit, ex, K, y, f, g
    diffs, nnz = {}, {}
    for name in ("nlcg", "prox_adam"):
        sols = {}
        for d in (dev, "cpu"):
            # lam 1e-3: at this size a larger weight keeps x at 0
            s, _, e = lasso_deconvolution(small, lam=1e-3, device=d)
            if name == "nlcg":
                s = NLCG(tikhonov(e["K"], e["y"]))
                s.fit(x0=torch.zeros_like(e["y"]), stop_crit=MaxIter(nit),
                      max_iter=nit)
            else:
                s = ProxAdam(s._f, s._g)
                s.fit(x0=torch.zeros_like(e["y"]), variant="adam",
                      stop_crit=MaxIter(nit), max_iter=nit)
            sols[d] = s.solution().cpu()
        diffs[name] = float((sols[dev] - sols["cpu"]).abs().max())
        nnz[name] = int((sols["cpu"] != 0).sum())
        assert diffs[name] <= 2e-4, (name, diffs[name])
    print(f"[engine] {small[0]}x{small[1]}, {nit} iterations card vs CPU: "
          f"NLCG max_abs_diff={diffs['nlcg']:.3e}, ProxAdam "
          f"{diffs['prox_adam']:.3e} (atol 2e-4); nonzeros {nnz}",
          flush=True)
    out["small_card_vs_cpu"] = diffs
    # the line search's backtracking branch: a0 = 10/L has to shrink; a
    # batch of two points, then NLCG from that a0, card against CPU
    bt = {}
    for d in (dev, "cpu"):
        _, _, e = lasso_deconvolution(small, lam=1e-3, device=d)
        fs = tikhonov(e["K"], e["y"])
        a0 = 10.0 / float(fs.diff_lipschitz)
        xb = torch.stack([torch.zeros_like(e["y"]), e["y"]])
        t0 = backtracking_linesearch.trials
        a = backtracking_linesearch(fs, xb, -fs.grad(xb), a0=a0)
        t1 = backtracking_linesearch.trials
        s = NLCG(fs)
        s.fit(x0=torch.zeros_like(e["y"]), a0=a0, stop_crit=MaxIter(nit),
              max_iter=nit)
        bt[d] = (a.cpu(), t1 - t0, backtracking_linesearch.trials - t1,
                 s.solution().cpu())
    (a_d, t_d, n_d, x_d), (a_c, t_c, n_c, x_c) = bt[dev], bt["cpu"]
    assert t_d == t_c > 0 and n_d == n_c > 0, (t_d, t_c, n_d, n_c)
    assert torch.equal(a_d, a_c), (a_d, a_c)
    bt_diff = float((x_d - x_c).abs().max())
    assert bt_diff <= 2e-4, bt_diff
    out["backtracking"] = {"trials_batch": t_d, "trials_nlcg": n_d,
                           "max_abs_diff": bt_diff}
    print(f"[engine] {small[0]}x{small[1]} a0 = 10/L: line search on a batch"
          f" of 2, {t_d} trials, steps x L "
          f"{[float(v) * 10.0 / a0 for v in a_d]} equal on card and CPU; NLCG {nit} iterations {n_d} trials on "
          f"both, max_abs_diff={bt_diff:.3e} (atol 2e-4)", flush=True)

    # ---- CT 512^2: ASYNC with ManualStop, MANUAL against BLOCK ----------
    crate = 20
    slv, fit, _ = sparse_view_ct(ct_shape, n_angles=CT_ANGLES,
                                 method="fourier", device=dev, stop_rate=crate)
    slv.fit(stop_crit=MaxIter(crate), max_iter=crate, **fit)        # warm
    torch.cuda.synchronize()
    _reset(counters)
    slv.fit(stop_crit=ManualStop(), max_iter=10 ** 7, segment_size=crate,
            mode=Mode.ASYNC, **fit)
    time.sleep(0.5)
    assert slv.busy()
    slv.stop()
    torch.cuda.synchronize()
    assert not slv.busy() and not slv._astate["worker"].is_alive()
    hist = slv.stats()[1]
    k = int(hist["iteration"][-1])
    assert k > 0 and all(int(v) % crate == 0 for v in hist["iteration"])
    async_launches = launches()
    assert_launches(async_launches, {"tv_step": 0, "tv_stepk": 0,
                                     "stencil": 4 * k})
    xa = slv.solution()
    assert bool(xa.isfinite().all()) and float(xa.min()) >= 0
    del slv, fit, xa
    slv, fit, _ = sparse_view_ct(ct_shape, n_angles=CT_ANGLES,
                                 method="fourier", device=dev, stop_rate=1)
    slv.fit(stop_crit=MaxIter(20), max_iter=20, **fit)
    xb = slv.solution().clone()
    steps = list(slv.fit(stop_crit=MaxIter(20), max_iter=20,
                         mode=Mode.MANUAL, **fit))
    assert len(steps) == 20 and torch.equal(slv.solution(), xb)
    out["ct_async"] = {"iterations_in_0.5_s": k}
    print(f"[engine] CT {ct_shape[0]}x{ct_shape[1]} ASYNC with ManualStop: "
          f"{k} iterations before stop() at 0.5 s (segments of {crate}; "
          f"stencil launches {async_launches['stencil']}); MANUAL x20 = "
          f"BLOCK x20 at stop_rate 1 (same bits)", flush=True)
    return out


def _sky_data(n_pix, n_ant, n_steps, seed=0):
    """The synthesis-imaging problem's data from ``seed`` (host numpy).

    Sky: ``n_pix`` pixels on a Fibonacci lattice over a ``T3_CAP_DEG`` cap
    around the phase centre, unit vectors (l, m, n).  Array: ``n_ant``
    antennas uniform in a disk at latitude ``T3_LAT_DEG`` whose radius,
    ``T3_RADIUS_M`` at full size, scales with sqrt(n_pix / T3_PIXELS), so
    the pixels stay about Nyquist for the longest baseline.  Visibilities:
    every baseline at ``n_steps`` hour angles over ``T3_HOURS`` tracking
    declination ``T3_DEC_DEG``, uvw in wavelengths (Thompson, Moran and
    Swenson, eq. 4.1), returned as z = 2 pi uvw.  ``T3_SOURCES`` point
    sources on seeded pixels with fluxes from dN/dS ~ S^-2.5, S >= 1 (real
    sky, imaginary part 0), and unit Gaussian noise per visibility and
    part.  Returns ``(pixels, z, x_true, noise)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    i = np.arange(n_pix) + 0.5
    ct = 1.0 - (1.0 - np.cos(np.deg2rad(T3_CAP_DEG))) * i / n_pix
    st = np.sqrt(1.0 - ct * ct)
    phi = i * np.pi * (3.0 - np.sqrt(5.0))           # the golden angle
    pix = np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=1)
    radius = T3_RADIUS_M * np.sqrt(n_pix / T3_PIXELS)
    r = radius * np.sqrt(rng.uniform(0, 1, n_ant))
    a = rng.uniform(0, 2 * np.pi, n_ant)
    east, north = r * np.cos(a), r * np.sin(a)
    lat, dec = np.deg2rad(T3_LAT_DEG), np.deg2rad(T3_DEC_DEG)
    # local (east, north, up = 0) to equatorial (X, Y, Z), in wavelengths
    xyz = np.stack([-north * np.sin(lat), east, north * np.cos(lat)])
    p, q = np.triu_indices(n_ant, 1)
    L = (xyz[:, q] - xyz[:, p]) / T3_LAMBDA_M                # (3, baselines)
    H = np.linspace(-0.5, 0.5, n_steps)[:, None] * T3_HOURS * 2 * np.pi / 24
    sd, cd = np.sin(dec), np.cos(dec)
    u = np.sin(H) * L[0] + np.cos(H) * L[1]
    v = -sd * np.cos(H) * L[0] + sd * np.sin(H) * L[1] + cd * L[2]
    w = cd * np.cos(H) * L[0] - cd * np.sin(H) * L[1] + sd * L[2]
    z = 2 * np.pi * np.stack([u.ravel(), v.ravel(), w.ravel()], axis=1)
    xt = np.zeros((n_pix, 2))
    src = rng.choice(n_pix, T3_SOURCES, replace=False)
    xt[src, 0] = (1.0 - rng.uniform(0, 1, T3_SOURCES)) ** (-1 / 1.5)
    noise = rng.standard_normal((z.shape[0], 2))
    return pix, z, xt, noise


def _sky_problem(pix, z, xt, noise, device, dtype=torch.float32, span=None):
    """Wide-field synthesis imaging through the public API: ``A =
    NUFFT.type3(pixels, z, isign=-1, eps=1e-6)``, ``Q = A.gram() + lam K
    I`` (A^H A's diagonal is K), ``y = A x_true`` plus 1% rms complex
    noise, the dirty map ``b = A^H y``; ``span(name)``: a context around
    each step (the set-up breakdown).  Returns ``(A, Q, b)``."""
    from pyxu_tpu_torch.operator.linop import IdentityOp
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    span = span or (lambda name: contextlib.nullcontext())
    with span("A = NUFFT.type3(sky, z)"):
        A = NUFFT.type3(pix, z, isign=-1, eps=1e-6, dtype=dtype,
                        device=device)
    Q = A.gram() + T3_LAM * z.shape[0] * IdentityOp(A.dim_shape)
    with span("y = A x + noise"):
        y = A.apply(torch.from_numpy(xt).to(device=device, dtype=dtype))
        scale = 0.01 * torch.sqrt(torch.mean(y * y))
        y = y + scale * torch.from_numpy(noise).to(device=device,
                                                   dtype=dtype)
    with span("b = A^H y"):
        b = A.adjoint(y)
    return A, Q, b


def _direct3(c, x, z, sel_x=None, sel_z=None, isign=-1):
    """The type-3 sums in float64 on the card: ``f_k = sum_j c_j e^{isign
    i <z_k, x_j>}`` at the frequencies ``sel_z``, or (``sel_x``) the
    adjoint's ``c_j = sum_k f_k e^{-isign i <z_k, x_j>}`` at the points
    ``sel_x``; the long sum in chunks.  Returns complex128."""
    if sel_z is not None:
        rows, cols, sign = z[sel_z], x, isign
    else:
        rows, cols, sign = x[sel_x], z, -isign
    cc = torch.view_as_complex(c.double().contiguous())
    out = torch.zeros(rows.shape[0], dtype=torch.complex128, device="cuda")
    for j in range(0, cols.shape[0], 16384):
        out += torch.exp(sign * 1j * (rows @ cols[j:j + 16384].T)) \
            @ cc[j:j + 16384]
    return out


def _rel2(got, want):
    """Relative l2 error of a (..., 2) real view against complex128."""
    g = torch.view_as_complex(got.double().contiguous())
    return float(torch.linalg.vector_norm(g - want)
                 / torch.linalg.vector_norm(want))


def t3_phase(nu, MaxIter):
    """Phase 13: wide-field synthesis imaging by CG over the 3-D type-3
    NUFFT at full size (131 072 sky pixels, 258 048 visibilities), on the
    H100's 3-D NUFFT kernels.  Returns its rates, launches and records."""
    import numpy as np
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    from pyxu_tpu_torch.opt.solver import CG
    pix, z, xt, noise = _sky_data(T3_PIXELS, T3_ANTENNAS, T3_STEPS)
    M, K = pix.shape[0], z.shape[0]
    uvw = np.abs(z).max(axis=0) / (2 * np.pi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A, Q, b = _sky_problem(pix, z, xt, noise, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    cells = int(np.prod(A._nf))
    print(f"[t3] sky: {M} pixels on a {T3_CAP_DEG} deg cap, {K} "
          f"visibilities ({T3_ANTENNAS} antennas, {T3_STEPS} steps), max "
          f"|u|, |v|, |w| {uvw[0]:.1f}, {uvw[1]:.1f}, {uvw[2]:.1f} "
          f"wavelengths; nf {A._nf}: {cells} cells, {cells * 8 / 1e9:.3f} "
          f"GB at complex64; w {A._w}, bins {A._plan_x.bins}; set-up "
          f"{setup:.4f} s", flush=True)
    assert A._nf == T3_NF and A.kernel_path == "kernel", (A._nf,
                                                          A.kernel_path)

    # ---- both 3-D kernels on this plan's two clouds, f32 and f64 ----------
    gen = torch.Generator(device="cuda").manual_seed(1)
    grid = (1,) + A._nf + (2,)
    recs = {}
    for cloud, name, p, shape in (
            ("x'", "nufft_spread3", A._plan_x, (1, M, 2)),
            ("s'", "nufft_interp3", A._plan_s, grid),
            ("s'", "nufft_spread3", A._plan_s, (1, K, 2)),
            ("x'", "nufft_interp3", A._plan_x, grid)):
        kern, plain = getattr(nu, name), getattr(nu, name + "_plain")
        a = torch.randn(shape, generator=gen, device="cuda")
        tag = f"{name}[t3 {cloud}, {'x'.join(map(str, p.nf))}, float32]"
        err = _nu_check(tag, kern, plain, a, p, torch.float32, twice=True)
        err64 = _nu_check(tag.replace("float32", "float64"), kern, plain,
                          a.double(), p.astype(torch.float64), torch.float64)
        ms = _time_ms(lambda: kern(a, p), reps=5)
        plain_ms = _time_ms(lambda: plain(a, p), reps=2, runs=3)
        # a spread writes the whole grid; an interp must read only the
        # cells its points tap (the x' cloud fills 1/8 of the grid): those
        # of nonzero weight in a spread of ones
        reach = cells
        if "interp" in name:
            ones = torch.zeros((1, p.M, 2), device="cuda")
            ones[..., 0] = 1.0
            reach = int((nu.nufft_spread3(ones, p) != 0).any(-1).sum())
            del ones
        bound_ms, bound_by = _nu_bound(p.M, reach, A._w, 4, 3)
        print(f"[kernel] {tag} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}; {reach} cells, "
              f"{reach / cells:.1%} of the grid); points {p.M}; "
              f"{_blocks(p, name)}", flush=True)
        recs[(name, cloud)] = dict(max_abs_err=err, max_abs_err_f64=err64,
                                   ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
        del a
    _mark("type-3 kernel checks")

    # ---- A against the direct sum; the dot test ----------------------------
    xd, zd = torch.from_numpy(pix).cuda(), torch.from_numpy(z).cuda()
    sel = torch.from_numpy(np.random.default_rng(7).choice(
        K, T3_CHECK_VIS, replace=False)).cuda()
    c = torch.randn((M, 2), generator=gen, device="cuda", dtype=torch.float64)
    f = torch.randn((K, 2), generator=gen, device="cuda", dtype=torch.float64)
    ref = _direct3(c, xd, zd, sel_z=sel)
    A64 = NUFFT.type3(pix, z, isign=-1, eps=1e-6, dtype=torch.float64,
                      device="cuda")
    errs = {"float32": _rel2(A.apply(c.float())[sel], ref),
            "float64": _rel2(A64.apply(c)[sel], ref)}
    dots = {}
    for dt, op in (("float32", A), ("float64", A64)):
        u, v = c.to(getattr(torch, dt)), f.to(getattr(torch, dt))
        Au, Av = op.apply(u).double(), op.adjoint(v).double()
        dots[dt] = float(((Au * v.double()).sum() - (u.double() * Av).sum())
                         .abs() / (torch.linalg.vector_norm(Au)
                                   * torch.linalg.vector_norm(v.double())))
    del A64
    print(f"[t3] A against the direct sum at {T3_CHECK_VIS} visibilities: "
          f"rel l2 {errs['float32']:.3e} (float32, tol 1e-4), "
          f"{errs['float64']:.3e} (float64 plan, tol 1e-5); dot test "
          f"|<Ax, y> - <x, A^H y>| / (|Ax| |y|) {dots['float32']:.3e} "
          f"(float32, tol 1e-5), {dots['float64']:.3e} (float64, tol 1e-12)",
          flush=True)
    assert errs["float32"] <= 1e-4 and errs["float64"] <= 1e-5, errs
    assert dots["float32"] <= 1e-5 and dots["float64"] <= 1e-12, dots

    # ---- the chunked plan against the monolithic one -----------------------
    t0 = time.perf_counter()
    C = NUFFT.type3(pix, z, isign=-1, eps=1e-6, chunked=True,
                    fft_mem_mb=256, max_blocks=16, dtype=torch.float32,
                    device="cuda")
    torch.cuda.synchronize()
    c_setup = time.perf_counter() - t0
    st = C.stats()
    largest = max(np.prod(v["n_fine"]) for v in C.params().values()) * 8e-6
    rel = float(torch.linalg.vector_norm(C.apply(c.float()) - A.apply(
        c.float())) / torch.linalg.vector_norm(A.apply(c.float())))
    print(f"[t3] chunked (fft_mem_mb 256, max_blocks 16): {st['n_x_blocks']}"
          f" x {st['n_z_blocks']} blocks, x sizes {st['x_block_sizes']}, z "
          f"sizes {st['z_block_sizes']}, largest grid {largest:.1f} MB; "
          f"set-up {c_setup:.4f} s; against the monolithic apply rel l2 "
          f"{rel:.3e} (tol 1e-4)", flush=True)
    assert rel <= 1e-4, rel
    del C

    # ---- the 2-D coplanar form (l, m; u, v) on the 2-D kernels -------------
    _reset([nu.nufft_spread2, nu.nufft_interp2])
    A2 = NUFFT.type3(pix[:, :2], z[:, :2], isign=-1, eps=1e-6,
                     dtype=torch.float32, device="cuda")
    sel_x = sel.remainder(M)
    err2 = (_rel2(A2.apply(c.float())[sel], _direct3(c, xd[:, :2], zd[:, :2],
                                                     sel_z=sel)),
            _rel2(A2.adjoint(f.float())[sel_x], _direct3(
                f, xd[:, :2], zd[:, :2], sel_x=sel_x)))
    launches_2d = {"nufft_spread2": nu.nufft_spread2.launches,
                   "nufft_interp2": nu.nufft_interp2.launches}
    print(f"[t3] 2-D coplanar form: nf {A2._nf}; against the direct sum rel "
          f"l2 {err2[0]:.3e} (apply), {err2[1]:.3e} (adjoint), tol 1e-4; "
          f"launches {launches_2d}", flush=True)
    assert A2.kernel_path == "kernel" and max(err2) <= 1e-4, err2
    assert launches_2d == {"nufft_spread2": 2, "nufft_interp2": 2}
    del A2, xd, zd
    _mark("type-3 checks")

    # ---- the timed fit -----------------------------------------------------
    counters = [nu.nufft_spread3, nu.nufft_interp3, nu.nufft_spread2,
                nu.nufft_interp2]
    slv = CG(Q, stop_rate=T3_ITERS)
    slv.fit(b=b, stop_crit=MaxIter(T3_ITERS), max_iter=T3_ITERS)     # warm
    torch.cuda.synchronize()
    _reset(counters)
    dt = _timed_fit(slv, T3_ITERS, b=b, stop_crit=MaxIter(T3_ITERS),
                    max_iter=T3_ITERS)
    launches = {k.__name__: k.launches for k in counters}
    # the gram A^H A an iteration (fw: spread at x', interp at s'; bw:
    # spread at s', interp at x') and once for the initial residual
    n = 2 * (T3_ITERS + 1)
    want = {"nufft_spread3": n, "nufft_interp3": n, "nufft_spread2": 0,
            "nufft_interp2": 0}
    assert launches == want, (launches, want)
    xs = slv.solution()
    assert xs.shape == (M, 2) and bool(torch.isfinite(xs).all())
    res0 = float(torch.sqrt(torch.sum(b * b)))
    res = float(slv.objective_func(slv._mstate))
    assert res < res0, (res, res0)
    src = np.flatnonzero(xt[:, 0])
    top = torch.topk(xs[:, 0], T3_SOURCES).indices.cpu().numpy()
    found = len(np.intersect1d(top, src)) / T3_SOURCES
    rate = T3_ITERS / dt
    print(f"[t3] CG on (A^H A + {T3_LAM} K I) x = A^H y: {T3_ITERS} "
          f"iterations in {dt:.4f} s: {rate:.2f} it/s; launches {launches} "
          f"(2 spreads and 2 interps an iteration, and the initial "
          f"residual's); residual {res0:.6e} -> {res:.6e}; the {T3_SOURCES}"
          f" brightest pixels hold {found:.1%} of the sources", flush=True)

    # ---- an iteration's device time by part --------------------------------
    state = slv._mstate
    g = torch.zeros(A._nf, dtype=torch.complex64, device="cuda")[None]
    dims = (1, 2, 3)
    with torch.no_grad():
        dev_ms = _time_ms(lambda: slv.m_step(state), reps=5)
        fft_ms = _time_ms(lambda: torch.fft.fftn(g, dim=dims), reps=5)
        ifft_ms = _time_ms(lambda: torch.fft.ifftn(g, dim=dims,
                                                   norm="forward"), reps=5)
        dx_ms = _time_ms(lambda: A._mul_dx(g), reps=5)
    del g
    kern_ms = {f"{k[0]} {k[1]}": r["ms"] for k, r in recs.items()}
    other = dev_ms - fft_ms - ifft_ms - 2 * dx_ms - sum(kern_ms.values())
    wall_ms = 1e3 * dt / T3_ITERS
    print(f"[breakdown] t3 sky: per iteration device {dev_ms:.4f} ms: FFTs "
          f"{fft_ms:.4f} + {ifft_ms:.4f} ms, pre-deconvolution 2 x "
          f"{dx_ms:.4f} ms, kernels " + ", ".join(
              f"{k} {v:.4f}" for k, v in kern_ms.items())
          + f" ms, other {other:.4f} ms; host {wall_ms:.4f} ms, device idle "
          f"{1 - dev_ms / wall_ms:.1%}", flush=True)
    del slv, A, Q, b, xs, state
    _setup_breakdown("t3 sky", lambda span: _sky_problem(
        pix, z, xt, noise, "cuda", span=span))

    # ---- the same problem scaled down, card against the CPU ----------------
    sols = {}
    small = _sky_data(*T3_SMALL)
    for dev in ("cuda", "cpu"):
        _, Qs, bs = _sky_problem(*small, dev)
        s = CG(Qs, stop_rate=T3_ITERS)
        s.fit(b=bs, stop_crit=MaxIter(T3_ITERS), max_iter=T3_ITERS)
        sols[dev] = s.solution().cpu()
    diff = float((sols["cuda"] - sols["cpu"]).abs().max())
    peak = float(sols["cpu"].abs().max())
    print(f"[t3] {T3_ITERS} iterations at {T3_SMALL[0]} pixels, "
          f"{small[1].shape[0]} visibilities, card vs CPU: max_abs_diff="
          f"{diff:.3e}, {diff / peak:.3e} of max|x| (tol 2e-4)", flush=True)
    assert diff <= 2e-4 * peak, (diff, peak)
    return dict(rate=rate, setup_s=setup, launches=launches,
                launches_2d=launches_2d, recs=recs)


def _uq_problem(shape, device):
    """The MYULA posterior of phase 14 from the public API: workload 1's
    sparse image and 9-tap sigma = 2 blur K (symmetric padding), y = K x +
    ``UQ_SIGMA`` n with n drawn from ``numpy.random.default_rng(0)`` after
    the image, f = 0.5 ||K x - y||^2 / sigma^2, g = lam ||x||_1 /
    sigma^2."""
    import numpy as np
    from pyxu_tpu_torch.models import lasso_deconvolution
    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    rng = np.random.default_rng(0)
    rng.random(shape)                       # the factory's draw of the image
    n = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    _, _, ex = lasso_deconvolution(shape, device=device)
    K = ex["K"]
    y = ex["y"] + UQ_SIGMA * n.to(device)
    f = (0.5 / UQ_SIGMA ** 2) * SquaredL2Norm(shape).asloss(y) * K
    g = (UQ_LAM / UQ_SIGMA ** 2) * L1Norm(shape)
    return f, g, K, y


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def uq_phase(st):
    """Phase 14: Bayesian uncertainty for 4K deblurring by MYULA, and
    Tikhonov deblurring by ``K.pinv`` (see the module docstring)."""
    from pyxu_tpu_torch.math.cg import CHECK_RATE
    from pyxu_tpu_torch.sampler import MYULA, OnlineMoment, OnlineStd
    H, W = SHAPE
    f, g, K, y = _uq_problem(SHAPE, "cuda")
    assert K.kernel_path == "kernel", K.kernel_path
    declared = math.isfinite(f.diff_lipschitz)
    M = MYULA(f, g)
    print(f"[uq] MYULA {H}x{W}: lamb {M.lamb:.6e}, gamma {M.gamma:.6e}; "
          f"beta_f {f.diff_lipschitz:.6e} ("
          f"{'declared: the Stencil bound' if declared else 'estimated'})",
          flush=True)
    x0 = torch.zeros(SHAPE, device="cuda")
    chain = M.samples(x0, seed=0)
    for _ in range(UQ_WARM):            # also fills the loss's gradient cache
        x = next(chain)
    torch.cuda.synchronize()
    # the timed chain: burn-in, then the samples into the statistics
    mean, std = OnlineMoment(1), OnlineStd()
    chain = M.samples(x0, seed=1)
    _reset([st.separable_correlate2d])
    steps = UQ_BURN + UQ_SAMPLES
    t0 = time.perf_counter()
    for i in range(steps):
        x = next(chain)
        if i >= UQ_BURN:
            mean.update(x)
            std.update(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = st.separable_correlate2d.launches
    assert launches == 2 * steps, (launches, 2 * steps)
    mu, sd = mean.stat(), std.stat()
    assert mu.shape == sd.shape == SHAPE
    assert bool(mu.isfinite().all()) and bool(sd.isfinite().all())
    assert bool((sd > 0).all()), float(sd.min())
    # device time of one loop iteration (a step and both updates), and of
    # the step's two stencil launches
    gen = torch.Generator(device="cuda").manual_seed(2)
    m2, s2 = OnlineMoment(1), OnlineStd()

    def body():
        xs = M._step(x, gen)
        m2.update(xs)
        s2.update(xs)
    dev_ms = _time_ms(body, reps=10)
    step_ms = _time_ms(lambda: M._step(x, gen), reps=10)
    sten_ms = sum(_time_ms(lambda adj=adj: st.separable_correlate2d(
        x, K._taps, adj)) for adj in (False, True))
    host_ms = 1e3 * dt / steps
    rate = steps / dt
    # the chain's device time: burn-in steps bare, samples with statistics
    idle = 1 - (UQ_BURN * step_ms + UQ_SAMPLES * dev_ms) / (1e3 * dt)
    print(f"[uq] timed chain: {UQ_BURN} burn-in + {UQ_SAMPLES} samples in "
          f"{dt:.4f} s: {rate:.2f} steps/s, {UQ_SAMPLES / dt:.2f} samples/s "
          f"(statistics included); stencil launches {launches} (2 a step); "
          f"device {dev_ms:.4f} ms a sample (step {step_ms:.4f}, of it the "
          f"stencil {sten_ms:.4f} ms; statistics {dev_ms - step_ms:.4f}), "
          f"host {host_ms:.4f} ms a step, device idle {idle:.1%};"
          f" posterior mean in [{float(mu.min()):.4e}, {float(mu.max()):.4e}"
          f"], std in [{float(sd.min()):.4e}, {float(sd.max()):.4e}] "
          f"(mean {float(sd.mean()):.4e})", flush=True)
    # run() against a two-pass mean and std of its stack
    _reset([st.separable_correlate2d])
    S = M.run(x0, n=UQ_RUN_N, thin=UQ_RUN_THIN, seed=3)
    n_run = st.separable_correlate2d.launches
    assert tuple(S.shape) == (UQ_RUN_N,) + SHAPE, S.shape
    assert n_run == 2 * UQ_RUN_N * UQ_RUN_THIN, n_run
    mean, std = OnlineMoment(1), OnlineStd()
    for s in S:
        mean.update(s)
        std.update(s)
    e_mean = _rel(mean.stat(), torch.mean(S, 0))
    e_std = _rel(std.stat(), torch.std(S, 0, correction=0))
    print(f"[uq] run(n={UQ_RUN_N}, thin={UQ_RUN_THIN}): online mean and std"
          f" against two passes of the stack: {e_mean:.3e}, {e_std:.3e} "
          f"relative (tol 1e-5)", flush=True)
    assert e_mean <= 1e-5 and e_std <= 1e-5, (e_mean, e_std)
    del S
    # the drift against f's gradient and g's Moreau envelope
    e_drift = _rel(M._drift(x), f.grad(x) + g.moreau_envelope(M.lamb).grad(x))
    # the same seed twice gives the same bits
    runs = []
    for _ in range(2):
        c = M.samples(x0, seed=4)
        for _ in range(UQ_SAME_BITS):
            xs = next(c)
        runs.append(xs)
    same = torch.equal(runs[0], runs[1])
    print(f"[uq] drift vs f.grad + g.moreau_envelope(lamb).grad: {e_drift:.3e}"
          f" relative (tol 1e-6); seed 4 twice, {UQ_SAME_BITS} steps: same "
          f"bits {same}", flush=True)
    assert e_drift <= 1e-6 and same, (e_drift, same)
    del runs, c, xs
    # the small problem: noise drawn on the CPU and fed to both devices
    small = {}
    for dev in ("cuda", "cpu"):
        fs, gs, _, _ = _uq_problem(UQ_SMALL, dev)
        small[dev] = MYULA(fs, gs)
    assert (small["cuda"].gamma, small["cuda"].lamb) == (
        small["cpu"].gamma, small["cpu"].lamb)
    gen = torch.Generator().manual_seed(5)
    xc = {d: torch.zeros(UQ_SMALL, device=d) for d in small}
    for _ in range(UQ_SMALL_STEPS):
        w = torch.randn(UQ_SMALL, generator=gen)
        for d, m in small.items():
            xc[d] = m._update(xc[d], w.to(d))
    diff = float((xc["cuda"].cpu() - xc["cpu"]).abs().max())
    peak = float(xc["cpu"].abs().max())
    print(f"[uq] MYULA {UQ_SMALL[0]}x{UQ_SMALL[1]}, {UQ_SMALL_STEPS} steps "
          f"card vs CPU (the CPU's noise): max_abs_diff={diff:.3e}, "
          f"{diff / peak:.3e} of max|x| (tol 2e-4)", flush=True)
    assert diff <= 2e-4 * peak, (diff, peak)
    del mean, std, m2, s2, chain, x, mu, sd

    # ---- pinv at 4K: Tikhonov deblurring ----------------------------------
    xp = K.pinv(y, damp=UQ_DAMP)                # warm
    same_dagger = torch.equal(K.dagger(UQ_DAMP).apply(y), xp)
    torch.cuda.synchronize()
    _reset([st.separable_correlate2d])
    t0 = time.perf_counter()
    xp = K.pinv(y, damp=UQ_DAMP)
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    n_p = st.separable_correlate2d.launches
    # K^T y (1), the initial residual (2), 2 an iteration; a budget above
    # CHECK_RATE stops at a check
    iters = (n_p - 3) // 2
    maxiter = min(max(2 * K.dim_size, 20), 1000)
    assert n_p == 3 + 2 * iters and iters % CHECK_RATE == 0, n_p
    assert 0 < iters < maxiter, iters
    # the solve's device time (the kernels' own, torch.profiler): CG reads
    # its flag every CHECK_RATE iterations, so events would time the host
    p_dev = _profiled_device_ms(lambda: K.pinv(y, damp=UQ_DAMP), 1)
    p_host = 1e3 * dt_p
    b = K.adjoint(y)
    res = float(torch.linalg.vector_norm(
        K.adjoint(K.apply(xp)) + UQ_DAMP * xp - b)
        / torch.linalg.vector_norm(b))
    rtol = max(100 * torch.finfo(torch.float32).eps, 1e-6)
    p_rate = iters / dt_p
    p_idle = "not measured" if p_dev is None else f"{1 - p_dev / p_host:.1%}"
    print(f"[uq] pinv {H}x{W} (damp {UQ_DAMP}): {iters} CG iterations in "
          f"{dt_p:.4f} s: {p_rate:.2f} it/s; device "
          + ("not measured" if p_dev is None else f"{p_dev:.4f} ms")
          + f" (torch.profiler), host {p_host:.4f} ms, device idle {p_idle};"
          f" stencil launches {n_p} (1 + 2 + "
          f"2 an iteration); relative normal-equation residual {res:.3e} "
          f"(tol {2 * rtol:.3e}); dagger(damp).apply gives the same bits "
          f"{same_dagger}", flush=True)
    assert res <= 2 * rtol and same_dagger, (res, same_dagger)
    sols = {}
    for dev in ("cuda", "cpu"):
        _, _, Ks, ys = _uq_problem(UQ_SMALL, dev)
        sols[dev] = Ks.pinv(ys, damp=UQ_DAMP).cpu()
    diff = float((sols["cuda"] - sols["cpu"]).abs().max())
    peak = float(sols["cpu"].abs().max())
    print(f"[uq] pinv {UQ_SMALL[0]}x{UQ_SMALL[1]} card vs CPU: max_abs_diff="
          f"{diff:.3e}, {diff / peak:.3e} of max|x| (tol 2e-4)", flush=True)
    assert diff <= 2e-4 * peak, (diff, peak)
    return dict(rate=rate, samples_per_s=UQ_SAMPLES / dt, launches=launches,
                device_ms=dev_ms, step_ms=step_ms, stencil_ms=sten_ms,
                host_ms=host_ms, idle=idle, pinv_rate=p_rate,
                pinv_launches=n_p, pinv_iters=iters, pinv_device_ms=p_dev,
                pinv_host_ms=p_host)


def _hessian_problem(shape, device):
    """The Hessian-Frobenius deconvolution of phase 15 from the public API:
    the ``peaks`` surface on [-2.5, 2.5]^2 clipped at 0 and normalised (as
    ``sparse_view_ct`` builds it), workload 1's 9-tap sigma = 2 blur K
    (symmetric padding), y = K x + ``HF_SIGMA`` n with n drawn from
    ``numpy.random.default_rng(0)``, f = 0.5 ||K x - y||^2, g the positive
    orthant, L the Hessian's three partials with the cross one scaled by
    sqrt(2), h = ``HF_LAM`` ||.||_{2,1} over L's channels.  Returns
    ``(solver, f, g, h, L, K, y)``, the solver ``CondatVu(f, g, h, L)``."""
    import numpy as np
    from pyxu_tpu_torch.operator import (Hessian, L21Norm, PositiveOrthant,
                                         SquaredL2Norm, Stencil, vstack)
    from pyxu_tpu_torch.opt.solver import CondatVu
    from pyxu_tpu_torch.utils.misc import peaks
    H, W = shape
    yy, xx = np.meshgrid(np.linspace(-2.5, 2.5, H),
                         np.linspace(-2.5, 2.5, W), indexing="ij")
    xt = torch.clamp(peaks(torch.from_numpy(xx), torch.from_numpy(yy)),
                     min=0)
    xt = (xt / xt.max()).to(device=device, dtype=torch.float32)
    n = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    k = np.exp(-0.5 * ((np.arange(9) - 4) / 2.0) ** 2)
    k = (k / k.sum()).astype(np.float32)
    K = Stencil(shape, [k, k], [4, 4], mode="symmetric")
    y = K.apply(xt) + HF_SIGMA * torch.from_numpy(n).to(device)
    f = 0.5 * SquaredL2Norm(shape).asloss(y) * K
    g = PositiveOrthant(shape)
    L = vstack([Hessian(shape, directions=(0, 0), mode="symmetric"),
                math.sqrt(2) * Hessian(shape, directions=(0, 1),
                                       mode="symmetric"),
                Hessian(shape, directions=(1, 1), mode="symmetric")])
    h = HF_LAM * L21Norm((3,) + shape, l2_axis=0)
    return CondatVu(f=f, g=g, h=h, K=L, stop_rate=STOP_RATE), f, g, h, L, K, y


def hf_phase(st, MaxIter):
    """Phase 15: 4K Hessian-Frobenius deconvolution by Condat-Vu on the
    stencil kernel (see the module docstring)."""
    from pyxu_tpu_torch.operator.linop import PartialDerivative
    slv, f, g, h, L, K, y = _hessian_problem(SHAPE, "cuda")
    parts = [PartialDerivative.finite_difference(
        SHAPE, o, scheme="central", accuracy=2, mode="symmetric")
        for o in ((2, 0), (1, 1), (0, 2))]
    assert K.kernel_path == "kernel" and all(
        q.kernel_path == "kernel" for q in parts)
    slv.fit(x0=y, stop_crit=MaxIter(STOP_RATE), max_iter=STOP_RATE)  # warm
    assert slv.fused_path is None, slv.fused_path
    _reset([st.separable_correlate2d])
    dt = _timed_fit(slv, PATH_ITERS, x0=y, stop_crit=MaxIter(PATH_ITERS),
                    max_iter=PATH_ITERS)
    launches = st.separable_correlate2d.launches
    # L (3) and L^T (3), and K^T K (2) in f's gradient, an iteration
    assert launches == 8 * PATH_ITERS, launches
    xs = slv.solution()
    assert xs.shape == SHAPE and bool(torch.isfinite(xs).all())
    assert bool((xs >= 0).all())
    obj_y = float(slv.objective_func({"x": y}))
    obj_p = float(slv.objective_func({"x": torch.clamp(y, min=0)}))
    obj = float(slv.objective_func(slv._mstate))
    assert obj < obj_p and obj < obj_y, (obj, obj_p, obj_y)
    rate = PATH_ITERS / dt
    state = slv._mstate
    with torch.no_grad():
        dev_ms = _time_ms(lambda: slv.m_step(state), reps=10)
        sten_ms = sum(_time_ms(lambda q=q, adj=adj: st.separable_correlate2d(
            xs, q, adj)) for q in [K._taps] + [p._taps for p in parts]
            for adj in (False, True))
    host_ms = 1e3 * dt / PATH_ITERS
    idle = 1 - dev_ms / host_ms
    print(f"[hf] {SHAPE[0]}x{SHAPE[1]}: {PATH_ITERS} iterations in {dt:.4f} "
          f"s: {rate:.2f} it/s; stencil launches {launches} (8 an "
          f"iteration); objective {obj:.6e} (at y {obj_y:.6e}, at max(y, 0)"
          f" {obj_p:.6e}); tau {slv._tau:.6e} sigma {slv._sigma:.6e}",
          flush=True)
    print(f"[breakdown] hf {SHAPE[0]}x{SHAPE[1]}: per iteration device "
          f"{dev_ms:.4f} ms, stencil kernel {sten_ms:.4f} ms "
          f"({sten_ms / dev_ms:.1%}), other kernels {dev_ms - sten_ms:.4f}"
          f" ms; host {host_ms:.4f} ms, device idle {idle:.1%}", flush=True)
    sols = {}
    for dev in ("cuda", "cpu"):
        s, *_, ys = _hessian_problem(HF_SMALL, dev)
        s.fit(x0=ys, stop_crit=MaxIter(HF_SMALL_ITERS),
              max_iter=HF_SMALL_ITERS)
        sols[dev] = s.solution().cpu()
    diff = float((sols["cuda"] - sols["cpu"]).abs().max())
    peak = float(sols["cpu"].abs().max())
    print(f"[hf] {HF_SMALL[0]}x{HF_SMALL[1]}, {HF_SMALL_ITERS} iterations "
          f"card vs CPU: max_abs_diff={diff:.3e}, {diff / peak:.3e} of "
          f"max|x| (tol 2e-4)", flush=True)
    assert diff <= 2e-4 * peak, (diff, peak)
    return dict(rate=rate, launches=launches, device_ms=dev_ms,
                stencil_ms=sten_ms, host_ms=host_ms, idle=idle,
                objective=obj)


def _library_ops(dev):
    """Phase 16's operators on ``dev``: (name, operator, what to check),
    the checks among apply, adjoint, prox and a Jacobian's apply and
    adjoint."""
    import numpy as np
    import pyxu_tpu_torch.operator as O
    from pyxu_tpu_torch.operator.map import ufunc
    shape = LIB_SHAPE
    rng = np.random.default_rng(9)
    field = rng.standard_normal((2,) + shape).astype(np.float32)
    field[0] += 2.0
    A, B, C = (rng.standard_normal(s).astype(np.float32)
               for s in ((12, 16), (10, 8), (10, 16)))
    lin = ("apply", "adjoint")
    ops = [
        ("SubSample", O.SubSample(shape, slice(1, None, 3),
                                  [0, 5, 5, 7, 79]), lin),
        ("Trim", O.Trim(shape, ((2, 3), (1, 4))), lin),
        ("Sum", O.Sum(shape, axis=0), lin),
        ("kron", O.kron(O.ExplicitLinOp(A, device=dev),
                        O.ExplicitLinOp(B, device=dev)), lin),
        ("khatri_rao", O.khatri_rao(O.ExplicitLinOp(A, device=dev),
                                    O.ExplicitLinOp(C, device=dev)), lin),
        ("stack", O.stack([O.Laplacian(shape),
                           O.Gaussian(shape, sigma=1.5, mode="symmetric")]),
         lin),
        ("hstack", O.hstack([O.Divergence((2,) + shape, mode="symmetric"),
                             O.Gradient(shape).T]), lin),
        ("block_diag", O.block_diag([O.Laplacian(shape),
                                     O.Sobel(shape, axis=0)]), lin),
        ("block_diag[funcs]", O.block_diag([O.L1Norm(shape),
                                            O.SquaredL2Norm(shape)]),
         ("apply", "prox")),
        ("coo_block", O.coo_block(
            {(0, 0): O.Laplacian(shape, mode="symmetric"),
             (1, 1): O.ExplicitLinOp(A[:7], device=dev),
             (1, 0): O.SubSample(shape, list(range(7)), 0)}, (2, 2)), lin),
        ("Jacobian", O.Jacobian((2,) + shape, mode="symmetric"), lin),
        ("Divergence", O.Divergence((2,) + shape, mode="symmetric"), lin),
        ("Laplacian", O.Laplacian(shape, mode="constant"), lin),
        ("DirectionalDerivative[1]", O.DirectionalDerivative(
            shape, 1, field, mode="symmetric", device=dev), lin),
        ("DirectionalDerivative[2]", O.DirectionalDerivative(
            shape, 2, (field, field[::-1].copy()), device=dev), lin),
        ("DirectionalGradient", O.DirectionalGradient(
            shape, [field, (1.0, 0.0)], mode="symmetric", device=dev), lin),
        ("DirectionalLaplacian", O.DirectionalLaplacian(
            shape, [field, (1.0, 1.0)], weights=[0.5, 2.0], device=dev), lin),
        ("DirectionalHessian", O.DirectionalHessian(
            shape, [field, (0.0, 1.0)], mode="symmetric", device=dev), lin),
        ("Gradient[gd]", O.Gradient(shape, diff_method="gd", sigma=1.0,
                                    mode="symmetric"), lin),
        ("Sobel[axis=None]", O.Sobel(shape, mode="symmetric"),
         ("apply", "jacobian")),
        ("StructureTensor", O.StructureTensor(shape, mode="symmetric"),
         ("apply", "jacobian")),
    ]
    extra = {"LeakyReLU": (0.1,), "Clip": (-0.5, 0.7)}
    for name in ("Sin", "Cos", "Tan", "ArcSin", "ArcCos", "ArcTan", "Sinh",
                 "Cosh", "Tanh", "ArcSinh", "ArcCosh", "ArcTanh", "Exp",
                 "Log", "Sqrt", "Cbrt", "Square", "Gaussian", "Sigmoid",
                 "SoftPlus", "SiLU", "SoftMax", "Abs", "Sign", "ReLU",
                 "LeakyReLU", "Clip"):
        op = getattr(ufunc, name)(shape, *extra.get(name, ()))
        diff = name not in ("Abs", "Sign", "ReLU", "LeakyReLU", "Clip")
        ops.append((name, op, ("apply", "jacobian") if diff else ("apply",)))
    return ops


def _ufunc_domain(name, x):
    """``x`` moved into the domain of the map ``name``."""
    if name in ("Log", "Sqrt", "Cbrt"):
        return x.abs() + 0.2
    if name == "ArcCosh":
        return x.abs() + 1.2
    if name in ("ArcSin", "ArcCos", "ArcTanh", "Tan"):
        return 0.3 * x.clamp(-1.5, 1.5)
    return x


def library_phase(st):
    """Phase 16: each new operator on the card against the CPU, then
    SparseExplicitLinOp against the dense Laplacian (see the module
    docstring)."""
    import numpy as np
    import scipy.sparse as sp
    from pyxu_tpu_torch.operator import Laplacian, SparseExplicitLinOp
    gen = torch.Generator().manual_seed(10)
    worst = 0.0
    pairs = list(zip(_library_ops("cuda"), _library_ops("cpu")))
    for (name, op_c, checks), (_, op_h, _) in pairs:
        x = _ufunc_domain(name, torch.randn((2,) + op_h.dim_shape,
                                            generator=gen))
        w = torch.randn((2,) + op_h.codim_shape, generator=gen)
        v = torch.randn(op_h.dim_shape, generator=gen)
        u = torch.randn(op_h.codim_shape, generator=gen)
        runs = {"apply": lambda op, d: op.apply(x.to(d)),
                "adjoint": lambda op, d: op.adjoint(w.to(d)),
                "prox": lambda op, d: op.prox(x.to(d), 0.3),
                "jacobian": lambda op, d: torch.cat([
                    op.jacobian(x[0].to(d)).apply(v.to(d)).reshape(-1),
                    op.jacobian(x[0].to(d)).adjoint(u.to(d)).reshape(-1)])}
        for c in checks:
            got, want = runs[c](op_c, "cuda").cpu(), runs[c](op_h, "cpu")
            err = float((got - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            worst = max(worst, err)
            if err > 2e-4:
                raise SystemExit(f"[lib] {name}.{c} card vs CPU: {err:.3e} "
                                 "of max|y| (tol 2e-4)")
    print(f"[lib] {len(pairs)} operators card vs CPU: worst "
          f"{worst:.3e} of max(1, max|y|) (tol 2e-4)", flush=True)
    # the 5-point Laplacian of a 512^2 image as a CSR matrix
    N = SPARSE_N
    d1 = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(N, N))
    lap = (sp.kron(d1, sp.eye(N)) + sp.kron(sp.eye(N), d1)).tocsr()
    S = SparseExplicitLinOp(lap, dim_shape=(N, N), codim_shape=(N, N),
                            device="cuda")
    D = Laplacian((N, N), mode="constant")
    xg = torch.randn((N, N), generator=gen).cuda()
    errs = []
    for fs, fd in ((S.apply, D.apply), (S.adjoint, D.adjoint)):
        want = fd(xg)
        errs.append(float((fs(xg) - want).abs().max())
                    / float(want.abs().max()))
    sparse_ms = _time_ms(lambda: S.apply(xg))
    dense_ms = _time_ms(lambda: D.apply(xg))
    print(f"[lib] SparseExplicitLinOp {N}x{N} 5-point Laplacian "
          f"({lap.nnz} nonzeros) vs Laplacian(constant): apply "
          f"{errs[0]:.3e}, adjoint {errs[1]:.3e} of max|y| (tol 1e-5); "
          f"apply {sparse_ms:.4f} ms (cuSPARSE) against {dense_ms:.4f} ms "
          f"(the dense operator: 2 stencil launches and an add)",
          flush=True)
    assert max(errs) <= 1e-5, errs
    return dict(worst=worst, sparse_ms=sparse_ms, dense_ms=dense_ms,
                nnz=int(lap.nnz), sparse_err=max(errs))


def _soft(v, t):
    return torch.sign(v) * torch.clamp(v.abs() - t, min=0)


def _consensus_fits(slv, fit, iters, warm, timed, MaxIter):
    """A warm fit of ``warm`` iterations, then the best of ``timed`` timed
    fits, each ``iters`` iterations in one segment with one stop check;
    returns it/s."""
    def kw(n):
        slv._stop_rate = n
        return dict(stop_crit=MaxIter(n), max_iter=n, segment_size=n, **fit)
    slv.fit(**kw(warm))
    return iters / min(_timed_fit(slv, iters, **kw(iters))
                       for _ in range(timed))


def consensus_phase(st, nu, MaxIter):
    """Phase 17, workload 5: consensus ADMM over the NCCL mesh of one rank,
    the JAX bench's leg, the giga-pixel form and the 64x48 form card vs
    CPU (see the module docstring)."""
    from pyxu_tpu_torch.models import consensus_tiles
    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    from pyxu_tpu_torch.parallel import ConsensusADMM
    from pyxu_tpu_torch.runtime import host_read
    counters = [st.separable_correlate2d, st.separable_correlate2d_members,
                nu.nufft_spread2, nu.nufft_interp2, nu.nufft_spread3,
                nu.nufft_interp3]
    out = {}
    # the bench's leg: a warm fit and the best of two; the giga-pixel
    # form: a short warm fit and one timed fit
    for tile, n_tiles, iters, warm, timed, name in (
            (CONS_TILE, CONS_TILES, CONS_ITERS, CONS_ITERS, 2,
             "consensus_admm_8x512_1dev"),
            (GIGA_TILE, GIGA_TILES, GIGA_ITERS, 2, 1,
             "consensus_admm_64x4096_1dev")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slv, fit, ex = consensus_tiles(tile=tile, n_tiles=n_tiles,
                                       device="cuda")
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        assert slv._mesh is not None and slv._mesh.size() == 1
        # the tiles' proxes: one CG over the stacked tiles
        assert slv._fsum.batched_path == "quadratic", slv._fsum.batched_path
        _reset(counters)
        torch.cuda.reset_peak_memory_stats()
        reads0 = host_read.count
        rate = _consensus_fits(slv, fit, iters, warm, timed, MaxIter)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        reads = (host_read.count - reads0) / (warm + timed * iters)
        assert all(c.launches == 0 for c in counters), \
            [c.launches for c in counters]      # plain PyTorch passes only
        z = slv.solution()
        assert z.shape == tile and bool(torch.isfinite(z).all())
        ybar = torch.stack(ex["ys"]).mean(0)
        z_star = _soft(ybar, CONS_LAM / 2)      # the consensus LASSO's min
        gap = float((z - z_star).abs().max())
        obj0 = float(slv.objective_func({"z": fit["z0"]}))
        obj = float(slv.objective_func(slv._mstate))
        assert obj < obj0, (obj, obj0)
        state = slv._mstate
        # the tiles' CG reads its flag on the host: the profiler's kernel
        # time, not events around calls that wait
        with torch.no_grad():
            dev_ms = _profiled_device_ms(lambda: slv.m_step(state),
                                         10 if n_tiles == CONS_TILES else 2)
        host_ms = 1e3 / rate
        idle = 1 - dev_ms / host_ms
        print(f"[consensus] {name}: {n_tiles} tiles of {tile[0]}x{tile[1]} "
              f"({n_tiles * tile[0] * tile[1] / 1e9:.3f} G pixels), "
              f"{iters} iterations in one segment: {rate:.2f} it/s; device "
              f"{dev_ms:.4f} ms an iteration (torch.profiler), host "
              f"{host_ms:.4f} ms, idle {idle:.1%}; host reads "
              f"{reads:.1f} an iteration; peak {peak_gb:.2f} GiB; set-up "
              f"{setup:.2f} s; "
              f"max|z - soft(mean y, lam/2)| {gap:.3e}; objective "
              f"{obj0:.6e} -> {obj:.6e}; batched_path "
              f"{slv._fsum.batched_path}; no kernel launched", flush=True)
        if iters == CONS_ITERS:     # converged: the closed form
            assert gap <= 1e-4, gap
        assert reads <= 1.0, reads
        out[name] = dict(rate=rate, device_ms=dev_ms, host_ms=host_ms,
                         idle=idle, peak_gib=peak_gb, setup_s=setup, gap=gap,
                         host_reads_per_iter=reads,
                         batched_path=slv._fsum.batched_path)
        del slv, fit, ex, state, z, ybar, z_star
        torch.cuda.empty_cache()
    # the 2-tile 64x48 form, card (the mesh of one rank) vs CPU (no mesh)
    slv, fit, ex = consensus_tiles(tile=CONS_SMALL, n_tiles=2, device="cuda")
    g = (2 * CONS_LAM) * L1Norm(CONS_SMALL)
    cpu = ConsensusADMM([SquaredL2Norm(CONS_SMALL).asloss(y.cpu())
                         for y in ex["ys"]], g=g)
    for s, dev in ((slv, "cuda"), (cpu, "cpu")):
        s.fit(z0=torch.zeros(CONS_SMALL, device=dev),
              stop_crit=MaxIter(CONS_SMALL_ITERS), max_iter=CONS_SMALL_ITERS)
    got, want = slv.solution().cpu(), cpu.solution()
    diff = float((got - want).abs().max()) / float(want.abs().max())
    print(f"[consensus] {CONS_SMALL[0]}x{CONS_SMALL[1]} x 2 tiles, "
          f"{CONS_SMALL_ITERS} iterations card (NCCL mesh of 1) vs CPU (no "
          f"mesh): {diff:.3e} of max|z| (tol 2e-4)", flush=True)
    assert diff <= 2e-4, diff
    out["small_diff"] = diff
    return out


def _copy_rates():
    """Pinned host-to-device and device-to-host copy rates (bytes/s) of a
    1 GiB buffer, and a host memcpy's (numpy, 1 GiB), the best of 3."""
    import numpy as np
    n = 2 ** 28
    host = torch.empty(n, pin_memory=True)
    dev = torch.empty(n, device="cuda")
    rates = {}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        best = math.inf
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            dst.copy_(src, non_blocking=True)
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1) / 1e3)
        rates[name] = 4 * n / best
    a, b = np.ones(n, np.float32), np.empty(n, np.float32)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(b, a)
        best = min(best, time.perf_counter() - t0)
    rates["host"] = 4 * n / best
    return rates


def outofcore_phase(st):
    """Phase 17, out-of-core TV at 16384^2 (see the module docstring)."""
    import numpy as np
    from pyxu_tpu_torch.operator.func import L21Norm
    from pyxu_tpu_torch.operator.linop import Gradient, Stencil
    from pyxu_tpu_torch.parallel import StreamedCondatVu
    H, W = OOC_SHAPE
    k1 = np.exp(-0.5 * ((np.arange(9) - 4) / 2.0) ** 2)
    k1 = (k1 / k1.sum()).astype(np.float32)     # workload 1's blur
    gen = torch.Generator(device="cuda").manual_seed(0)
    K = Stencil((H, W), [k1, k1], [4, 4], mode="constant")
    with torch.no_grad():
        y = K.apply(torch.rand((H, W), generator=gen, device="cuda"))
    y_host = y.cpu().numpy()
    slv = StreamedCondatVu(y_host, k1, lam=OOC_LAM, block_rows=OOC_BLOCK,
                           device="cuda")
    bands = -(-H // OOC_BLOCK)
    _reset([st.separable_correlate2d])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slv.fit(n_iters=OOC_ITERS)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / OOC_ITERS
    launches = st.separable_correlate2d.launches
    assert launches == 6 * bands * OOC_ITERS, launches
    moved = slv.bytes_moved / OOC_ITERS
    xs = slv.solution()
    assert np.isfinite(xs).all()
    # the in-memory iteration on the card over the same frame
    D = Gradient((H, W), mode="constant")
    h = OOC_LAM * L21Norm((2, H, W), l2_axis=0)
    with torch.no_grad():
        x, z = y.clone(), torch.zeros((2, H, W), device="cuda")
        for _ in range(OOC_ITERS):
            xp = x - slv._tau * (K.adjoint(K.apply(x) - y) + D.adjoint(z))
            z = h.fenchel_prox(z + slv._sigma * D.apply(2.0 * xp - x),
                               slv._sigma)
            x = xp
        del z
        x_ref = x.cpu().numpy()
    err = float(np.abs(xs - x_ref).max())
    tol = 5e-6 * max(1.0, float(np.abs(x_ref).max()))
    # a band step's device time, on the last band's shape
    Rh = slv._block + 2 * slv._halo
    xb = torch.rand((Rh, W), generator=gen, device="cuda")
    zb = torch.zeros((2, Rh, W), device="cuda")
    mask = torch.ones((Rh, 1), device="cuda")
    with torch.no_grad():
        band_ms = _time_ms(lambda: slv._step(xb, zb, xb, mask), reps=3,
                           runs=3, warmup=1)
    # the stencil at the band's shape and the path's tap sets (the streamed
    # and the in-memory runs above both go through the kernel)
    band_taps = {"blur": Stencil((Rh, W), [k1, k1], [4, 4],
                                 mode="constant")._taps}
    for i, op in enumerate(Gradient((Rh, W), mode="constant")._ops):
        band_taps[f"D{i}"] = op._taps
    band_check = {}
    for name, p in band_taps.items():
        rec = _st_variants(st, p, xb, f" ooc-band {name} {Rh}x{W}",
                           plain_timed=False, verbose=False)
        band_check[name] = {tag: {f: r[f] for f in ("max_abs_err", "ms",
                                                      "bound_ms")}
                            for tag, r in rec.items()}
        print(f"[kernel] stencil at the streamed band's shape {Rh}x{W}, "
              f"{name} taps, apply and adjoint, constant and symmetric: "
              f"largest max_abs_err "
              f"{max(r['max_abs_err'] for r in rec.values()):.3e}, ms "
              + ", ".join(f"{t} {r['ms']:.4f}" for t, r in rec.items())
              + ": ok", flush=True)
    rates = _copy_rates()
    n_up = bands * (4 * Rh * W * 4 + 4 * Rh)        # x, z (2), y, mask
    n_down = moved - n_up
    pcie_s = n_up / rates["h2d"] + n_down / rates["d2h"]
    host_s = moved / rates["host"]      # the band copies and write-backs
    dev_s = bands * band_ms / 1e3
    gb = {k: v / 1e9 for k, v in rates.items()}
    # the host clock's split of each iteration (StreamedCondatVu.fit):
    # staging (halo fills into the page-locked buffers), the device part
    # (copies up, the band step, copies down, the wait) and write-backs
    split = slv.time_split
    for i, sp in enumerate(split):
        tot = sum(sp.values())
        print(f"[ooc] iteration {i}: stage {sp['stage']:.4f} s "
              f"({n_up / sp['stage'] / 1e9:.2f} GB/s of staged bytes), "
              f"device {sp['device']:.4f} s (PCIe at the measured rates "
              f"{pcie_s:.4f} + band steps {dev_s:.4f}), write-back "
              f"{sp['write_back']:.4f} s ({n_down / sp['write_back'] / 1e9:.2f}"
              f" GB/s of rows written back); {tot:.4f} s in all", flush=True)
    outside = sec * OOC_ITERS - sum(sum(sp.values()) for sp in split)
    print(f"[ooc] outside the bands' three parts (the staging buffers' "
          f"allocation in the first fit, set-up): {outside:.4f} s of "
          f"{sec * OOC_ITERS:.4f} s", flush=True)
    print(f"[ooc] streamed TV {H}x{W} f32, {bands} bands of {OOC_BLOCK} "
          f"rows (+{slv._halo} halo rows a side), {OOC_ITERS} iterations: "
          f"{sec:.4f} s an iteration; host state "
          f"{slv.state_bytes / 2 ** 30:.2f} GiB; moved {moved / 1e9:.3f} GB "
          f"an iteration ({n_up / 1e9:.3f} up, {n_down / 1e9:.3f} down); "
          f"pinned copies {gb['h2d']:.2f} GB/s up, {gb['d2h']:.2f} GB/s "
          f"down: {pcie_s:.4f} s an iteration at those rates; host memcpy "
          f"{gb['host']:.2f} GB/s: {host_s:.4f} s; device {dev_s:.4f} s "
          f"({band_ms:.4f} ms a band step), {dev_s / sec:.1%} of the "
          f"iteration; stencil launches {launches} (6 a band step)",
          flush=True)
    print(f"[ooc] streamed vs in-memory on the card: max_abs_diff "
          f"{err:.3e} (tol {tol:.3e})", flush=True)
    assert err <= tol, (err, tol)
    return dict(sec_per_iter=sec, bytes_per_iter=moved, up=n_up,
                down=n_down, rates=rates, pcie_s=pcie_s, host_copy_s=host_s,
                device_s=dev_s, band_ms=band_ms, launches=launches, err=err,
                time_split=split, outside_s=outside, band_check=band_check)


def _event_ms(fn):
    """Device ms of one ``fn()`` alone: CUDA events around it, then a
    synchronize."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def overlap_phase(st):
    """Phase 17, the streamed 16384^2 blur through ``streamed_map_overlap``
    with one band in flight (see the module docstring)."""
    import numpy as np
    from pyxu_tpu_torch.operator.linop import Stencil
    from pyxu_tpu_torch.parallel import streamed_map_overlap
    from pyxu_tpu_torch.parallel.outofcore import _band_slices, _fill_halo
    H, W = OOC_SHAPE
    block, depth = OOC_BLOCK, OVL_DEPTH
    k1 = np.exp(-0.5 * ((np.arange(9) - 4) / 2.0) ** 2)
    k1 = (k1 / k1.sum()).astype(np.float32)     # workload 1's blur
    Kb = Stencil((block + 2 * depth, W), [k1, k1], [4, 4], mode="constant")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((H, W), generator=gen, device="cuda").cpu().numpy()
    bands = _band_slices(H, block)
    # the parts alone, band by band in series: host fill into a page-locked
    # buffer, copy up, the blur, copy down, write-back into a fresh output
    # (host clock for the host parts, CUDA events for the device ones)
    xb = torch.empty((block + 2 * depth, W), pin_memory=True)
    rows = torch.empty((block, W), pin_memory=True)
    serial = np.zeros((H, W), np.float32)
    parts = {k: [] for k in ("fill", "up", "compute", "down", "write_back")}
    with torch.no_grad():
        for s, e in bands:
            t0 = time.perf_counter()
            _fill_halo(xb.numpy(), x, s, e, depth)
            parts["fill"].append((time.perf_counter() - t0) * 1e3)
            xd, ms = _event_ms(lambda: xb.to("cuda", non_blocking=True))
            parts["up"].append(ms)
            yd, ms = _event_ms(lambda: Kb.apply(xd))
            parts["compute"].append(ms)
            n = e - s
            _, ms = _event_ms(lambda: rows[:n].copy_(
                yd[depth:depth + n], non_blocking=True))
            parts["down"].append(ms)
            t0 = time.perf_counter()
            serial[s:e] = rows[:n].numpy()
            parts["write_back"].append((time.perf_counter() - t0) * 1e3)
        del xd, yd
        # the library's overlapped call: a warm call, then the timed one
        streamed_map_overlap(Kb.apply, x, depth=depth, block_rows=block,
                             device="cuda")
        walls = []
        for _ in range(OVL_RUNS):
            _reset([st.separable_correlate2d])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = streamed_map_overlap(Kb.apply, x, depth=depth,
                                       block_rows=block, device="cuda")
            walls.append((time.perf_counter() - t0) * 1e3)
            launches = st.separable_correlate2d.launches
            assert launches == len(bands), launches
            same = bool(np.array_equal(got, serial))
            assert same, "overlapped bands differ from the serial loop"
            del got
    tot = {k: sum(v) for k, v in parts.items()}
    one = {k: statistics.median(v) for k, v in parts.items()}
    serial_ms = sum(tot.values())
    wall = min(walls)
    ideal = max(tot.values())                   # the largest part
    host_ideal = max(tot["fill"] + tot["write_back"], tot["up"],
                     tot["compute"], tot["down"])   # one host thread
    print(f"[overlap] streamed blur {H}x{W} f32, {len(bands)} bands of "
          f"{block} rows (+{depth} halo rows a side): one band (median): "
          f"host fill {one['fill']:.3f} ms, up {one['up']:.3f} ms, blur "
          f"{one['compute']:.4f} ms, down {one['down']:.3f} ms, host "
          f"write-back {one['write_back']:.3f} ms", flush=True)
    print(f"[overlap] over the bands: fill {tot['fill']:.2f} + up "
          f"{tot['up']:.2f} + blur {tot['compute']:.3f} + down "
          f"{tot['down']:.2f} + write-back {tot['write_back']:.2f} = serial "
          f"sum {serial_ms:.2f} ms; overlapped call {wall:.2f} ms (best of "
          f"{OVL_RUNS}: " + ", ".join(f"{w:.2f}" for w in walls) + f"), "
          f"{serial_ms / wall:.3f}x shorter than the serial sum; the "
          f"largest part {ideal:.2f} ms is {ideal / wall:.1%} of it, the "
          f"host thread's fill + write-back {host_ideal:.2f} ms "
          f"{host_ideal / wall:.1%}; stencil launches {launches} (one a "
          f"band); the same bits as the serial loop: {same}", flush=True)
    return dict(bands=len(bands), band=one, total_ms=tot,
                serial_ms=serial_ms, wall_ms=wall, walls_ms=walls,
                ideal_ms=ideal, host_ideal_ms=host_ideal,
                launches=launches, same_bits=same)


def _sharded_nufft3_direct(outs, a, f, pts, N, n_check=1024):
    """ShardedNUFFT's d = 3 apply (type 1) at ``n_check`` modes and its
    adjoint (type 2) at ``n_check`` points against float64 direct sums:
    relative l-inf within 1e-5 (eps 1e-6)."""
    k = [torch.arange(-(n // 2), (n + 1) // 2, device="cuda",
                      dtype=torch.float64) for n in N]
    K = torch.stack(torch.meshgrid(*k, indexing="ij"), -1).reshape(-1, 3)
    xt = torch.from_numpy(pts).cuda()
    sel_k = torch.arange(0, K.shape[0], K.shape[0] // n_check, device="cuda")
    sel_x = torch.arange(0, xt.shape[0], xt.shape[0] // n_check,
                         device="cuda")
    errs = {}
    for name, got, want in (
            ("apply", outs["apply"].reshape(-1, 2)[sel_k],
             _direct3(a, xt, K, sel_z=sel_k, isign=1)),
            ("adjoint", outs["adjoint"][sel_x],
             _direct3(f.reshape(-1, 2), xt, K, sel_x=sel_x, isign=1))):
        g = torch.view_as_complex(got.double().contiguous())
        err = float((g - want).abs().max() / want.abs().max())
        tag = f"ShardedNUFFT d=3 {name} vs direct"
        errs[tag] = err
        print(f"[sharded] {tag} at {len(want)} "
              f"{'modes' if name == 'apply' else 'points'} (M={xt.shape[0]}, "
              f"N={N}, float64 sum): {err:.3e} of max|y| (tol 1e-5)",
              flush=True)
        assert err <= 1e-5, (tag, err)
    return errs


def sharded_ops_phase(st, nu, mesh):
    """Phase 17: ShardedStencil, ShardedNUFFT and ShardedNUFFT3 at world
    size 1 against their unsharded operators on the card, each call's
    kernel launches asserted."""
    import numpy as np
    from pyxu_tpu_torch.operator.linop import Stencil
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    from pyxu_tpu_torch.parallel import (ShardedNUFFT, ShardedNUFFT3,
                                         ShardedStencil)
    kerns = {"stencil": st.separable_correlate2d,
             "nufft_spread2": nu.nufft_spread2,
             "nufft_interp2": nu.nufft_interp2,
             "nufft_spread3": nu.nufft_spread3,
             "nufft_interp3": nu.nufft_interp3}
    launches = dict.fromkeys(kerns, 0)
    worst = {}

    def run(fn, want_launches):
        """``fn()``, its launches by kernel checked and counted."""
        n0 = {k: c.launches for k, c in kerns.items()}
        out = fn()
        n = {k: c.launches - n0[k] for k, c in kerns.items()}
        assert {k: v for k, v in n.items() if v} == want_launches, n
        for k, v in n.items():
            launches[k] += v
        return out.to_local()

    def check(tag, got, want, n):
        err = float((got - want).abs().max()) / float(want.abs().max())
        worst[tag] = err
        print(f"[sharded] {tag}: {err:.3e} of max|y| (tol 1e-5); "
              f"launches {n}", flush=True)
        assert err <= 1e-5, (tag, err)
    gen = torch.Generator(device="cuda").manual_seed(3)
    k1 = np.exp(-0.5 * ((np.arange(9) - 4) / 2.0) ** 2)
    k1 = (k1 / k1.sum()).astype(np.float32)
    x = torch.rand(SHAPE, generator=gen, device="cuda")
    for mode in ("constant", "wrap"):
        op = ShardedStencil(SHAPE, [k1, k1], [4, 4], mesh, mode=mode)
        ref = Stencil(SHAPE, [k1, k1], [4, 4], mode=mode)
        assert op.kernel_path == "kernel"
        for name in ("apply", "adjoint"):
            n = {"stencil": 1}
            got = run(lambda: getattr(op, name)(x), n)
            check(f"ShardedStencil {mode} {name} {SHAPE[0]}x{SHAPE[1]}", got,
                  getattr(ref, name)(x), n)
    rng = np.random.default_rng(0)
    uv = rng.normal(0, np.pi / 3, (RI_VIS, 2)).clip(-np.pi, np.pi)
    pts3 = rng.uniform(-np.pi, np.pi, (SH3_M, 3))
    for pts, N in ((uv, RI_SHAPE), (pts3, SH3_N)):
        d = pts.shape[1]
        op = ShardedNUFFT(pts, N, mesh, dtype=torch.float32)
        ref = NUFFT.type1(pts, N, dtype=torch.float32, device="cuda")
        a = torch.randn((pts.shape[0], 2), generator=gen, device="cuda")
        f = torch.randn(N + (2,), generator=gen, device="cuda")
        outs = {}
        for name, arg, kern in (("apply", a, f"nufft_spread{d}"),
                                ("adjoint", f, f"nufft_interp{d}")):
            n = {kern: 1}
            got = outs[name] = run(lambda: getattr(op, name)(arg), n)
            check(f"ShardedNUFFT d={d} {name} M={pts.shape[0]} N={N}", got,
                  getattr(ref, name)(arg), n)
        if d == 3:
            worst.update(_sharded_nufft3_direct(outs, a, f, pts, N))
    xs = rng.uniform(-1, 1, (T3S_M, 3))
    zs = rng.uniform(-30, 30, (T3S_K, 3))
    a = torch.randn((T3S_M, 2), generator=gen, device="cuda")
    f = torch.randn((T3S_K, 2), generator=gen, device="cuda")
    op1 = ShardedNUFFT3(xs, zs, mesh, fft_mem_mb=1e6, dtype=torch.float32)
    ref = NUFFT.type3(xs, zs, dtype=torch.float32, device="cuda")
    assert op1.stats()["n_z_blocks"] == 1
    for name, arg in (("apply", a), ("adjoint", f)):
        n = {"nufft_spread3": 1, "nufft_interp3": 1}
        got = run(lambda: getattr(op1, name)(arg), n)
        check(f"ShardedNUFFT3 Q=1 {name} M={T3S_M} K={T3S_K}", got,
              getattr(ref, name)(arg), n)
    opq = ShardedNUFFT3(xs, zs, mesh, fft_mem_mb=T3S_MB, dtype=torch.float32)
    Q = opq.stats()["n_z_blocks"]
    assert Q > 1, opq.stats()
    got = run(lambda: opq.apply(a), {"nufft_spread3": Q, "nufft_interp3": Q})
    sel = torch.arange(0, T3S_K, T3S_K // T3_CHECK_VIS, device="cuda")
    xt, zt = (torch.from_numpy(v).cuda() for v in (xs, zs))
    want = _direct3(a, xt, zt, sel_z=sel, isign=1)
    err = float((torch.view_as_complex(got[sel].double().contiguous())
                 - want).abs().max() / want.abs().max())
    print(f"[sharded] ShardedNUFFT3 Q={Q} (fft_mem_mb {T3S_MB}, stats "
          f"{opq.stats()}) apply vs a float64 direct sum at "
          f"{len(sel)} frequencies: {err:.3e} of max|y| (tol 1e-4); "
          f"launches {Q} spreads and {Q} interps", flush=True)
    assert err <= 1e-4, err
    worst["ShardedNUFFT3 Q>1 vs direct"] = err
    print(f"[sharded] launches by kernel: {launches}", flush=True)
    return dict(worst=worst, launches=launches, Q=Q)


def _chromatic_problem(shape, device):
    """The chromatic deblurring of phase 18 from the public API: point
    sources (density ``CHROMA_DENSITY``) of a random colour each, drawn from
    ``numpy.random.default_rng(0)``, blurred channel by channel by a 9-tap
    Gaussian of each of ``CHROMA_SIGMAS`` (symmetric padding), K =
    ``block_diag`` of the channels' Stencils, y = K x + ``CHROMA_NOISE`` n;
    f = ||K x - y||^2 (a QuadraticFunc over K's gram), g = ``CHROMA_LAM``
    ||x||_1, by FISTA (``PGD``).  Returns ``(solver, K, y)``."""
    import numpy as np
    from pyxu_tpu_torch.operator import (L1Norm, SquaredL2Norm, Stencil,
                                         block_diag)
    from pyxu_tpu_torch.opt.solver import PGD
    rng = np.random.default_rng(0)
    full = (len(CHROMA_SIGMAS),) + tuple(shape)
    where = rng.random(shape) < CHROMA_DENSITY
    colour = rng.uniform(0.2, 1.0, full)
    xt = torch.from_numpy((where * colour).astype(np.float32)).to(device)
    n = rng.standard_normal(full).astype(np.float32)
    K = block_diag([Stencil(shape, [_gauss9(s), _gauss9(s)], [4, 4],
                            mode="symmetric") for s in CHROMA_SIGMAS])
    y = K.apply(xt) + CHROMA_NOISE * torch.from_numpy(n).to(device)
    f = SquaredL2Norm(full).asloss(y) * K
    g = CHROMA_LAM * L1Norm(full)
    return PGD(f=f, g=g, stop_rate=STOP_RATE), K, y


def chromatic_phase(st, MaxIter):
    """Phase 18: 3-channel chromatic deblurring at 2160x3840 by FISTA on
    the stencil kernel with a tap set a channel (see the module
    docstring)."""
    slv, K, y = _chromatic_problem(SHAPE, "cuda")
    assert K.batched_path == "stencil" and not K._members.equal
    x0 = torch.zeros_like(y)
    slv.fit(x0=x0, stop_crit=MaxIter(STOP_RATE), max_iter=STOP_RATE)  # warm
    counters = [st.separable_correlate2d, st.separable_correlate2d_members]
    _reset(counters)
    dt = _timed_fit(slv, PATH_ITERS, x0=x0, stop_crit=MaxIter(PATH_ITERS),
                    max_iter=PATH_ITERS)
    launches = st.separable_correlate2d_members.launches
    # K^T K x in f's gradient: K and K^T, one launch each, an iteration
    # (a member at a time: 6)
    assert launches == 2 * PATH_ITERS, launches
    assert st.separable_correlate2d.launches == 0
    xs = slv.solution()
    assert xs.shape == y.shape and bool(torch.isfinite(xs).all())
    obj0 = float(slv.objective_func({"x": x0}))
    obj = float(slv.objective_func(slv._mstate))
    assert obj < obj0, (obj, obj0)
    rate = PATH_ITERS / dt
    state = slv._mstate
    with torch.no_grad():
        dev_ms = _time_ms(lambda: slv.m_step(state), reps=10)
        sten_ms = sum(_time_ms(
            lambda adj=adj: st.separable_correlate2d_members(
                xs, K._members.taps, adj)) for adj in (False, True))
    host_ms = 1e3 * dt / PATH_ITERS
    idle = 1 - dev_ms / host_ms
    print(f"[chromatic] 3x{SHAPE[0]}x{SHAPE[1]}: {PATH_ITERS} iterations in "
          f"{dt:.4f} s: {rate:.2f} it/s; batched_path {K.batched_path}; "
          f"stencil launches {launches} (2 an iteration, per-member taps); "
          f"objective {obj0:.6e} -> {obj:.6e}; nnz {int((xs != 0).sum())}",
          flush=True)
    print(f"[breakdown] chromatic 3x{SHAPE[0]}x{SHAPE[1]}: per iteration "
          f"device {dev_ms:.4f} ms, stencil kernel {sten_ms:.4f} ms "
          f"({sten_ms / dev_ms:.1%}), other kernels {dev_ms - sten_ms:.4f} "
          f"ms; host {host_ms:.4f} ms, device idle {idle:.1%}", flush=True)
    sols = {}
    for dev in ("cuda", "cpu"):
        s, _, ys = _chromatic_problem(CHROMA_SMALL, dev)
        s.fit(x0=torch.zeros_like(ys), stop_crit=MaxIter(CHROMA_SMALL_ITERS),
              max_iter=CHROMA_SMALL_ITERS)
        sols[dev] = s.solution().cpu()
    diff = float((sols["cuda"] - sols["cpu"]).abs().max())
    peak = max(1.0, float(sols["cpu"].abs().max()))
    print(f"[chromatic] 3x{CHROMA_SMALL[0]}x{CHROMA_SMALL[1]}, "
          f"{CHROMA_SMALL_ITERS} iterations card vs CPU: max_abs_diff="
          f"{diff:.3e} (tol {2e-4 * peak:.1e})", flush=True)
    assert diff <= 2e-4 * peak, (diff, peak)
    return dict(rate=rate, launches=launches, device_ms=dev_ms,
                stencil_ms=sten_ms, host_ms=host_ms, idle=idle,
                objective=obj, small_diff=diff)


def _notebook(device, small):
    """Run the port's notebook's code cells (``small``: n 64 and 40
    iterations, as the CPU tests shrink it) on ``device``; its namespace."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pyxu_tpu_torch", "examples",
                        "tv_deconvolution.ipynb")
    with open(path) as fh:
        nb = json.load(fh)
    ns = {}
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        src = "".join(cell["source"]).replace(
            "device = None", f"device = {str(device)!r}")
        if small:
            src = src.replace("n, lam, sigma_blur = 256,",
                              "n, lam, sigma_blur = 64,")
            src = src.replace("MaxIter(400)", "MaxIter(40)").replace(
                "max_iter=400", "max_iter=40")
        exec(src, ns)
    return ns


def _with_group(device, fn):
    """``fn(mesh)`` over a group of one rank on ``device`` (NCCL on the
    card, gloo on the CPU), torn down after."""
    import shutil
    import tempfile
    import torch.distributed as dist
    import pyxu_tpu_torch.parallel as par
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    par.init_distributed(f"file://{tmp}/store", 1, 0, device=device)
    try:
        return fn(par.auto_mesh(device=device))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def examples_phase(ft, st, nu):
    """Phase 19: the six example programs (see the module docstring)."""
    import numpy as np
    from pyxu_tpu_torch.examples import (deconvolution, distributed,
                                         out_of_core, radio_interferometry,
                                         tomography)
    counters = (ft.tv_step, ft.tv_stepk, st.separable_correlate2d,
                nu.nufft_spread2, nu.nufft_interp2)

    def run(tag, fn):
        """``fn()`` on the card, its printout and wall time, and the
        launches it made."""
        buf = io.StringIO()
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters if c.launches}
        for line in buf.getvalue().splitlines():
            print(f"[example] {tag}: {line}", flush=True)
        print(f"[example] {tag}: {sec:.3f} s on the card, launches "
              f"{launches}", flush=True)
        return out, sec, launches, buf.getvalue()

    def finite(a, shape=None):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        assert np.isfinite(a).all() and (shape is None or a.shape == shape)
        return a

    res = {}
    # -- at the programs' default sizes, on the card ------------------------
    x, sec, ln, txt = run("deconvolution", lambda: deconvolution.main(
        device="cuda"))
    finite(x, (256, 256))
    words = txt.split()
    blurred, rec = float(words[3]), float(words[6])
    assert rec < blurred and ln.get("tv_step", 0) > 0, (txt, ln)
    res["deconvolution"] = dict(s=sec, launches=ln, err=rec)
    for method in ("interp", "fourier"):
        x, sec, ln, txt = run(f"tomography {method}", lambda: tomography.main(
            method=method, device="cuda"))
        assert finite(x, (96, 96)).min() >= -1e-6
        assert ln.get("separable_correlate2d", 0) > 0, ln
        if method == "fourier":
            assert ln.get("nufft_spread2", 0) > 0 and \
                ln.get("nufft_interp2", 0) > 0, ln
        res[f"tomography_{method}"] = dict(s=sec, launches=ln,
                                           err=float(txt.split()[5][:-1]))
    x, sec, ln, txt = run("radio_interferometry",
                          lambda: radio_interferometry.main(device="cuda"))
    finite(x, (128, 128))
    assert ln.get("nufft_spread2", 0) > 0 and ln.get("nufft_interp2", 0) > 0
    res["radio_interferometry"] = dict(s=sec, launches=ln,
                                       err=float(txt.split()[-1]))
    (y, outs, sol), sec, ln, _ = run("out_of_core", lambda: out_of_core.main(
        device="cuda"))
    finite(y), finite(sol), [finite(o) for o in outs]
    # 4 bands of the streamed blur, then 20 iterations of 4 band steps of
    # 6 launches each
    assert ln.get("separable_correlate2d") == 4 + 20 * 4 * 6, ln
    res["out_of_core"] = dict(s=sec, launches=ln)
    _, sec, ln, _ = run("distributed", lambda: distributed.main(
        device="cuda"))
    assert ln.get("separable_correlate2d", 0) > 0 and \
        ln.get("nufft_spread2", 0) > 0 and ln.get("nufft_interp2", 0) > 0, ln
    res["distributed"] = dict(s=sec, launches=ln)
    ns, sec, ln, _ = run("notebook", lambda: _notebook("cuda", small=False))
    assert ns["slv"].fused_path == "kernel" and ln.get("tv_step", 0) > 0
    assert ns["err"] < 0.5, ns["err"]
    res["notebook"] = dict(s=sec, launches=ln, err=ns["err"])

    # -- at the CPU tests' sizes, card vs CPU -------------------------------
    def small(dev):
        with contextlib.redirect_stdout(io.StringIO()):
            out = {
                "deconvolution": deconvolution.main(n=48, device=dev),
                "tomography interp": tomography.main(n=32, n_angles=12,
                                                     device=dev),
                "tomography fourier": tomography.main(
                    n=32, n_angles=12, method="fourier", device=dev),
                "radio_interferometry": radio_interferometry.main(
                    n=24, n_vis=400, device=dev),
                "notebook": _notebook(dev, small=True)["x_rec"],
            }
            y, outs, sol = out_of_core.main(H=96, W=40, block_rows=32,
                                            device=dev)
            out.update({"out_of_core blur": y, "out_of_core TV": sol})
            out.update(("out_of_core block", o) for o in outs[-1:])

            def dist3(mesh):
                return {"halo TV": distributed.tv_deconvolution_halo(
                            mesh, n=48),
                        "consensus": distributed.consensus_lasso(mesh, n=16),
                        "type-3": distributed.sharded_type3_nufft(
                            mesh, M=600, K=400)[0]}
            out.update(_with_group(dev, dist3))
        return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in out.items()}
    card, cpu = small("cuda"), small("cpu")
    errs = {}
    for k, want in cpu.items():
        errs[k] = float(np.abs(card[k] - want).max()) / max(
            1.0, float(np.abs(want).max()))
        print(f"[example] {k} at the CPU tests' size, card vs CPU: "
              f"max_abs_diff / max(1, max|x|) {errs[k]:.3e} (tol "
              f"{EX_TOL:.0e})", flush=True)
    bad = {k: e for k, e in errs.items() if not e <= EX_TOL}
    assert not bad, bad
    res["card_vs_cpu"] = errs
    return res


def _example_launches(examples, kname):
    """Phase 19's launches of kernel ``kname``, by example program."""
    return {k: v["launches"].get(kname, 0) for k, v in examples.items()
            if isinstance(v, dict) and "launches" in v}


def parallel_phase(st, nu, MaxIter):
    """Phase 17: the parallel layer on the card over a NCCL group of world
    size 1 (see the module docstring)."""
    import shutil
    import tempfile
    import torch.distributed as dist
    import pyxu_tpu_torch.parallel as par
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    assert par.init_distributed(f"file://{tmp}/store", 1, 0,
                                device="cuda") == 1
    assert dist.get_backend() == "nccl", dist.get_backend()
    try:
        mesh = par.auto_mesh(device="cuda")
        out = {"consensus": consensus_phase(st, nu, MaxIter)}
        _mark("consensus (workload 5)")
        out["ooc"] = outofcore_phase(st)
        _mark("out-of-core TV")
        out["overlap"] = overlap_phase(st)
        _mark("overlapped streamed blur")
        out["sharded"] = sharded_ops_phase(st, nu, mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
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
    hess_recs = hessian_taps_phase(st, x)
    members_recs = members_phase(st)
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

    # ---- phase 12: the solver engine, NLCG and ProxAdam ------------------
    engine = engine_phase(ft, st)
    _mark("engine phase")

    # ---- phase 13: wide-field synthesis imaging over the type-3 NUFFT ---
    t3 = t3_phase(nu, MaxIter)
    _mark("type-3 sky phase")

    # ---- phase 14: 4K MYULA uncertainty and Tikhonov pinv --------------
    uq = uq_phase(st)
    _mark("MYULA and pinv phase")

    # ---- phase 15: 4K Hessian-Frobenius deconvolution --------------------
    hf = hf_phase(st, MaxIter)
    _mark("Hessian-Frobenius phase")

    # ---- phase 16: the rest of the operator library on the card ----------
    lib = library_phase(st)
    _mark("operator library phase")

    # ---- phase 17: the parallel layer over a NCCL group of one rank -----
    par = parallel_phase(st, nu, MaxIter)
    _mark("parallel phase")

    # ---- phase 18: 3-channel chromatic deblurring, per-member taps ------
    chroma = chromatic_phase(st, MaxIter)
    _mark("chromatic phase")

    # ---- phase 19: the six example programs -------------------------------
    examples = examples_phase(ft, st, nu)
    _mark("example programs")

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
            # phase 19: each example program's launches at its default size
            "examples_launches": _example_launches(examples, kname),
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
        # phase 14: the timed MYULA chain's and the timed pinv's launches
        "uq_launches": uq["launches"], "pinv_launches": uq["pinv_launches"],
        "uq": {k: uq[k] for k in ("stencil_ms", "step_ms", "device_ms",
                                  "idle", "pinv_device_ms", "pinv_host_ms",
                                  "pinv_iters")},
        # phase 15: the timed Hessian-Frobenius fit's launches, and the
        # kernel at the Hessian's tap sets (phase 2)
        "hf_launches": hf["launches"],
        # phase 17: the streamed TV's launches (6 a band step), the kernel
        # at its band's shape and taps, and ShardedStencil's launches (one
        # an apply or adjoint)
        "ooc_launches": par["ooc"]["launches"],
        "ooc_band": par["ooc"]["band_check"],
        "sharded_launches": par["sharded"]["launches"]["stencil"],
        # phase 17: the overlapped streamed 16384^2 blur's launches (one a
        # band), phase 19: each example program's
        "ooc_overlap_launches": par["overlap"]["launches"],
        "examples_launches": _example_launches(examples,
                                               "separable_correlate2d"),
        # phase 18: the timed chromatic fit's launches (a tap set a
        # channel), and the per-member kernel at 8x512^2 and 3x4K (phase 2)
        "chromatic_launches": chroma["launches"],
        "chromatic": {k: chroma[k] for k in ("stencil_ms", "device_ms",
                                             "host_ms", "idle")},
        "members": members_recs,
        "hf": {k: hf[k] for k in ("stencil_ms", "device_ms", "host_ms",
                                  "idle")},
        "hessian_taps": {
            n: {"bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                **{w: {k: {f: v[f] for f in ("ms", "plain_ms",
                                             "max_abs_err", "bound_ms")}
                       for k, v in r[w].items()} for w in ("f32", "f64")}}
            for n, r in hess_recs.items()},
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
            # phase 13: the 3-D kernels' launches in the timed fit, the 2-D
            # kernels' in the coplanar form's apply and adjoint
            "t3_launches": (t3["launches"][kname] if kname.endswith("3")
                            else t3["launches_2d"][kname]),
            "t3": {cloud: r for (k, cloud), r in t3["recs"].items()
                   if k == kname},
            # phase 17: ShardedNUFFT's and ShardedNUFFT3's launches
            "sharded_launches": par["sharded"]["launches"][kname],
            "examples_launches": _example_launches(examples, kname),
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
                      "ct_512_setup_s": ct[CT_SHAPE]["setup_s"],
                      "t3_sky_it_per_s": t3["rate"],
                      "t3_sky_setup_s": t3["setup_s"],
                      "myula_4k_it_per_s": uq["rate"],
                      "pinv_4k_it_per_s": uq["pinv_rate"],
                      "hf_4k_it_per_s": hf["rate"],
                      "sparse_laplacian_512": lib,
                      "consensus_admm_8x512_1dev": par["consensus"][
                          "consensus_admm_8x512_1dev"]["rate"],
                      "consensus_admm_64x4096_1dev": par["consensus"][
                          "consensus_admm_64x4096_1dev"]["rate"],
                      "ooc_tv_16k_s_per_iter": par["ooc"]["sec_per_iter"],
                      "chromatic_4k_it_per_s": chroma["rate"],
                      "ooc_blur_16k_overlap": par["overlap"],
                      "examples": examples,
                      "parallel": par,
                      "engine": engine}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
