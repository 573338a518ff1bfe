#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyxu_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:

1. device line (name and power limit from ``nvidia-smi``, torch and CUDA
   versions) and the build of the CUDA kernels from ``pyxu_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. kernels at 2160x3840: the fused-TV kernels with the workload's taps and
   step sizes (f32 state, and bf16 dual storage) and the separable stencil
   kernel with the workload's blur (apply and adjoint, constant and
   symmetric mode), each against its plain PyTorch version on the card,
   timed with CUDA events; the stencil beside one ``conv2d`` call;
3. the TV path: ``tv_deconvolution((2160, 3840))`` solved by
   ``CondatVu.fit(stop_crit=MaxIter(300))`` with ``stop_rate=100``, which
   must run through both fused-TV kernels (launch counts checked), then 30
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
   clustered set), and the spread of ones that builds the RI path's
   Toeplitz kernel (the Gaussian uv on its 4096x4096 grid), each against
   its plain version in float32 and float64, timed in float32; the
   ``kernels`` line gives each kernel's times as the RI path's
   launch-weighted mix of these cases;
6. the NUFFT's type 1 and type 2 at N = 256x256, M = 4000 against a direct
   NUDFT in float64 on the card;
7. the RI path: ``radio_interferometry((1024, 1024), n_vis=10**6)`` (set-up
   timed: the plan, the Toeplitz builds, y), a warm fit, then
   ``ADMM.fit(stop_crit=MaxIter(150))`` in one segment, with the NUFFT
   kernels' launch counts of the whole path checked and an event-timed
   iteration breakdown; then the JAX bench's 256x256 / 20000-visibility
   leg, 150 iterations on the card against the same solve on the CPU.

Each phase prints its host time (``[time]``).  It prints one
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and no result line is printed.  Without a CUDA
device it exits with code 2.
"""

import time

T_START = time.perf_counter()

import concurrent.futures  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

SHAPE = (2160, 3840)
PATH_ITERS, STOP_RATE = 300, 100
PARITY_ITERS, PARITY_RATE = 30, 10
BENCH_SHAPE, BENCH_ITERS = (256, 256), 2000     # bench.py's LASSO leg
CHECK_ITERS = 100                               # LASSO card vs CPU
RI_SHAPE, RI_VIS = (1024, 1024), 1_000_000       # one snapshot channel
RI_BENCH_SHAPE, RI_BENCH_VIS = (256, 256), 20_000   # bench.py's RI leg
RI_ITERS = 150                                      # the bench's depth
NU_GRID, NU_M, NU_W = (2048, 2048), 1_000_000, 7    # A's fine grid at 1024^2
TOEP_GRID = (4096, 4096)        # the Toeplitz builds' fine grid at 1024^2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
SLEEP_CYCLES = 40_000_000      # ~20 ms at 1.98 GHz: longer than the host
                               # takes to enqueue one timed run


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


def kernel_phase(ft, p, x, z, b):
    """Each kernel against its plain version; returns per-kernel records."""
    H, W = x.shape
    xmax = float(x.abs().max())
    out = {}
    for name, n_steps in (("tv_step", 1), ("tv_stepk", 3)):
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
            print(f"[kernel] {name}[{tag}] max_abs_err x={err_x:.3e} "
                  f"z={err_z:.3e} tol {tol_s}: {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"{name}[{tag}] disagrees with its plain "
                                 "version")
            ms, plain_ms = _time_ms(kern), _time_ms(plain, reps=5)
            bound_ms, bound_by = _bound(H, W, p, n_steps,
                                        4 if zdt == torch.float32 else 2)
            print(f"[kernel] {name}[{tag}] ms={ms:.4f} plain_ms={plain_ms:.4f}"
                  f" bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
            out[(name, tag)] = dict(max_abs_err=max(err_x, err_z), ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by)
    return out


def stencil_phase(st, p, x):
    """The stencil kernel against its plain version, apply and adjoint in
    both modes, at the workload's shape and taps; returns per-variant
    records and the time of one ``conv2d`` of the same constant-mode
    apply (cuDNN, TF32 off)."""
    H, W = x.shape
    tol = 1e-5 * float(x.abs().max())
    nbytes = 2 * H * W * x.element_size()
    ops = 2 * (len(p.k0) + len(p.k1)) * H * W
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    bound_ms, bound_by = max(t_b, t_o) * 1e3, (
        "bytes" if t_b >= t_o else "operations")
    out = {}
    for mode in ("constant", "symmetric"):
        q = st.SepTaps(p.k0, p.c0, p.k1, p.c1, mode)
        for adj in (False, True):
            tag = f"{mode}{'-adjoint' if adj else ''}"

            def kern(q=q, adj=adj):
                return st.separable_correlate2d(x, q, adj)

            def plain(q=q, adj=adj):
                return st.separable_correlate2d_plain(x, q, adj)
            err = float((kern() - plain()).abs().max())
            torch.cuda.synchronize()
            ok = err <= tol
            print(f"[kernel] stencil[{tag}] max_abs_err={err:.3e} tol "
                  f"1e-5*max|x| = {tol:.3e}: {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"stencil[{tag}] disagrees with its plain "
                                 "version")
            ms, plain_ms = _time_ms(kern), _time_ms(plain, reps=5)
            print(f"[kernel] stencil[{tag}] ms={ms:.4f} plain_ms="
                  f"{plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})",
                  flush=True)
            out[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    assert not torch.backends.cudnn.allow_tf32
    w = torch.outer(torch.tensor(p.k0), torch.tensor(p.k1)).to(x)[None, None]
    x4 = x[None, None]

    def lib():
        return torch.nn.functional.conv2d(x4, w, padding=(p.c0, p.c1))
    err = float((lib()[0, 0] - st.separable_correlate2d(
        x, st.SepTaps(p.k0, p.c0, p.k1, p.c1, "constant"))).abs().max())
    library_ms = _time_ms(lib)
    print(f"[kernel] stencil conv2d library_ms={library_ms:.4f} "
          f"(max_abs_diff to the kernel {err:.3e})", flush=True)
    return out, library_ms


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


def _nu_bound(M, n_grid, w, elem):
    """Least time (ms) of one spread or interp: the plan's point data
    (perm, two left taps, two offsets) and the values read once and the
    grid written or read once, or M (w^2 complex-by-real multiply-adds and
    their weight products, 5 operations a tap, plus 2w ES evaluations of 8
    operations), whichever is larger."""
    nbytes = M * (4 + 8 + 2 * elem + 2 * elem) + n_grid * 2 * elem
    ops = M * (5 * w * w + 8 * 2 * w)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nufft_kernel_phase(nu):
    """Spread and interp against their plain versions on three point sets
    at full size, and the spread of ones of the RI path's Toeplitz builds
    (the Gaussian uv set on their 4096^2 grid); f32 (timed) and f64
    (checked).  Returns per-case records per kernel."""
    import numpy as np
    from pyxu_tpu_torch.operator.linop.nufft import _es_params
    from pyxu_tpu_torch.utils.misc import next_fast_len
    w, beta = _es_params(1e-6)
    assert w == NU_W, w
    # the fine grid of the (2N - 1)^2 mode grid at upsampfac 2
    assert TOEP_GRID == tuple(next_fast_len(2 * (2 * n - 1))
                              for n in RI_SHAPE), TOEP_GRID
    rng = np.random.default_rng(0)
    recs = {"nufft_spread2": {}, "nufft_interp2": {}}
    for kind in ("uniform", "gauss", "cluster"):
        x = torch.remainder(torch.from_numpy(
            _nu_points(kind, NU_M, rng)).to("cuda"), 2 * np.pi)
        for dt in (torch.float32, torch.float64):
            gen = torch.Generator(device="cuda").manual_seed(1)
            c = torch.randn((1, NU_M, 2), generator=gen, device="cuda",
                            dtype=dt)
            g = torch.randn((1,) + NU_GRID + (2,), generator=gen,
                            device="cuda", dtype=dt)
            cases = [(kind, NU_GRID, "nufft_spread2", c),
                     (kind, NU_GRID, "nufft_interp2", g)]
            if kind == "gauss":
                ones = torch.zeros_like(c)
                ones[..., 0] = 1.0
                cases.append(("toeplitz", TOEP_GRID, "nufft_spread2", ones))
            for case, grid, name, a in cases:
                p = nu.plan2(x, grid, NU_W, beta, dt)
                kern = getattr(nu, name)
                plain = getattr(nu, name + "_plain")
                want = plain(a, p)
                err = float((kern(a, p) - want).abs().max())
                torch.cuda.synchronize()
                ref = float(want.abs().max())
                tol = 1e-5 if dt == torch.float32 else 1e-12
                ok = err <= tol * ref
                tag = (f"{name}[{case}, {grid[0]}x{grid[1]}, "
                       f"{str(dt)[6:]}]")
                print(f"[kernel] {tag} max_abs_err={err:.3e} tol "
                      f"{tol:g}*max|plain| = {tol * ref:.3e} (float atomics "
                      f"and tap order): {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise SystemExit(f"{tag} disagrees with its plain version")
                if dt == torch.float32:
                    ms = _time_ms(lambda: kern(a, p))
                    plain_ms = _time_ms(lambda: plain(a, p), reps=2, runs=3)
                    bound_ms, bound_by = _nu_bound(NU_M, grid[0] * grid[1],
                                                   NU_W, 4)
                    print(f"[kernel] {tag} ms={ms:.4f} plain_ms="
                          f"{plain_ms:.4f} bound_ms={bound_ms:.4f} "
                          f"({bound_by}); {p.sub.shape[0]} subproblems",
                          flush=True)
                    recs[name][case] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=plain_ms,
                                            bound_ms=bound_ms,
                                            bound_by=bound_by)
                else:
                    recs[name][case]["max_abs_err_f64"] = err
                del p, want
            del c, g
    return recs


def nudft_phase():
    """NUFFT type 1 and type 2 (float32 plan, eps 1e-6) at N = 256x256,
    M = 4000 against a direct NUDFT in float64 on the card: relative
    l-inf <= 1e-5."""
    import numpy as np
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    rng = np.random.default_rng(2)
    N, M = (256, 256), 4000
    x = _nu_points("gauss", M, rng)
    c = rng.standard_normal((M, 2))
    f = rng.standard_normal(N + (2,))
    op = NUFFT.type1(x, N, isign=1, eps=1e-6, dtype=torch.float32,
                     device="cuda")
    got1 = op.apply(torch.from_numpy(c).float().cuda()).double()
    got2 = op.adjoint(torch.from_numpy(f).float().cuda()).double()
    xt = torch.from_numpy(x).cuda()
    k = [torch.arange(-(n // 2), (n + 1) // 2, device="cuda",
                      dtype=torch.float64) for n in N]
    K = torch.stack(torch.meshgrid(*k, indexing="ij"), -1).reshape(-1, 2)
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
    print(f"[nudft] type 1 rel l-inf {errs[0]:.3e}, type 2 {errs[1]:.3e} "
          f"(N=256x256, M=4000, eps 1e-6; tol 1e-5)", flush=True)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyxu_tpu_torch.models import (
        lasso_deconvolution,
        radio_interferometry,
        tv_deconvolution,
    )
    from pyxu_tpu_torch.ops import fused_tv as ft
    from pyxu_tpu_torch.ops import nufft as nu
    from pyxu_tpu_torch.ops import stencil as st
    from pyxu_tpu_torch.opt.stop import MaxIter

    def timed_build(mod):
        t0 = time.perf_counter()
        return mod.build(), time.perf_counter() - t0

    # the builds run while the device is queried
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = {src: pool.submit(timed_build, mod) for src, mod in
                  (("fused_tv.cu", ft), ("stencil.cu", st), ("nufft.cu", nu))}
        smi = _smi()
        name = torch.cuda.get_device_name(0)
        print(f"[device] {smi} | torch {torch.__version__} CUDA "
              f"{torch.version.cuda}", flush=True)
        _mark("imports and device query")
        builds = {src: f.result() for src, f in builds.items()}
    for src, (log, sec) in builds.items():
        print(f"[build] {src} built in {sec:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {line.strip()}", flush=True)
    print(f"[build] all sources in {time.perf_counter() - t0:.2f} s",
          flush=True)
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
    recs = kernel_phase(ft, p, x, z, b)
    st_recs, st_library_ms = stencil_phase(st, ex["K"]._taps, x)
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
    want = {"tv_stepk": segs * (STOP_RATE // kk),
            "tv_step": segs * (STOP_RATE % kk)}
    print(f"[path] fused_path={slv.fused_path} K={kk} launches={launches} "
          f"expected={want}", flush=True)
    assert slv.fused_path == "kernel" and kk == 3, (slv.fused_path, kk)
    assert launches == want and min(launches.values()) > 0, launches
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
    nudft_phase()
    _mark("NUDFT check")
    ri = ri_phase(nu, radio_interferometry, MaxIter)
    _mark("RI path")

    kernels = []
    for kname, replaces, n_steps in (
            ("tv_step", "pyxu_tpu/ops/fused_tv.py:390", 1),
            ("tv_stepk", "pyxu_tpu/ops/fused_tv.py:926", 3)):
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
    })
    # the RI 1024^2 path spreads twice on the Toeplitz grid and once (A^H y)
    # on A's; it interpolates once (y) on A's grid
    nu_mix = {"nufft_spread2": {"toeplitz": 2, "gauss": 1},
              "nufft_interp2": {"gauss": 1}}
    for kname, replaces in (
            ("nufft_spread2", "pyxu_tpu/ops/pallas_nufft.py:126 (slab_spread)"
             ", :711 (strip_spread2), :842 (ragged_spread2)"),
            ("nufft_interp2", "pyxu_tpu/ops/pallas_nufft.py:193 (slab_interp)"
             ", :778 (strip_interp2), :897 (ragged_interp2)")):
        rs, mix = nu_recs[kname], nu_mix[kname]
        assert sum(mix.values()) == ri[RI_SHAPE]["launches"][kname], mix
        top = max(mix, key=mix.get)

        def mixed(f):
            return sum(n * rs[k][f] for k, n in mix.items()) / sum(
                mix.values())
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "pyxu_tpu_torch/csrc/nufft.cu", "replaces": replaces,
            "launches": ri[RI_SHAPE]["launches"][kname],
            "max_abs_err": max(v["max_abs_err"] for v in rs.values()),
            "ms": mixed("ms"), "plain_ms": mixed("plain_ms"),
            "bound_ms": mixed("bound_ms"), "bound_by": rs[top]["bound_by"],
            "library_ms": None, "path_mix": mix,
            "variants": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                "max_abs_err")}
                         for k, v in rs.items()},
        })
    print(json.dumps({"kernels": kernels, "path_it_per_s": rate,
                      "fused_it_per_s": rates[True],
                      "generic_it_per_s": rates[False],
                      "lasso_4k_it_per_s": lasso_rates[SHAPE],
                      "lasso_256_it_per_s": lasso_rates[BENCH_SHAPE],
                      "ri_1024_it_per_s": ri[RI_SHAPE]["rate"],
                      "ri_256_it_per_s": ri[RI_BENCH_SHAPE]["rate"],
                      "ri_1024_setup_s": ri[RI_SHAPE]["setup_s"]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
