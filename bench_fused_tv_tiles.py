#!/usr/bin/env python3
"""Time the fused-TV kernels of ``pyxu_tpu_torch`` over tiles, threads and
depths K on one NVIDIA GPU.

    python3 bench_fused_tv_tiles.py [--phases] [K:THREADS:ROWS:COLS ...]

At the TV path's size (2160x3840, f32 state, the workload's 9-tap blur and
step sizes) it builds ``csrc/fused_tv.cu`` once for each variant, with the
tile and thread overrides the source takes (``TV_TR_<K>``, ``TV_TC_<K>``,
``TV_THREADS`` for K = 1, ``TV_THREADS_K`` for K >= 2; one ``nvcc`` each,
all started together), checks each variant against the plain version as
``chip_smoke.py`` does, and prints its device time a launch and an
iteration (``chip_smoke._time_ms``), its shared memory and its share of
interior blocks.  Without arguments it sweeps ``VARIANTS``.  With
``--phases`` the builds also take ``TV_PHASE_CLOCKS``, and for one more
launch of each variant it prints the mean SM clocks a block spends in each
phase (thread 0, barrier to barrier: window load, tap stages before x+,
x+, z+, tile store), for interior and for edge blocks.
"""

import ctypes

import concurrent.futures
import os
import sys

import torch

# (K, threads, tile rows, tile cols)
VARIANTS = (
    (1, 256, 31, 31), (1, 256, 32, 32), (1, 512, 31, 63), (1, 512, 63, 63),
    (2, 512, 31, 47), (2, 512, 47, 63), (2, 1024, 47, 63),
    (3, 512, 47, 63), (3, 1024, 47, 63), (3, 512, 48, 64),
    (4, 512, 31, 47), (4, 512, 31, 31),
)


PHASES = ("load", "taps", "x+", "z+", "store")


def _defines(K, threads, tr, tc, phases=False):
    return ((f"TV_THREADS={threads}" if K == 1 else f"TV_THREADS_K={threads}"),
            f"TV_TR_{min(K, 4)}={tr}", f"TV_TC_{min(K, 4)}={tc}"
            ) + (("TV_PHASE_CLOCKS",) if phases else ())


def _phase_clocks(lib):
    out = (ctypes.c_ulonglong * 16)()
    err = lib.tv_phase_clocks(ctypes.cast(out, ctypes.c_void_p))
    assert err == 0, err
    return list(out)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bench_fused_tv_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from pyxu_tpu_torch.models import tv_deconvolution
    from pyxu_tpu_torch.ops import _build
    from pyxu_tpu_torch.ops import fused_tv as ft
    phases = "--phases" in argv
    argv = [a for a in argv if a != "--phases"]
    variants = [tuple(int(v) for v in a.split(":")) for a in argv] or VARIANTS
    print(f"[device] {cs._smi()}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        for _ in pool.map(lambda v: _build.compile_source(
                "fused_tv.cu", _defines(*v, phases)), variants):
            pass
    slv, fit, _ = tv_deconvolution(cs.SHAPE, device="cuda")
    slv.m_init(**fit)
    p, b = slv._fused.params, slv._fused.b
    x = fit["x0"].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = 0.01 * torch.randn((2,) + cs.SHAPE, generator=gen, device="cuda")
    tol = 1e-5 * float(x.abs().max())
    plain = {}
    for K, threads, tr, tc in variants:
        name = f"K={K} threads={threads} tile={tr}x{tc}"
        saved = ft._TILES[min(K, 4)]
        ft._TILES[min(K, 4)] = (tr, tc)
        smem = ft.smem_bytes(p, K)
        inner, total = ft.interior_blocks(cs.SHAPE, p, K)
        ft._TILES[min(K, 4)] = saved
        if smem > ft._MAX_SMEM:
            print(f"[tiles] {name}: {smem} B of shared memory, skipped",
                  flush=True)
            continue
        defines = _defines(K, threads, tr, tc, phases)
        entry, extra = (("tv_step_launch", ()) if K == 1
                        else ("tv_stepk_launch", (K,)))

        def kern():
            return ft._launch(entry, x, z, b, p, *extra, defines=defines)
        if K not in plain:
            plain[K] = ft.tv_stepk_plain(x, z, b, p, K)
        xk, zk = kern()
        torch.cuda.synchronize()
        err = max(float((xk - plain[K][0]).abs().max()),
                  float((zk - plain[K][1]).abs().max()))
        assert err <= tol, (name, err, tol)
        ms = cs._time_ms(kern)
        print(f"[tiles] {name}: {ms:.4f} ms a launch, {ms / K:.4f} ms an "
              f"iteration; {smem} B shared, {inner}/{total} interior "
              f"blocks; max_abs_err {err:.3e}", flush=True)
        if phases:
            lib = ft._library(defines)[0]
            _phase_clocks(lib)
            kern()
            torch.cuda.synchronize()
            c = _phase_clocks(lib)
            for tag, o in (("interior", 0), ("edge", 8)):
                n = max(c[o + 7], 1)
                print(f"[phases] {name} {tag} ({c[o + 7]} blocks): "
                      + ", ".join(f"{ph} {c[o + i] / n:.0f}"
                                  for i, ph in enumerate(PHASES))
                      + " clocks a block", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
