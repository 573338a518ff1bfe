"""Scale-out imaging over a device mesh: the three distribution patterns
of the JAX package's ``examples/distributed.py`` over the port.

1. halo-exchange TV deconvolution: image rows sharded over the mesh,
   ``ShardedStencil`` exchanges kernel-radius halos (the stencil kernel
   on the card);
2. consensus ADMM: per-rank losses, one all-reduced mean a step;
3. mesh-parallel type-3 NUFFT: domain-partitioned blocks, one
   all-reduce an apply (2-D points: the 2-D NUFFT kernels on the card).

The port's parallel layer is SPMD over processes: each rank runs this
program on its own device, over a ``torch.distributed`` group.  Sharded
operators return ``DTensor``s, so the halo TV solve keeps its state as
``DTensor``s sharded like the image rows, and wraps the (unsharded)
Gradient in ``with_sharding``.

Run: python -m pyxu_tpu_torch.examples.distributed
(a group of one rank: NCCL on the card, gloo with ``main(device="cpu")``;
under ``torchrun`` the group is the launcher's).
"""

import numpy as np
import torch


def tv_deconvolution_halo(mesh, n=256, lam=0.005):
    """Rows sharded over the mesh; the blur stencil halo-exchanges.
    Returns the reconstruction (global, on this rank's device)."""
    from pyxu_tpu_torch.operator import Gradient, L21Norm, SquaredL2Norm
    from pyxu_tpu_torch.opt.solver import CondatVu
    from pyxu_tpu_torch.opt.stop import MaxIter
    from pyxu_tpu_torch.parallel import (P, ShardedStencil, shard,
                                         with_sharding)
    from pyxu_tpu_torch.utils.misc import peaks

    dev = torch.device(mesh.device_type)
    g = np.linspace(-2.5, 2.5, n)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    x_true = peaks(torch.from_numpy(xx), torch.from_numpy(yy)).to(
        dev, torch.float32)
    k = np.exp(-0.5 * ((np.arange(9) - 4) / 2.0) ** 2)
    k1 = (k / k.sum()).astype(np.float32)
    K = ShardedStencil((n, n), [k1, k1], [4, 4], mesh, shard_axis=0,
                       mode="constant")
    y = K.apply(shard(x_true, mesh, P("s", None)))

    f = 0.5 * SquaredL2Norm((n, n)).asloss(y) * K
    D = with_sharding(Gradient((n, n), mode="symmetric"), mesh,
                      ("s", None), (None, "s", None))
    h = lam * L21Norm((2, n, n), l2_axis=0)
    slv = CondatVu(f=f, g=None, h=h, K=D)
    slv.fit(x0=shard(torch.zeros((n, n), device=dev), mesh, P("s", None)),
            z0=shard(torch.zeros((2, n, n), device=dev), mesh,
                     P(None, "s", None)),
            stop_crit=MaxIter(100), max_iter=100)
    x = slv.solution().full_tensor()
    rel = float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true))
    print(f"[halo TV]        rel. reconstruction error after 100 it: "
          f"{rel:.3f}")
    return x


def consensus_lasso(mesh, n=64):
    """Each rank owns a measurement block; consensus ADMM agrees on x.
    Returns the consensus x."""
    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    from pyxu_tpu_torch.opt.stop import MaxIter, RelError
    from pyxu_tpu_torch.parallel import ConsensusADMM

    dev = torch.device(mesh.device_type)
    n_dev = mesh.size()
    rng = np.random.default_rng(3)
    ys = [torch.from_numpy((rng.standard_normal(n) + 1.0).astype(
        np.float32)).to(dev) for _ in range(n_dev)]
    fs = [SquaredL2Norm((n,)).asloss(y) for y in ys]
    lam = 0.4
    slv = ConsensusADMM(fs, g=(n_dev * lam) * L1Norm((n,)), mesh=mesh)
    slv.fit(z0=torch.zeros(n, device=dev),
            stop_crit=RelError(eps=1e-7, var="z") | MaxIter(1500),
            max_iter=1500)
    x = slv.solution()                  # z, the same on every rank
    ybar = np.mean([y.cpu().numpy() for y in ys], axis=0)
    want = np.sign(ybar) * np.maximum(np.abs(ybar) - lam / 2, 0)
    err = float(np.abs(x.cpu().numpy() - want).max())
    print(f"[consensus]      max |x - closed_form|: {err:.2e}")
    return x


def sharded_type3_nufft(mesh, M=4000, K=3000):
    """Blocks of a chunked type-3 NUFFT as one SPMD program.  Returns the
    apply of the whole strength vector and of its first 500 entries."""
    from pyxu_tpu_torch.operator.linop.nufft import nudft3
    from pyxu_tpu_torch.parallel import ShardedNUFFT3

    dev = torch.device(mesh.device_type)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0, 1.0, (M, 2)) + np.array([12.0, -7.0])  # off-centre
    z = rng.uniform(-25.0, 25.0, (K, 2))
    op = ShardedNUFFT3(x, z, mesh, eps=1e-6, fft_mem_mb=0.05)
    c = rng.standard_normal(M) + 1j * rng.standard_normal(M)
    a = torch.from_numpy(np.stack([c.real, c.imag], -1).astype(
        np.float32)).to(dev)
    got = op.apply(a).full_tensor().cpu().numpy()   # a replicated DTensor
    # verify against the O(MK) direct sum on a 500-source slice
    want = nudft3(c[:500], x[:500], z)
    ws = np.stack([want.real, want.imag], -1)
    a500 = a.clone()
    a500[500:] = 0.0
    got_slice = op.apply(a500).full_tensor().cpu().numpy()
    rel = np.abs(got_slice - ws).max() / np.abs(ws).max()
    print(f"[sharded NUFFT3] {op.stats()}  rel err vs direct: {rel:.1e}")
    assert np.isfinite(got).all()
    return got, got_slice


def main(device=None):
    import shutil
    import tempfile

    import torch.distributed as dist

    from pyxu_tpu_torch.parallel import auto_mesh, init_distributed
    from pyxu_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    tmp = None
    if not dist.is_initialized():       # no launcher: a group of one rank
        tmp = tempfile.mkdtemp(prefix="pyxu_tpu_torch_")
        init_distributed(f"file://{tmp}/store", 1, 0, device=dev)
    try:
        mesh = auto_mesh(device=dev)    # every rank on one axis "s"
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{mesh.size()} devices")
        tv_deconvolution_halo(mesh)
        consensus_lasso(mesh)
        sharded_type3_nufft(mesh)
    finally:
        if tmp is not None:
            dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
