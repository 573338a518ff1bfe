"""Larger-than-device-memory solves by host-offload streaming (the JAX
package's ``examples/out_of_core.py`` over the port).

Three patterns:

1. ``streamed_map_overlap``: apply any local operator to a host array in
   row bands with halo rows, exactly (``map_overlap``'s boundary=0/trim
   contract).  On the card one band is in flight: band i+1 is filled,
   copied up and blurred by the stencil kernel while band i comes back.
2. ``streamed_block_diag``: one operator per host-resident block, in the
   same way.
3. ``StreamedCondatVu``: a full TV-deconvolution solve whose state (x, z,
   y) never leaves host RAM or disk; the streamed band updates equal the
   global in-memory iteration exactly.  Pass ``np.memmap``s for
   disk-backed state.

Run: python -m pyxu_tpu_torch.examples.out_of_core
"""

import numpy as np

from pyxu_tpu_torch.operator import Stencil
from pyxu_tpu_torch.operator.linop.base import HomothetyOp
from pyxu_tpu_torch.parallel import (StreamedCondatVu, streamed_block_diag,
                                     streamed_map_overlap)
from pyxu_tpu_torch.runtime import resolve_device


def main(H=1024, W=768, block_rows=256, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    t = np.arange(9) - 4.0
    k1 = np.exp(-0.5 * (t / 2.0) ** 2).astype(np.float32)
    k1 /= k1.sum()

    # -- 1. streamed stencil apply (map_overlap analog) ---------------------
    x = rng.random((H, W), dtype=np.float32)        # host-resident
    Kb = Stencil((block_rows + 10, W), [k1] * 2, [4, 4], mode="constant")
    y = streamed_map_overlap(Kb.apply, x, depth=5, block_rows=block_rows,
                             device=dev)
    print(f"streamed blur: {x.shape} -> {y.shape}, device never held more "
          f"than {(block_rows + 10) * W * 4 / 1e6:.1f} MB")

    # -- 2. per-block operators on host blocks ------------------------------
    ops = [HomothetyOp(dim_shape=(256, W), cst=c) for c in (1.0, 0.5, 2.0)]
    blocks = [rng.random((256, W), dtype=np.float32) for _ in ops]
    outs = streamed_block_diag(ops, blocks, device=dev)
    print("streamed block_diag:", [o.shape for o in outs])

    # -- 3. full out-of-core TV solve ---------------------------------------
    slv = StreamedCondatVu(y, k1, lam=0.01, block_rows=block_rows,
                           device=dev)
    print(f"state {slv.state_bytes / 1e6:.0f} MB host-resident")
    slv.fit(n_iters=20)
    sol = slv.solution()
    print(f"solved: residual moved {np.abs(sol - y).max():.4f}, "
          f"finite={np.isfinite(sol).all()}")
    return y, outs, sol


if __name__ == "__main__":
    main()
