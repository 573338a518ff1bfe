"""The port's one-rank gloo mesh, shared by the port's test modules.

Import the fixture into a test module (``from _torch_mesh import mesh1``);
each module gets its own group, torn down after the module.
"""

import pytest
import torch.distributed as dist

import pyxu_tpu_torch.parallel as tpar


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A gloo group of one rank on a ``file://`` store, and its mesh."""
    store = tmp_path_factory.mktemp("gloo1") / "store"
    assert tpar.init_distributed(f"file://{store}", 1, 0, device="cpu") == 1
    try:
        yield tpar.auto_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
