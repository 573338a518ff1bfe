"""The comparison that decides ``correct``, on the CPU at a size a test
run holds: each reference against first principles, a sound run of each
cell passes its limit, and its control (the program's own bfloat16 path)
and each fault the cells can have (a step that returns its state
unchanged, an answer altered where it is produced) fail it.  The run is a
whole run of the harness on the CPU with the card's look skipped.

The ``cuda`` test reads the control on the card at the cells' own sizes.

    python -m pytest perfbench/tests -q
"""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
PB = HERE.parent
sys.path.insert(0, str(PB.parent))
sys.path.insert(0, str(PB))

import harness  # noqa: E402

SMALL = {"tv_deconv_4k": dict(frame=[64, 96])}
CELLS = ["tv4k.frames", "tv4k.nonneg"]
SEED = 2 ** 31 + 12345


def _config(workload):
    return harness.cell(harness.spec(), workload)["workload"]["config"]


def _run(workload, **kw):
    return harness.run_cell(workload, SEED, 0.3, False, device="cpu",
                            cfg_override=SMALL[_config(workload)],
                            traffic_override=dict(pool=2, sample=2),
                            log=lambda s: None, **kw)


def test_tv_reference_operators():
    """The plain blur and gradient: adjoint pairs, the gradient's forward
    differences with a zero last row and column, the declared steps."""
    ref = harness.load("reference", "tv_deconv_4k")
    cfg = dict(harness.read_json("configs", "tv_deconv_4k"), frame=[13, 17])
    P = ref.TVProblem(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.rand((13, 17), generator=g, dtype=torch.float64)
    y = torch.rand((13, 17), generator=g, dtype=torch.float64)
    z = torch.rand((2, 13, 17), generator=g, dtype=torch.float64)
    assert torch.sum(P.Kf(x) * y) == pytest.approx(torch.sum(x * P.Kt(y)),
                                                   rel=1e-12)
    assert torch.sum(P.Df(x) * z) == pytest.approx(torch.sum(x * P.Dt(z)),
                                                   rel=1e-12)
    d = P.Df(x)
    assert torch.equal(d[0, :-1], x[1:] - x[:-1]) and not d[0, -1].any()
    assert torch.equal(d[1, :, :-1], x[:, 1:] - x[:, :-1])
    # ||K|| <= 2 (sqrt 2 an axis), ||D|| <= 4: tau = (sqrt 20 - 2) / 16
    assert P.tau == pytest.approx((math.sqrt(20) - 2) / 16, rel=1e-6)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_passes(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    r = _run(workload, control=torch.bfloat16)
    assert not r["correct"], r["checks"]


def _step_unchanged(monkeypatch, workload):
    from pyxu_tpu_torch.opt.solver import CondatVu
    monkeypatch.setattr(CondatVu, "m_step", lambda self, mst: mst)
    monkeypatch.setattr(CondatVu, "_m_refresh", lambda self, mst: None,
                        raising=False)


def _answer_altered(monkeypatch, workload):
    from pyxu_tpu_torch.abc.solver import Solver
    sol = Solver.solution

    def altered(self):
        return 1.01 * sol(self)

    monkeypatch.setattr(Solver, "solution", altered)


@pytest.mark.parametrize("fault", [_step_unchanged, _answer_altered],
                         ids=["step_unchanged", "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_fails(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    r = _run(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_card(workload):
    """The program's bfloat16 path at the cell's own size, 3 seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (3000000101, 3000000102, 3000000103):
        r = harness.run_cell(workload, seed, 3.0, False,
                             control=torch.bfloat16, log=lambda s: None)
        assert not r["correct"], r["checks"]
