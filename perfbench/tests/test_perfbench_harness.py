"""The harness on the CPU: ``BENCHMARK.json`` against the contract's
shape, every name found in its file, the work counts at the cells'
shapes, the import rules, a run without a card, and a cell added as new
files and entries only.

    python -m pytest perfbench/tests -q
"""

import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
PB = HERE.parent
REPO = PB.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(PB))

import harness  # noqa: E402
import importcheck  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SMALL = {"tv_deconv_4k": dict(frame=[64, 96])}


@pytest.fixture(scope="module")
def bench():
    return harness.spec()


def test_spec_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert (PB / "configs" / f"{c['name']}.py").is_file()
        assert (PB / "reference" / f"{c['name']}.py").is_file()
        cfg = json.loads((REPO / c["file"]).read_text())
        for k in c["reduced"]:
            assert k in cfg, k
        harness.load("work", cfg["work"]["iteration"])
    for w in bench["workloads"]:
        harness.read_json("traffic", w["traffic"])
        lim = harness.read_json("limits", w["name"])["limits"]
        assert lim and all(v > 0 for v in lim.values())
        c = harness.cell(bench, w["name"])
        assert {"setup_s", "solves_per_s"} <= {m["name"]
                                               for m in c["end_to_end"]}
        assert c["per_layer"]
    for m in bench["per_layer"]:
        assert callable(harness.load("metrics", m["name"]).read)


@pytest.mark.parametrize("name, cfg, want_bytes", [
    ("tv_step", "tv_deconv_4k", 28 * 2160 * 3840),
    ("stencil", "tv_deconv_4k", 40 * 2160 * 3840),
])
def test_work_bytes(name, cfg, want_bytes):
    """Bytes by hand: TV x, z (2), y read and x, z written, 4 bytes each;
    the stencils K, K^T (1 in, 1 out), D (1 in, 2 out), D^T (2 in, 1 out)."""
    c = json.loads((PB / "configs" / f"{cfg}.json").read_text())
    w = harness.load("work", name).work(c, {})
    assert w["bytes"] == want_bytes
    assert w["flops"] > 0


def test_bounds_from_peaks():
    pk = harness.load_here("peaks")
    w = {"bytes": 3.35e12, "flops": 1.0}
    assert pk.bound_s(w, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert pk.bound_s(w, "cpu") is None


def test_import_rules_hold():
    assert importcheck.offenders() == []


@pytest.mark.parametrize("line, bad", [
    ("import jax.numpy as jnp", "jax"),
    ("from pyxu_tpu.operator import Stencil", "pyxu_tpu"),
    ("import importlib; importlib.import_module('jaxlib')", "jaxlib"),
    ("import pyxu_tpu_torch", "pyxu_tpu_torch"),
    ("import pyxu_tpu_torch_extra", None),
])
def test_import_rules_catch(tmp_path, line, bad):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "x.py").write_text(line + "\n")
    got = importcheck.offenders(tmp_path)
    assert got == ([] if bad is None else [("reference/x.py", bad)])


def test_blocked_modules_whole_names():
    mods = {"pyxu_tpu_torch": 0, "pyxu_tpu_torch.ops": 0, "jaxtyping": 0,
            "pyxu_tpu.abc": 0, "jax": 0}
    assert harness.blocked_modules(mods) == ["jax", "pyxu_tpu.abc"]


def test_percentile():
    assert harness.percentile(list(range(1, 101)), 95) == pytest.approx(
        95.05)


def _env_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("BENCH_RUN", None)
    return env


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "tv4k.frames", "--seed", "3000000001", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, env=_env_without_card(), timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    """A checkout with only BENCHMARK.json and perfbench/ has no program."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "tv4k.nonneg", "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, env=dict(os.environ), timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_added_cell_is_files_and_entries(tmp_path, bench):
    """A new mix, its limits and a new per-layer metric, added as files
    and entries only, run through the unchanged harness."""
    root = tmp_path / "perfbench"
    shutil.copytree(PB, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "short.json").write_text(json.dumps(
        dict(loop="closed", clients=1, iterations=7, pool=2, sample=1)))
    (root / "limits" / "tv4k.short.json").write_text(json.dumps(
        harness.read_json("limits", "tv4k.frames")))
    (root / "metrics" / "solves_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['solves'])\n")
    b = json.loads(json.dumps(bench))
    b["workloads"].append(dict(name="tv4k.short", config="tv_deconv_4k",
                               traffic="short", chips=1, why="test"))
    b["per_layer"].append(dict(name="solves_seen", unit="solves",
                               better="higher", source="host_clock",
                               layer="frame loop", moves="solves_per_s",
                               workloads=["tv4k.short"]))
    r = harness.run_cell("tv4k.short", 5, 0.5, True, device="cpu", bench=b,
                         root=root, cfg_override=SMALL["tv_deconv_4k"],
                         log=lambda s: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["solves_seen"]["value"] >= 1
    assert list(r)[-1] == "checks"
    r = harness.run_cell("tv4k.short", 5, 0.5, False, device="cpu",
                         bench=b, root=root,
                         cfg_override=SMALL["tv_deconv_4k"],
                         log=lambda s: None)
    assert {"setup_s", "solves_per_s"} <= set(r["metrics"])
    assert all(math.isfinite(v["value"]) for v in r["metrics"].values())


def _main_on_cpu(monkeypatch, after=None):
    """``run.py``'s ``main`` with the card's look passed and the run made
    on the CPU at a small size; ``after`` runs once the run is over."""
    import torch
    run = harness.load_here("run")
    real = harness.run_cell

    def on_cpu(workload, seed, seconds, trace, **kw):
        kw.pop("t_start", None)
        r = real(workload, seed, 0.3, trace, device="cpu",
                 cfg_override=SMALL["tv_deconv_4k"],
                 traffic_override=dict(pool=2, sample=1),
                 log=lambda s: None, **kw)
        if after is not None:
            after()
        return r

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", on_cpu)
    return run.main(["--workload", "tv4k.frames", "--seed", "3000000002",
                     "--seconds", "1", "--trace", "0"])


def test_run_prints_its_result(monkeypatch, capsys):
    assert _main_on_cpu(monkeypatch) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] and list(last)[-1] == "checks"


def test_jax_loaded_after_the_window_stops_the_result(monkeypatch, capsys):
    """A module of JAX that comes in after the window has closed (in the
    check, the trace's reduction, a metric) still stops the result."""
    import types
    rc = _main_on_cpu(monkeypatch, after=lambda: monkeypatch.setitem(
        sys.modules, "jax", types.ModuleType("jax")))
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "jax" in out.err


class _Ev:
    """A profiler event as ``trace_reader`` reads it."""

    def __init__(self, name, dev, start, end, cid=0):
        self._v = (name, dev, start, end, cid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return False


def test_trace_puts_device_work_down_to_its_launch():
    """Spans end in no synchronise, so the device runs behind the host: a
    kernel that ``fit`` launched but that ran while the host was already
    in ``download`` is ``fit``'s; an idle gap is the part's that the host
    was in when it began; a device event with no launch in the trace goes
    by its own start."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    reader = harness.load_here("trace_reader")
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs = [_Ev("tv_step_kernel", gpu, 210, 240, 1),      # before its launch
           _Ev("bench.fit", cpu, 100, 200),
           _Ev("bench.download", cpu, 200, 260),
           _Ev("cudaLaunchKernel", cpu, 150, 152, 1),
           _Ev("cudaMemcpyAsync", cpu, 205, 206, 2),
           _Ev("Memcpy DtoH", gpu, 240, 250, 2),
           _Ev("Memset", gpu, 120, 125, 0)]
    res = SimpleNamespace(events=lambda: evs)
    tr = reader.reduce_trace(SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=res)))
    assert reader.part_device_ns(tr, "fit") == 30 + 5
    assert reader.part_device_ns(tr, "download") == 10
    assert tr["unlinked"] == 1
    assert tr["busy_s"] == pytest.approx(45e-9)
    assert tr["window_s"] == pytest.approx(160e-9)
    assert dict(tr["idle_gaps"]) == pytest.approx(
        {"fit": 105e-9, "download": 10e-9})
    assert reader.kernel_ns(tr, lambda n: "tv_step" in n) == 30
