"""The first slice of the port end to end, at smoke size, against the JAX
package: plan → execute → measure → fit → validate, and the Qwen2-1.5B
smoke config's GEMMs; plus the port's isolation from JAX and its refusal to
run on the CPU unless asked."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import gemm as jgemm
from repro import measure as jmeasure
from repro.configs import get_config as jget_config
from repro.core.autotune import model_gemm_shapes as jmodel_gemm_shapes
from repro.machines import MachineSpec as JMachineSpec
from repro_torch import gemm, machines, measure
from repro_torch.configs import get_config
from repro_torch.core.autotune import model_gemm_shapes
from repro_torch.interop import operands_from_numpy, require_device

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
H100_JSON = os.path.join(SRC, "repro_torch", "machines", "zoo", "h100.json")


@pytest.fixture(autouse=True)
def _clean_registry():
    before = set(machines.list_machines())
    yield
    for name in set(machines.list_machines()) - before:
        machines.unregister(name)
    machines.load_zoo()


#: the drivers outside the package that run on the port
DRIVERS = sorted(
    os.path.join(ROOT, where, name)
    for where in ("examples", "experiments")
    for name in os.listdir(os.path.join(ROOT, where))
    if name.endswith("_torch.py"))


def test_port_imports_without_jax_or_the_jax_package():
    assert len(DRIVERS) == 12, DRIVERS
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"for i, path in enumerate({DRIVERS!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'd{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if (m == 'jax' or m.startswith(('jax.', 'repro.')))\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 88
    # importing catches only the imports a module runs when it loads; an
    # import inside a function body runs when the function is called, so
    # every file is also read for ``import jax`` / ``import repro`` /
    # ``from repro...`` at any depth
    bad, files = [], 0
    paths = [os.path.join(dirpath, name)
             for dirpath, _, names in os.walk(os.path.join(SRC, "repro_torch"))
             for name in sorted(n for n in names if n.endswith(".py"))]
    for path in paths + DRIVERS:
        files += 1
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {m}"
                    for m in mods if m.split(".")[0] in ("jax", "repro")]
    assert files >= 100 and not bad, bad


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert not {m for m in mods if m == "jax" or m.startswith("jax.")}
    assert not {m for m in mods if m == "repro" or m.startswith("repro.")}
    assert {m for m in mods if m.startswith("repro_torch")}


def test_smoke_grid_loop_matches_reference(tmp_path):
    """plan (analytic-tpu vs pallas on h100) → execute (cuda at the same
    tile on the CPU vs interpret) → simulated measure → fit (tile model) →
    validate, both packages."""
    jh100 = JMachineSpec.from_manifest(H100_JSON)
    probs = measure.grid_problems("smoke", "f32")
    tplans = gemm.plan_many(probs, backend="analytic-tpu", machine="h100",
                            cache=False)
    jplans = jgemm.plan_many(jmeasure.grid_problems("smoke", "f32"),
                             backend="pallas", machine=jh100, cache=False)
    rng = np.random.default_rng(0)
    for tp, jp in zip(tplans, jplans):
        assert str(tp.selection) == str(jp.selection)
        p = tp.problem
        a = rng.normal(size=(p.m, p.k)).astype(np.float32)
        b = rng.normal(size=(p.k, p.n)).astype(np.float32)
        pinned = gemm.plan(p, backend="cuda", machine="h100",
                           tile=tp.selection, cache=False)
        got = pinned.execute(*operands_from_numpy(a, b, device="cpu"))
        want = jp.execute(jnp.array(a), jnp.array(b), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)

    truth = machines.get("h100").scaled(arith=0.02, bw=0.5,
                                        name="h100-smoke-truth")
    jtruth = jh100.scaled(arith=0.02, bw=0.5, name="h100-smoke-truth")
    tstore, jstore = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    tres = measure.run_campaign("smoke", machine="h100", harness="simulated",
                                truth=truth, backend="analytic-tpu",
                                store=tstore)
    jres = jmeasure.run_campaign("smoke", machine=jh100, harness="simulated",
                                 truth=jtruth, backend="pallas", store=jstore)
    assert [s.seconds for s in tres.samples] == \
        [s.seconds for s in jres.samples]
    assert [s.tile for s in tres.samples] == [s.tile for s in jres.samples]
    spec, rep = measure.fit_from_store(tstore, "h100", name="h100-smoke-fit",
                                       date=None, on_nonpositive="drop")
    report = measure.validate_spec(spec, tstore)
    assert report.finite and len(report.rows) == len(tres.samples)
    # the JAX package reads the fitted manifest and scores it identically
    path = spec.to_manifest(str(tmp_path / "h100-smoke-fit.json"))
    jreport = jmeasure.validate_spec(JMachineSpec.from_manifest(path),
                                     jres.samples)
    assert jreport.mape == pytest.approx(report.mape, rel=1e-12)


def test_qwen2_smoke_config_gemms_match_pallas():
    tshapes = model_gemm_shapes(get_config("qwen2-1.5b", smoke=True),
                                tokens=64)
    jshapes = jmodel_gemm_shapes(jget_config("qwen2-1.5b", smoke=True),
                                 tokens=64)
    tplans = gemm.plan_many(tshapes, backend="analytic-tpu", machine="h100")
    jplans = jgemm.plan_many(jshapes, backend="pallas",
                             machine=JMachineSpec.from_manifest(H100_JSON))
    rng = np.random.default_rng(1)
    for tp, jp in zip(tplans, jplans):
        assert str(tp.selection) == str(jp.selection)
        p = tp.problem
        a = rng.normal(size=(p.m, p.k)).astype(np.float32)
        b = rng.normal(size=(p.k, p.n)).astype(np.float32)
        ta, tb = operands_from_numpy(a, b, device="cpu", dtype="bf16")
        got = gemm.plan(p, backend="cuda", machine="h100", tile=tp.selection,
                        cache=False).execute(ta, tb)
        want = jp.execute(jnp.array(a, jnp.bfloat16),
                          jnp.array(b, jnp.bfloat16), interpret=True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)
    # the planned matmul folds leading dims like the reference's
    x = torch.randn(2, 32, 64, dtype=torch.bfloat16)
    w = torch.randn(64, 48, dtype=torch.bfloat16)
    out = gemm.matmul(x, w)
    assert out.shape == (2, 32, 48) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), (x.float() @ w.float()),
                               rtol=2e-2, atol=2e-2)


def test_default_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        operands_from_numpy(np.ones((2, 2), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.get_harness("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.run_campaign("smoke", harness="cuda", machine="h100",
                             dtype="bf16")


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for hosts without")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          "--out", str(tmp_path / "out")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    out = subprocess.run([sys.executable, str(alone / "chip_smoke.py")],
                         env=env, cwd=str(alone), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
