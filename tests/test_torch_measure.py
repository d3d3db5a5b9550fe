"""The port's measure→fit→validate loop against ``repro.measure``.

The simulated closed loop is deterministic, so the two packages must give
identical samples, fitted rates and MAPE; stores and manifests written by
one are read by the other.  The ``cuda`` harness is exercised on the CPU
(``device="cpu"``, the plain versions), and its default device is the card.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro import machines as jmachines
from repro import measure as jmeasure
from repro_torch import gemm, machines, measure
from repro_torch.machines.calibrate import Calibrator
from repro_torch.measure.__main__ import main


@pytest.fixture(autouse=True)
def _clean_registries():
    before = (set(machines.list_machines()), set(jmachines.list_machines()))
    yield
    for pkg, names in ((machines, before[0]), (jmachines, before[1])):
        for name in set(pkg.list_machines()) - names:
            pkg.unregister(name)
        pkg.load_zoo()


def _template(pkg, name):
    """gap8-fc's geometry with deliberately wrong rates."""
    return pkg.get("gap8-fc").scaled(arith=3.0, bw=0.4, name=name)


@pytest.mark.parametrize("grid,dtype", [("table2", None), ("smoke", "int8")])
def test_simulated_closed_loop_matches_reference(tmp_path, grid, dtype):
    out = {}
    for tag, pkg, mpkg in (("jax", jmeasure, jmachines),
                           ("torch", measure, machines)):
        store = str(tmp_path / f"{tag}.jsonl")
        template = _template(mpkg, "gap8-parity-seed")
        res = pkg.run_campaign(grid, machine=template, harness="simulated",
                               truth=mpkg.get("gap8-fc"), dtype=dtype,
                               store=store)
        spec, rep = pkg.fit_from_store(store, template, name="gap8-parity",
                                       date=None)
        val = pkg.validate_spec(spec, store)
        out[tag] = (res, spec, rep, val)
    (jres, jspec, jrep, jval), (tres, tspec, trep, tval) = out["jax"], \
        out["torch"]
    assert [s.to_json() for s in jres.samples] == \
        [s.to_json() for s in tres.samples]
    assert jrep.columns == trep.columns
    np.testing.assert_array_equal(jrep.inverse_rates, trep.inverse_rates)
    assert jspec.fingerprint() == tspec.fingerprint()
    assert dict(jspec.transfer_rates) == dict(tspec.transfer_rates)
    assert jval.mape == tval.mape
    assert tval.mape == pytest.approx(0.0, abs=1e-6)


def test_store_written_by_reference_is_fitted_by_port(tmp_path):
    store = str(tmp_path / "jax.jsonl")
    jtemplate = _template(jmachines, "gap8-xpkg-seed")
    jmeasure.run_campaign("table2", machine=jtemplate, harness="simulated",
                          truth=jmachines.get("gap8-fc"), store=store)
    jspec, jrep = jmeasure.fit_from_store(store, jtemplate,
                                          name="gap8-xpkg", date=None)
    ttemplate = _template(machines, "gap8-xpkg-seed")
    assert ttemplate.geometry_fingerprint() == \
        jtemplate.geometry_fingerprint()
    tspec, trep = measure.fit_from_store(store, ttemplate, name="gap8-xpkg",
                                         date=None)
    assert tspec.to_json() == jspec.to_json()
    # the manifest the port writes is read back by the JAX package
    path = tspec.to_manifest(str(tmp_path / "gap8-xpkg.json"))
    assert jmachines.MachineSpec.from_manifest(path).fingerprint() == \
        jspec.fingerprint()
    assert measure.validate_spec(tspec, store).mape == \
        jmeasure.validate_spec(jspec, store).mape


def test_tile_model_fit_recovers_rates_from_tile_samples(tmp_path):
    """Samples of a tile backend carry a tile, not a micro-kernel;
    ``fit_from_store`` fits ``analytic-tpu`` samples with the TPU tile
    model on their recorded tiles (k-inner and k-outer), recovering the
    rates that made them.  (``cuda`` samples are fitted with the Hopper
    model: ``tests/test_torch_hopper_model.py``.)  The cuda backend runs
    the same tiles pinned."""
    from repro_torch.core.tpu_model import GridOrder, TileConfig
    from repro_torch.measure.harness import TimingResult

    truth = machines.get("h100").scaled(arith=0.02, bw=0.5,
                                        name="h100-truth")
    store = measure.SampleStore(str(tmp_path / "tiles.jsonl"))
    shapes = [(256, 512, 1024), (1024, 256, 512), (512, 512, 4096),
              (64, 4096, 256), (2048, 128, 1024), (128, 128, 8192)]
    tiles = [TileConfig(64, 128, 128), TileConfig(128, 64, 256,
                                                  GridOrder.K_OUTER)]
    plans = [gemm.plan(s, backend="analytic-tpu", machine="h100",
                       dtype="bf16", tile=t, cache=False)
             for s in shapes for t in tiles]
    cal = Calibrator(truth, model="pallas")
    A, cols = cal.design_matrix([p.problem for p in plans],
                                tiles=[p.selection for p in plans])
    x = [1.0 / truth.rate("M", "L1"), 1.0 / truth.rate("L1", "R"),
         1.0 / truth.arith_rate["bf16"]]
    assert cols == ["rate:M->L1", "rate:L1->R", "arith:bf16"]
    for p, t in zip(plans, A @ np.array(x)):
        store.append(measure.Sample.from_measurement(
            p, TimingResult(float(t), 1, 1, 0.0, (float(t),)), "cuda",
            machines.get("h100")))
    spec, rep = measure.fit_from_store(store, "h100", name="h100-recovered",
                                       date=None, weighting="absolute")
    assert not rep.dropped
    assert spec.rate("M", "L1") == pytest.approx(truth.rate("M", "L1"),
                                                 rel=1e-6)
    assert spec.arith_rate["bf16"] == pytest.approx(
        truth.arith_rate["bf16"], rel=1e-6)
    assert spec.provenance["fit"]["cost_model"] == {"model": "pallas"}
    assert spec.provenance["base"] == "h100"
    for t in tiles:
        p = gemm.plan(shapes[0], backend="cuda", machine="h100",
                      dtype="f32", tile=t, cache=False)
        a, b = torch.randn(256, 1024), torch.randn(1024, 512)
        torch.testing.assert_close(p.execute(a, b), a.double().mm(
            b.double()).float(), rtol=1e-4, atol=1e-3)


def test_tile_design_matrix_matches_reference_when_tiles_are_searched():
    from repro.machines.calibrate import Calibrator as JCalibrator
    probs = [(4096, 2048, 1536), (512, 196, 4608), (32, 12544, 27)]
    A, cols = Calibrator("tpu-v5e", model="pallas").design_matrix(probs)
    jA, jcols = JCalibrator("tpu-v5e", model="pallas").design_matrix(probs)
    assert cols == jcols
    np.testing.assert_array_equal(A, jA)


def test_fit_refuses_a_store_mixing_cost_models(tmp_path):
    store = str(tmp_path / "mixed.jsonl")
    template = _template(machines, "gap8-mixed-seed")
    measure.run_campaign("smoke", machine=template, harness="simulated",
                         truth=machines.get("gap8-fc"), dtype="int8",
                         store=store)
    measure.run_campaign("smoke", machine=template, harness="simulated",
                         truth=machines.get("gap8-fc"), dtype="int8",
                         backend="analytic-tpu", store=store)
    with pytest.raises(ValueError, match="mixes BLIS-model and tile-model"):
        measure.fit_from_store(store, template, date=None)


def test_cli_run_fit_validate_simulated(tmp_path, capsys):
    store = str(tmp_path / "cli.jsonl")
    assert main(["run", "--grid", "smoke", "--backend", "simulated",
                 "--truth", "gap8-fc", "--machine", "gap8-fc",
                 "--dtype", "int8", "--store", store]) == 0
    assert "24 samples via simulated" in capsys.readouterr().out
    assert main(["fit", "--store", store, "--template", "gap8-fc",
                 "--name", "gap8-cli-fit", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "fitted gap8-cli-fit" in out and "rate:M->L2" in out
    manifest = str(tmp_path / "gap8-cli-fit.json")
    report = str(tmp_path / "report.json")
    assert main(["validate", "--store", store, "--machine", manifest,
                 "--json", report]) == 0
    assert "MAPE 0.00%" in capsys.readouterr().out
    assert main(["report", "--json", report, "--limit", "2"]) == 0
    with open(report) as f:
        assert json.load(f)["schema"] == "repro.measure/validation-v1"


def test_cuda_harness_on_cpu_times_the_plain_versions(tmp_path):
    h = measure.get_harness("cuda", device="cpu")
    plan = gemm.plan((96, 80, 200), backend="cuda", machine="h100",
                     dtype="bf16")
    a1, b1 = h.operands(plan.problem, seed=3)
    a2, b2 = h.operands(plan.problem, seed=3)
    assert a1.dtype == torch.bfloat16 and a1.device.type == "cpu"
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    t = h.measure(plan, timing={"warmup": 0, "rounds": 1}, seed=3)
    assert t.seconds > 0 and math.isfinite(t.seconds)
    res = measure.run_campaign("smoke", harness="cuda", machine="h100",
                               device="cpu", dtype="int8",
                               timing={"warmup": 0, "rounds": 1},
                               store=str(tmp_path / "cpu.jsonl"))
    assert {s.backend for s in res.samples} == {"cuda"}
    assert all(s.tile and s.micro_kernel is None for s in res.samples)


def test_measure_cli_defaults_to_the_card(monkeypatch, tmp_path, capsys):
    """``run`` defaults to --backend cuda --machine h100; without a card it
    fails and names the missing device instead of timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["run", "--grid", "smoke", "--store",
               str(tmp_path / "none.jsonl")])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "none.jsonl").exists()
