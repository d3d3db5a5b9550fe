"""The port's host calibration (``repro_torch.core.calibrate``,
``Calibrator.measure_host``) and machine-zoo command line
(``python -m repro_torch.machines``) against the JAX package's."""
import dataclasses
import json

import pytest

from repro import machines as jmachines
from repro.core import calibrate as jcal
from repro.machines.__main__ import main as jmain
from repro_torch import machines, measure
from repro_torch.core import calibrate as tcal
from repro_torch.core.variants import MicroKernel
from repro_torch.machines.__main__ import main


@pytest.fixture(autouse=True)
def _clean_registries():
    before = (set(machines.list_machines()), set(jmachines.list_machines()))
    yield
    for pkg, names in ((machines, before[0]), (jmachines, before[1])):
        for name in set(pkg.list_machines()) - names:
            pkg.unregister(name)
        pkg.load_zoo()


def _fixed_rates(monkeypatch, *mods):
    """The micro-experiments replaced by fixed rates, fast and
    deterministic."""
    for mod in mods:
        monkeypatch.setattr(mod, "measure_packing_rate", lambda c: 2.0e9)
        monkeypatch.setattr(mod, "measure_copy_rate", lambda: 8.0e9)
        monkeypatch.setattr(mod, "measure_arith_rate", lambda: 5.0e10)


def test_core_calibrate_time_delegates_to_harness(monkeypatch):
    calls = []
    t = tcal._time(lambda: calls.append(1), reps=3)
    assert t > 0
    assert len(calls) >= 4        # 3 rounds + at least the 1 warmup call
    seen = {}
    from repro_torch.measure import harness

    def spy(fn, **kw):
        seen.update(kw)
        return harness.TimingResult(0.5, kw["rounds"], kw["rounds"], 0.0,
                                    (0.5,) * kw["rounds"])
    monkeypatch.setattr(harness, "time_callable", spy)
    assert tcal._time(lambda: None, reps=4) == 0.5
    assert seen == {"warmup": 1, "rounds": 4}


def test_measure_host_sheds_template_per_mk_table(monkeypatch):
    _fixed_rates(monkeypatch, tcal, jcal)
    for pkg in (machines, jmachines):
        stale = dataclasses.replace(
            pkg.get("host-cpu"), name="host-cpu",
            arith_per_mk={"f32": {"4x24": 1.0e9}})
        pkg.register(stale, overwrite=True)
    spec = machines.Calibrator.measure_host("host-shed-test")
    jspec = jmachines.Calibrator.measure_host("host-shed-test")
    assert spec.arith_per_mk == {}
    assert spec.arith_rate_for("f32", MicroKernel(4, 24)) == 5.0e10
    assert spec.to_json() == jspec.to_json()


def test_calibrate_host_wraps_pipeline(monkeypatch, tmp_path):
    """calibrate_host delegates to Calibrator.measure_host and the result
    feeds the registry; the spec (and its persisted manifest) is the
    reference's."""
    from repro_torch.core.mobilenet import TABLE2
    from repro_torch.core.simulator import search_batch

    _fixed_rates(monkeypatch, tcal, jcal)
    spec = tcal.calibrate_host("host-test", date="2026-07-27",
                               register=True)
    jspec = jcal.calibrate_host("host-test", date="2026-07-27")
    assert spec.rate("M", "M") == 2.0e9
    assert spec.rate("M", "L1") == 8.0e9
    assert spec.arith_rate["f32"] == 5.0e10
    assert spec.provenance["calibration"]["date"] == "2026-07-27"
    assert machines.get("host-test") is spec
    assert machines.source_of("host-test") == "calibrated"
    assert search_batch(spec, [TABLE2[0].problem])[0].total > 0
    assert spec.fingerprint() == jspec.fingerprint()
    again = machines.Calibrator.measure_host(
        "host-persisted", manifest_dir=str(tmp_path))
    path = tmp_path / "host-persisted.json"
    assert machines.MachineSpec.from_manifest(str(path)) == again


def test_calibration_methodology_runs():
    """Paper §3.2 on this host: rates positive, packing rate roughly
    monotone in chunk size (the paper's linearity claim, loosely), and the
    measured spec keeps the reference's manifest keys and levels."""
    spec = tcal.calibrate_host()
    assert spec.arith_rate["int8"] > 0
    r4 = tcal.measure_packing_rate(4, rows=512, cols=512)
    r32 = tcal.measure_packing_rate(32, rows=512, cols=512)
    assert r32 > r4 * 1.2          # bigger chunks pack faster
    jspec = jmachines.Calibrator.measure_host("host-cpu")
    assert spec.levels == jspec.levels
    assert set(spec.to_json()) == set(jspec.to_json())
    assert set(spec.transfer_rates) == set(jspec.transfer_rates)
    assert set(spec.arith_rate) == set(jspec.arith_rate)
    assert spec.arith_per_mk == jspec.arith_per_mk == {}
    assert spec.geometry_fingerprint() == jspec.geometry_fingerprint()


def test_cli_validate_list_and_show(capsys, tmp_path):
    assert main(["validate"]) == 0
    out = capsys.readouterr().out
    assert "manifests valid" in out and "FAIL" not in out
    assert "h100.json" in out and "levels=M/L2/L1/R" in out
    # the reference's validator passes over its own zoo the same way
    assert jmain(["validate"]) == 0
    jout = capsys.readouterr().out
    shared = [line for line in jout.splitlines() if "OK" in line]
    assert shared and all(line in out for line in shared)
    assert main(["list"]) == 0
    listed = capsys.readouterr().out
    assert "h100" in listed and "[zoo]" in listed
    assert main(["list", "tpu-*"]) == 0
    assert "h100" not in capsys.readouterr().out
    assert main(["show", "h100"]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["name"] == "h100"
    assert shown["call_costs"]["launch"] > 0
    assert machines.MachineSpec.from_json(shown) == machines.get("h100")
    # a broken manifest dir fails
    bad = dict(shown)
    bad["arith_rate"] = {}
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    assert main(["validate", "--dir", str(tmp_path)]) == 1


def test_cli_calibrate_runs_full_fit(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.machines calibrate --grid ...`` is the whole
    loop on the host: micro-experiment seed -> host-numpy campaign -> rate
    fit -> report, with the reference's sample count."""
    _fixed_rates(monkeypatch, tcal)
    store = str(tmp_path / "calib.jsonl")
    assert main(["calibrate", "--name", "host-cli-fit", "--grid", "smoke",
                 "--store", store, "--out", str(tmp_path),
                 "--date", "2026-07-27"]) == 0
    out = capsys.readouterr().out
    assert "measured 24 samples" in out and "validation MAPE" in out
    fitted = machines.get("host-cli-fit")
    assert machines.source_of("host-cli-fit") == "calibrated"
    assert fitted.provenance["fit"]["samples"] == 24
    assert len(measure.SampleStore(store)) == 24
    persisted = machines.MachineSpec.from_manifest(
        str(tmp_path / "host-cli-fit.json"))
    assert persisted == fitted
    # the JAX package reads the port's manifest to the same rates
    jspec = jmachines.MachineSpec.from_manifest(
        str(tmp_path / "host-cli-fit.json"))
    assert jspec.fingerprint() == fitted.fingerprint()
