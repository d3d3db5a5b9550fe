"""The port's design-space explorer against the JAX package's, on the CPU.

Names are content-addressed (a hash of the template's parameter JSON), so
the first check is that every point of every named space gets the JAX
package's ``gen/<hash>`` name and spec JSON.  Then the frontier
(``Frontier.as_dict()``, Table-2 GOPS and Qwen2-1.5B smoke tokens/s),
the SLO re-rank, ``ground``'s provenance and validation, and the CLIs'
text must be the JAX package's.  The cost models are held batch against
batch (``simulate_batch``, ``Calibrator.design_matrix``) and scalar
against scalar (``simulate``, ``design_matrix_scalar``): the JAX
package's batched and scalar simulators differ in the last ulp
(ROADMAP queue 3), so never across.  Exact equality throughout, as the
reference's tests hold determinism (``tests/test_design.py``).
"""
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro import design as jdesign
from repro import machines as jmachines
from repro.configs import get_config as jget_config
from repro.core import simulator as jsimulator
from repro.core import variants as jvariants
from repro.design import __main__ as jcli
from repro.machines.calibrate import Calibrator as JCalibrator
from repro.measure import SampleStore as JSampleStore
from repro.measure.campaign import grid_problems as jgrid_problems
from repro_torch import design, machines
from repro_torch.configs import get_config
from repro_torch.core import simulator, variants
from repro_torch.design import __main__ as cli
from repro_torch.machines.calibrate import Calibrator
from repro_torch.measure import SampleStore
from repro_torch.measure.campaign import grid_problems

QWEN = "qwen2-1.5b"


@pytest.fixture(autouse=True)
def _clean_registries():
    before, jbefore = set(machines.list_machines()), \
        set(jmachines.list_machines())
    yield
    machines.unregister_prefix("gen/")
    jmachines.unregister_prefix("gen/")
    for name in set(machines.list_machines()) - before:
        machines.unregister(name)
    for name in set(jmachines.list_machines()) - jbefore:
        jmachines.unregister(name)


def _points(space_name):
    """A named space's points in both packages (the 10^4-point ``wide``
    space by a Halton sample)."""
    got, want = design.get_space(space_name), jdesign.get_space(space_name)
    assert repr(got) == repr(want) and len(got) == len(want)
    if space_name == "wide":
        return got.sample(48, method="halton"), \
            want.sample(48, method="halton")
    return list(got.points()), list(want.points())


# ---------------------------------------------------------------------------
# Content-addressed names, specs, sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("space", ["smoke", "gap9-sweep", "gap9-wide",
                                   "wide"])
def test_gen_names_and_specs_are_the_jax_packages(space):
    got, want = _points(space)
    assert [p.index for p in got] == [p.index for p in want]
    assert [p.name for p in got] == [p.name for p in want]
    assert [p.label() for p in got] == [p.label() for p in want]
    for p, q in zip(got, want):
        assert p.template.design_id() == q.template.design_id()
        spec, jspec = p.spec(), q.spec()
        assert spec.to_json() == jspec.to_json()
        assert spec.fingerprint() == jspec.fingerprint()
        assert design.template_of(spec).params() == p.template.params()


@pytest.mark.parametrize("method", ["grid", "halton"])
@pytest.mark.parametrize("n", [1, 5, 17])
def test_sampling_picks_the_jax_packages_points(method, n):
    for name in ("gap9-sweep", "wide"):
        got = design.get_space(name).sample(n, method=method)
        want = jdesign.get_space(name).sample(n, method=method)
        assert [p.index for p in got] == [p.index for p in want]
        assert [p.name for p in got] == [p.name for p in want]


def test_derived_templates_name_like_the_jax_packages():
    base, jbase = design.AcceleratorTemplate(), jdesign.AcceleratorTemplate()
    assert base.name == jbase.name
    for f in (0.5, 2.0, 3.0):
        assert base.scaled_bandwidth(f).name == \
            jbase.scaled_bandwidth(f).name
    t = base.with_params(family="x", lanes=16, energy_per_op_pj=0.7,
                         dtype_rates=(("int8", 1.0), ("bf16", 0.5)))
    jt = jbase.with_params(family="x", lanes=16, energy_per_op_pj=0.7,
                           dtype_rates=(("int8", 1.0), ("bf16", 0.5)))
    assert t.name == jt.name and t.area_proxy() == jt.area_proxy()
    assert t.expand().to_json() == jt.expand().to_json()


# ---------------------------------------------------------------------------
# The cost models under the frontier: batch vs batch, scalar vs scalar
# ---------------------------------------------------------------------------


def _specs(index):
    got, want = _points("smoke")
    return got[index].spec(), want[index].spec()


@pytest.mark.parametrize("index", [0, 5])
@pytest.mark.parametrize("policy", ["analytic", "padded"])
def test_simulators_price_a_design_like_the_jax_packages(index, policy):
    spec, jspec = _specs(index)
    probs = [variants.Problem(p.m, p.n, p.k, p.elem_bytes)
             for p in grid_problems("table2", "int8")]
    jprobs = [jvariants.Problem(p.m, p.n, p.k, p.elem_bytes)
              for p in jgrid_problems("table2", "int8")]
    for v, jv in zip(variants.Variant, jvariants.Variant):
        got = simulator.simulate_batch(spec, probs, v, policy=policy)
        want = jsimulator.simulate_batch(jspec, jprobs, jv, policy=policy)
        assert [str(m) for m in got.micro_kernels] == \
            [str(m) for m in want.micro_kernels]
        assert np.array_equal(got.total, want.total)
        assert np.array_equal(got.arith, want.arith)
        mks = got.micro_kernels[::7]
        for p, jp in zip(probs[::5], jprobs[::5]):
            for mk in mks:
                a = simulator.simulate(spec, v, mk, p, policy=policy)
                b = jsimulator.simulate(jspec, jv,
                                        jvariants.MicroKernel(mk.rows,
                                                              mk.cols), jp,
                                        policy=policy)
                assert a.components == b.components
                assert a.total == b.total


# ---------------------------------------------------------------------------
# Scoring and the frontier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("space,sample", [("smoke", None),
                                          ("gap9-sweep", 12)])
def test_frontier_is_the_jax_packages(space, sample):
    got = design.score_designs(design.get_space(space), sample=sample)
    want = jdesign.score_designs(jdesign.get_space(space), sample=sample)
    assert [s.as_dict() for s in got] == [s.as_dict() for s in want]
    f, jf = design.pareto(got), jdesign.pareto(want)
    assert f.as_dict() == jf.as_dict()
    assert f.table() == jf.table()
    assert machines.list_machines("gen/*") == []


def test_model_frontier_and_slo_rerank_are_the_jax_packages():
    cfg, jcfg = get_config(QWEN, smoke=True), jget_config(QWEN, smoke=True)
    pts, jpts = _points("smoke")
    got = design.score_designs(pts, cfg=cfg, batch=4, precision="int8xint8")
    want = jdesign.score_designs(jpts, cfg=jcfg, batch=4,
                                 precision="int8xint8")
    assert [s.as_dict() for s in got] == [s.as_dict() for s in want]
    f = design.pareto(design.score_designs(pts, cfg=cfg, batch=4),
                      workload="decode")
    jf = jdesign.pareto(jdesign.score_designs(jpts, cfg=jcfg, batch=4),
                        workload="decode")
    assert f.as_dict() == jf.as_dict()
    for kw in ({"slo": {"p99_latency_s": 10.0}},
               {"slo": 0.35, "utilization": 0.9}):
        ranked = design.rerank_by_slo(f, pts, cfg, batch=4, requests=60,
                                      **kw)
        jranked = jdesign.rerank_by_slo(jf, jpts, jcfg, batch=4,
                                        requests=60, **kw)
        assert ranked == jranked and ranked


# ---------------------------------------------------------------------------
# Grounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index,overhead", [(3, False), (0, True)])
def test_ground_is_the_jax_packages(tmp_path, index, overhead):
    pts, jpts = _points("smoke")
    # one store path in both (provenance records it), in turn
    path = str(tmp_path / "design.jsonl")
    store = SampleStore(path)
    truth = design.synthetic_truth(pts[index].spec(), bw=0.7, arith=0.85)
    jtruth = jdesign.synthetic_truth(jpts[index].spec(), bw=0.7, arith=0.85)
    camp = design.sample_design(pts[index], store, grid="smoke",
                                truth=truth)
    got = design.ground(pts[index], store, date="2026-08-08",
                        overhead_per_block=overhead)
    os.remove(path)
    jstore = JSampleStore(path)
    jcamp = jdesign.sample_design(jpts[index], jstore, grid="smoke",
                                  truth=jtruth)
    assert [s.seconds for s in camp.samples] == \
        [s.seconds for s in jcamp.samples]
    assert [s.micro_kernel for s in camp.samples] == \
        [s.micro_kernel for s in jcamp.samples]
    want = jdesign.ground(jpts[index], jstore, date="2026-08-08",
                          overhead_per_block=overhead)
    assert got.spec.to_json() == want.spec.to_json()
    assert got.spec.provenance["grounded"] is True
    assert got.mape == want.mape
    assert got.fit.residual_rms_s == want.fit.residual_rms_s
    # the fit's design matrix: batch == batch, scalar == scalar
    mks = [variants.MicroKernel(*map(int, s.micro_kernel.split("x")))
           for s in camp.samples]
    probs = [s.problem for s in camp.samples]
    cal = Calibrator(pts[index].spec(), model="blis", policy="padded")
    jcal = JCalibrator(jpts[index].spec(), model="blis", policy="padded")
    jmks = [jvariants.MicroKernel(mk.rows, mk.cols) for mk in mks]
    jprobs = [s.problem for s in jcamp.samples]
    for fn in ("design_matrix", "design_matrix_scalar"):
        a, cols = getattr(cal, fn)(probs, mks, overhead_per_block=overhead)
        b, jcols = getattr(jcal, fn)(jprobs, jmks,
                                     overhead_per_block=overhead)
        assert cols == jcols and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["expand", "--space", "gap9-sweep", "--limit", "10"],
    ["sweep", "--space", "smoke", "--limit", "3", "--grid", "smoke"],
    ["frontier", "--space", "smoke"],
    ["frontier", "--space", "gap9-sweep", "--sample", "6", "--method",
     "halton", "--arch", QWEN, "--smoke", "--batch", "4", "--slo-p99",
     "0.35", "--rps", "2", "--requests", "40"],
], ids=["expand", "sweep", "frontier", "frontier-slo"])
def test_cli_prints_the_jax_packages_text(argv):
    assert _run(cli.main, argv) == _run(jcli.main, argv)
    assert machines.list_machines("gen/*") == []


def test_cli_ground_and_json_are_the_jax_packages(tmp_path):
    base = ["ground", "--space", "smoke", "--index", "2", "--synthetic",
            "--grid", "smoke", "--date", "2026-08-08"]
    got = _run(cli.main, base + ["--store", str(tmp_path / "t.jsonl"),
                                 "--out", str(tmp_path / "t")])
    want = _run(jcli.main, base + ["--store", str(tmp_path / "j.jsonl"),
                                   "--out", str(tmp_path / "j")])
    assert got == (want[0], want[1].replace(str(tmp_path / "j"),
                                            str(tmp_path / "t")))
    assert "grounded gen/gap9ish-" in got[1]
    argv = ["frontier", "--space", "smoke", "--json"]
    _run(cli.main, argv + [str(tmp_path / "f.json")])
    _run(jcli.main, argv + [str(tmp_path / "jf.json")])
    with open(tmp_path / "f.json") as f, open(tmp_path / "jf.json") as g:
        assert json.load(f) == json.load(g)
