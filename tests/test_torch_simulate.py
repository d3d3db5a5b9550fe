"""The port's serving simulator against the JAX package's, on the CPU.

The simulator is config-only in both packages, so parity is exact: the
same service prices and the same traffic seed give the same
``SimReport.to_json()`` (every policy, fault scenario, deadline and queue
limit), the same ``ServiceModel.from_plans`` prices on the
``analytic-tpu`` and ``analytic-gap8`` backends, the same
``ReplayReport.to_json()`` for one recorded trace (the JAX engine's smoke
trace and the port engine's, measured and model mode), and the same CLI
text.  The reference's tolerances are exact equality for these reports
(``tests/test_simulate.py`` compares them with ``==``), so these tests do
too.
"""
import copy
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import pytest
import torch

from repro import simulate as jsim
from repro.configs import get_config as jget_config
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.simulate import __main__ as jcli
from repro_torch import simulate as sim
from repro_torch.configs import get_config
from repro_torch.models.model import LM
from repro_torch.serving.buckets import PREFILL_BUCKETS
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.simulate import __main__ as cli
from repro_torch.simulate.replay import check_trace

QWEN = "qwen2-1.5b"
#: the prompts of tests/test_simulate.py's engine trace
PROMPTS = [[5, 6, 7, 8], [1, 2, 3], [9, 4, 2, 7, 5, 3], [11, 12], [4, 4, 4]]


def _service(pkg, decode=0.01, prefill=None):
    return pkg.ServiceModel(
        decode_step_s=decode,
        prefill_s=prefill or {b: 0.05 * b / 32 for b in PREFILL_BUCKETS})


def _traffic(pkg, kind, seed):
    lengths = dict(prompt_len=(4, 200), decode_len={"kind": "geometric",
                                                    "lo": 2, "mean": 12.0})
    if kind == "bursty":
        return pkg.BurstyTraffic(rate=30.0, burst=5, seed=seed, **lengths)
    return pkg.make_traffic(kind, rate=30.0, seed=seed, **lengths)


# ---------------------------------------------------------------------------
# Traffic, faults, the event queue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["poisson", "uniform", "bursty"])
def test_traffic_streams_are_the_jax_packages(kind):
    got = [r.as_dict() for r in _traffic(sim, kind, 3).requests(300)]
    want = [r.as_dict() for r in _traffic(jsim, kind, 3).requests(300)]
    assert got == want
    assert _traffic(sim, kind, 3).name == _traffic(jsim, kind, 3).name


def test_fault_registry_and_surges_are_the_jax_packages():
    assert sorted(sim.SCENARIOS) == sorted(jsim.SCENARIOS)
    for name in sim.SCENARIOS:
        got, want = sim.SCENARIOS[name], jsim.SCENARIOS[name]
        assert got.as_dict() == want.as_dict()
        assert [r.as_dict() for r in got.surge_requests()] == \
            [r.as_dict() for r in want.surge_requests()]
        gf, wf = got.failures(), want.failures()
        assert [next(gf, None) for _ in range(20)] == \
            [next(wf, None) for _ in range(20)]
        assert [got.service_scale(t / 4) for t in range(80)] == \
            [want.service_scale(t / 4) for t in range(80)]


def test_event_queue_runs_ties_in_schedule_order_like_the_jax_packages():
    def run(pkg):
        s = pkg.Simulator(seed=5, horizon=3.0)
        order = []
        for i, t in enumerate((1.0, 0.5, 1.0, 2.5, 0.5, 4.0, 1.0)):
            ev = s.schedule_at(t, lambda i=i: order.append((i, s.now)))
            if i == 2:
                ev.cancel()
        s.schedule(0.5, lambda: s.schedule(0.0, lambda: order.append("n")))
        return order, s.run(), s.events_processed, s.rng.random()

    assert run(sim) == run(jsim)


# ---------------------------------------------------------------------------
# The slot server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["greedy", "one-per-step", "drain-first"])
@pytest.mark.parametrize("faults", [None, "throttle20", "flaky-slots",
                                    "flash-crowd", "storm"])
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_sim_report_json_is_the_jax_packages(policy, faults, kind):
    def run(pkg):
        return pkg.simulate_serving(
            _service(pkg), _traffic(pkg, kind, 11), max_batch=4,
            max_len=256, policy=policy, requests=120, faults=faults,
            config={"machine": "m", "dtype": "bf16"}).to_json()

    got = run(sim)
    assert got == run(jsim)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(run(jsim), sort_keys=True)


@pytest.mark.parametrize("deadline,queue_limit,horizon", [
    (0.5, None, None), (None, 6, None), (0.8, 4, None), (None, None, 2.0)])
def test_shedding_and_horizon_reports_are_the_jax_packages(deadline,
                                                           queue_limit,
                                                           horizon):
    def run(pkg):
        rep = pkg.simulate_serving(
            _service(pkg, decode=0.03), _traffic(pkg, "poisson", 2),
            max_batch=2, requests=150, deadline_s=deadline,
            queue_limit=queue_limit, horizon=horizon, faults="storm",
            decision_step_s=0.02)
        return rep.to_json(), rep.table(), rep.shed_fraction, rep.finite

    got = run(sim)
    assert got == run(jsim)
    # the knobs really bite: something was shed or left unfinished
    report = got[0]
    assert report["requests"]["shed"] or report["requests"]["unfinished"]


@pytest.mark.parametrize("backend,machine,dtype", [
    ("analytic-tpu", "tpu-v5e", "bf16"), ("analytic-tpu", None, "int8"),
    ("analytic-gap8", "gap9-fc", "int8")])
def test_service_model_prices_are_the_jax_packages(backend, machine, dtype):
    got = sim.ServiceModel.from_plans(
        get_config(QWEN, smoke=True), batch=4, machine=machine, dtype=dtype,
        backend=backend, max_len=256)
    want = jsim.ServiceModel.from_plans(
        jget_config(QWEN, smoke=True), batch=4, machine=machine, dtype=dtype,
        backend=backend, max_len=256)
    assert got.decode_step_s == want.decode_step_s
    assert dict(got.prefill_s) == dict(want.prefill_s)
    assert got.buckets == want.buckets


def test_service_model_prices_the_card_on_the_hopper_model():
    cfg = get_config(QWEN)
    svc = sim.ServiceModel.from_plans(cfg, batch=4, machine="h100-measured",
                                      backend="cuda", max_len=256)
    assert set(svc.prefill_s) == {32, 64, 128, 256}
    assert 0 < svc.decode_step_s < svc.prefill_s[256]


# ---------------------------------------------------------------------------
# SLO selection (config-only)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("faults,p99", [(None, 0.35), ("throttle20", 0.35),
                                       ("throttle20", 2.0)])
def test_slo_selection_is_the_jax_packages(faults, p99):
    from repro.serving.report import plan_deployment as jplan
    from repro_torch.serving.report import plan_deployment

    def run(pkg, plan, cfg):
        report = plan(cfg, machines=("gap9-fc",), batches=(1, 2, 4, 8, 16))
        try:
            sel = pkg.evaluate_deployment(
                cfg, report, slo=pkg.SLO(p99_latency_s=p99),
                traffic=pkg.PoissonTraffic(rate=5, prompt_len=16,
                                           decode_len=16, seed=0),
                requests=150, faults=faults,
                policies=("greedy", "one-per-step"))
        except ValueError as e:
            return str(e), report.to_json()
        return sel.as_dict(), report.to_json()

    got = run(sim, plan_deployment, get_config(QWEN, smoke=True))
    assert got == run(jsim, jplan, jget_config(QWEN, smoke=True))
    if faults is None:
        assert got[0]["batch"] == 4 and any(
            r["batch"] == 16 and r["reason"] == "slo_p99_latency_exceeded"
            for r in got[0]["rejected"])
    elif p99 < 1.0:
        # under the throttle no cell holds the tight bound: the error
        # names every cell, and the report records the fault rejections
        assert got[0].startswith("no (machine, dtype, batch, policy) cell")
        assert all(r["reason"] == "fault_slo_p99_latency_exceeded"
                   for r in got[1]["rejected"])


# ---------------------------------------------------------------------------
# Replay of a recorded engine trace
# ---------------------------------------------------------------------------


def _drain(engine, request_cls):
    for i, p in enumerate(PROMPTS):
        engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=4 + i))
    return engine.run_until_drained()


@pytest.fixture(scope="module")
def traces():
    """The JAX engine's smoke trace (``tests/test_simulate.py``'s) and the
    port engine's, on the same prompts.  Each engine plans its frozen
    decode GEMMs before the traced drain, as autoconfigure does: planned
    lazily, the first plan would fall between two stamped steps, outside
    every step's ``dt``."""
    jlm = JLM(jget_config(QWEN, smoke=True), JHOST_MESH)
    jvalues, _ = split_params(jlm.init(jax.random.key(0)))
    jeng = JServingEngine(jlm, jvalues, max_batch=3, max_len=128)
    jeng.decision_step_s()
    _drain(jeng, JRequest)
    lm = LM(get_config(QWEN, smoke=True), device="cpu")
    eng = ServingEngine(lm, lm.init(torch.Generator().manual_seed(0)),
                        max_batch=3, max_len=128)
    eng.decision_step_s()
    done = _drain(eng, Request)
    return {"jax": jeng.trace_json(), "port": eng.trace_json(),
            "port_done": done}


def _with_deadlines(trace):
    """The trace with a deadline on every request and a decision price
    that makes the odd requests' deadlines unmeetable: the replay's shed
    path."""
    trace = copy.deepcopy(trace)
    for e in trace["events"]:
        if e["type"] == "submit":
            e["deadline_s"] = 0.01 if e["rid"] % 2 else 10.0
    trace["predicted_step_s"] = 0.01
    return trace


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("mode", ["measured", "model", "deadlines"])
def test_replay_report_is_the_jax_packages(traces, source, mode):
    trace = traces[source]
    if mode == "deadlines":
        trace = _with_deadlines(trace)

    def run(pkg):
        svc = None
        if mode == "model":
            svc = pkg.ServiceModel(decode_step_s=0.05, prefill_s={32: 0.08})
        rep = pkg.replay(trace, svc)
        return rep.to_json(), rep.table(limit=3)

    got = run(sim)
    assert got == run(jsim)
    report = got[0]
    assert report["schema"] == "repro.simulate/replay-v1"
    if mode == "deadlines":
        assert sorted(report["shed"]["sim"]) == [1, 3]
        assert not report["shed"]["match"]
        assert report["sim_order"] == [0, 2, 4]
        return
    assert report["order_match"] and report["steps_real"] == \
        report["steps_sim"]
    if mode == "measured":
        assert all(row["ape"] < 0.02 for row in report["rows"])
        assert report["mape_pct"] < 2.0


def test_replay_of_the_port_engine_reads_its_requests_back(traces):
    trace, done = traces["port"], traces["port_done"]
    reqs = sim.trace_requests(trace)
    assert sim.trace_traffic(trace).requests() == reqs
    assert [r.decode_len for r in sorted(reqs, key=lambda r: r.rid)] == \
        [len(r.generated) for r in sorted(done, key=lambda r: r.rid)]
    assert [r.as_dict() for r in reqs] == \
        [r.as_dict() for r in jsim.trace_requests(trace)]
    with pytest.raises(ValueError, match="unknown trace schema"):
        check_trace(dict(trace, schema="repro.serving/trace-v0"))


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["sweep", "--arch", QWEN, "--smoke", "--machine", "gap9-fc",
     "--batches", "1", "2", "4", "8", "16", "--rate", "5", "--prompt-len",
     "16", "--slo-p99", "0.35", "--requests", "150"],
    ["sweep", "--arch", QWEN, "--smoke", "--machine", "gap9-fc",
     "--batches", "16", "--rate", "5", "--slo-p99", "0.35",
     "--requests", "60"],
    ["sweep", "--arch", QWEN, "--smoke", "--machine", "gap9-fc",
     "--batches", "2", "4", "--rate", "5", "--slo-p99", "0.5",
     "--requests", "80", "--faults", "storm", "--deadline", "2.0",
     "--policies", "greedy", "drain-first"],
    ["run", "--arch", QWEN, "--machine", "tpu-v5e", "--batch", "8",
     "--rate", "200", "--requests", "300", "--traffic", "bursty",
     "--prompt-len", "8:100", "--decode-len", "geo:24"],
    ["run", "--arch", QWEN, "--smoke", "--machine", "tpu-v5e",
     "--requests", "100", "--faults", "flaky-slots", "--queue-limit", "4"],
], ids=["sweep-picks-4", "sweep-infeasible", "sweep-faults", "run-bursty",
        "run-faults"])
def test_cli_prints_the_jax_packages_text(argv):
    got = _run(cli.main, argv)
    assert got == _run(jcli.main, argv)
    if argv[-1] == "150":
        out = got[1]
        assert "selected: gap9-fc dtype=bf16 max_batch=4" in out
        row16 = [ln for ln in out.splitlines()
                 if ln.startswith("gap9-fc") and ln.split()[2] == "16"]
        assert row16 and "slo_p99_latency_exceeded" in row16[0]


@pytest.mark.parametrize("extra", [[], ["--model", "--smoke", "--machine",
                                        "gap9-fc", "--backend",
                                        "analytic-gap8", "--dtype", "int8"]],
                         ids=["measured", "model"])
def test_cli_replay_prints_the_jax_packages_text(traces, tmp_path, extra):
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump(traces["port"], f)
    argv = ["replay", "--trace", path, "--limit", "4", *extra]
    got = _run(cli.main, argv + ["--json", str(tmp_path / "t.json")])
    want = _run(jcli.main, argv + ["--json", str(tmp_path / "j.json")])
    assert got[0] == want[0] == 0
    assert got[1].replace("t.json", "j.json") == want[1]
    with open(tmp_path / "t.json") as f, open(tmp_path / "j.json") as g:
        assert json.load(f) == json.load(g)
