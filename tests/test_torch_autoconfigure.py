"""``ServingEngine.autoconfigure`` and the serve CLI's autoconfigure flags
against the JAX package's, on the CPU, at smoke size.

Both engines autoconfigure the same model config on ``gap9-fc`` (the
``analytic-tpu`` default backend, as in the JAX package) and must hold
equal ``autoconfig`` dicts in throughput, SLO and robust mode (exact, as
the deployment report and the simulator are byte-equal).  The SLO-
configured port engine, with the JAX package's weights carried across
(``interop.load_jax_params``), generates the JAX engine's tokens in f32:
greedy decoding is only exact in f32 (``tests/test_torch_serving.py``).
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.simulate import SLO as JSLO
from repro.simulate import PoissonTraffic as JPoissonTraffic
from repro_torch.configs import get_config
from repro_torch.interop import load_jax_params
from repro_torch.launch import serve
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.simulate import SLO, PoissonTraffic
from repro_torch.simulate.autoconf import REJECT_SLO_P99

QWEN = "qwen2-1.5b"
GRID = dict(machine="gap9-fc", batches=(1, 2, 4, 8, 16), max_len=512)
PROMPTS = [[5, 6, 7, 8], [1, 2, 3], [9, 4, 2, 7, 5, 3], [11, 12]]


def _mode_kwargs(mode, pkg_slo, pkg_traffic):
    """autoconfigure's keyword arguments of one mode, for one package."""
    traffic = pkg_traffic(rate=5, prompt_len=16, decode_len=16, seed=0)
    if mode == "throughput":
        return {}
    if mode == "slo":
        return dict(slo=pkg_slo(p99_latency_s=0.35), traffic=traffic,
                    sim_requests=150)
    if mode == "robust":
        return dict(slo=pkg_slo(p99_latency_s=2.0), traffic=traffic,
                    robust=True, sim_requests=100)
    return dict(slo={"p99_latency_s": 5.0}, faults="flaky-slots",
                deadline_s=30.0, queue_limit=16, sim_requests=80,
                dtypes=("bf16", "int8"), precisions=("int8xint8",),
                sim_policies=("greedy", "one-per-step"))


@pytest.fixture(scope="module")
def carried():
    """(port LM, its values, JAX LM, JAX values): the JAX package's
    weights in both, f32 compute and KV cache."""
    kw = {"compute_dtype": "float32", "kv_cache_dtype": "float32"}
    jcfg = dataclasses.replace(jget_config(QWEN, smoke=True), **kw)
    jlm = JLM(jcfg, JHOST_MESH)
    jvalues, _ = split_params(jlm.init(jax.random.key(3)))
    lm = LM(dataclasses.replace(get_config(QWEN, smoke=True), **kw),
            device="cpu")
    values = load_jax_params(lm, jax.tree.map(np.array, jvalues))
    return lm, values, jlm, jvalues


@pytest.mark.parametrize("mode", ["throughput", "slo", "robust", "knobs"])
def test_autoconfig_is_the_jax_packages(carried, mode):
    lm, values, jlm, jvalues = carried
    eng = ServingEngine.autoconfigure(
        lm, values, **GRID, **_mode_kwargs(mode, SLO, PoissonTraffic))
    jeng = JServingEngine.autoconfigure(
        jlm, jvalues, **GRID, **_mode_kwargs(mode, JSLO, JPoissonTraffic))
    assert eng.autoconfig == jeng.autoconfig
    assert json.dumps(eng.autoconfig, sort_keys=True) == \
        json.dumps(jeng.autoconfig, sort_keys=True)
    assert eng.deployment_report.to_json() == jeng.deployment_report.to_json()
    assert eng.max_batch == jeng.max_batch
    assert [p.describe() for p in eng.gemm_plans] == \
        [p.describe() for p in jeng.gemm_plans]
    assert eng.perf_report()["autoconfig"] == eng.autoconfig
    assert eng.lm.device == torch.device("cpu")
    if mode == "slo":
        peak = ServingEngine.autoconfigure(lm, values, **GRID)
        assert eng.max_batch < peak.max_batch
        ac = eng.autoconfig["slo"]
        assert ac["policy"] == "greedy"
        assert any(r["reason"] == REJECT_SLO_P99 and r["batch"] ==
                   peak.max_batch for r in ac["rejected"])
    if mode in ("robust", "knobs"):
        assert eng.autoconfig["slo"]["faults"] == \
            ("throttle20" if mode == "robust" else "flaky-slots")


def test_slo_configured_engine_generates_the_jax_engines_tokens(carried):
    lm, values, jlm, jvalues = carried
    eng = ServingEngine.autoconfigure(
        lm, values, **GRID, **_mode_kwargs("slo", SLO, PoissonTraffic))
    jeng = JServingEngine.autoconfigure(
        jlm, jvalues, **GRID, **_mode_kwargs("slo", JSLO, JPoissonTraffic))

    def serve_all(engine, request_cls):
        for i, p in enumerate(PROMPTS):
            engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=5))
        return {r.rid: r.generated for r in engine.run_until_drained()}

    assert serve_all(eng, Request) == serve_all(jeng, JRequest)
    assert len(eng.finished) == len(PROMPTS)


def test_autoconfigure_refuses_robust_without_an_slo(carried):
    lm, values, _, _ = carried
    with pytest.raises(ValueError, match="needs an slo"):
        ServingEngine.autoconfigure(lm, values, robust=True, **GRID)
    with pytest.raises(ValueError, match="no .* cell attains the SLO"):
        ServingEngine.autoconfigure(lm, values, slo=1e-9, sim_requests=20,
                                    **GRID)


def test_autoconfigure_prices_the_card_when_asked(carried):
    lm, values, _, _ = carried
    eng = ServingEngine.autoconfigure(
        lm, values, machine="h100-measured", backend="cuda",
        dtypes=("f32", "bf16"), max_len=256, slo=SLO(p99_latency_s=0.35),
        traffic=PoissonTraffic(rate=5, prompt_len=16, decode_len=12, seed=0))
    ac = eng.autoconfig
    assert ac["backend"] == "cuda" and ac["machine"] == "h100-measured"
    assert ac["dtype"] == ac["native_dtype"] == "f32"
    assert {p.backend for p in eng.gemm_plans} == {"cuda"}
    assert eng.perf_report()["machine"]["name"] == "h100-measured"


# ---------------------------------------------------------------------------
# The serve entry point
# ---------------------------------------------------------------------------


def _printed(fn, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(**kw)
    return out, buf.getvalue()


@pytest.mark.parametrize("mode", ["slo", "robust"])
def test_serve_demo_autoconfigures_like_the_jax_package(mode):
    """The ranking table and the autoconfigured lines ``serve_demo``
    prints, up to the served run's own timings."""
    kw = dict(n_requests=3, max_new=4, autoconfigure=True,
              machine="gap9-fc", faults="throttle20" if mode == "robust"
              else None)
    _, got = _printed(serve.serve_demo, arch=QWEN, device="cpu",
                      slo=SLO(p99_latency_s=2.0 if mode == "robust"
                              else 0.35),
                      traffic=PoissonTraffic(rate=5, prompt_len=16,
                                             decode_len=4), **kw)
    _, want = _printed(jserve.serve_demo, arch=QWEN,
                       slo=JSLO(p99_latency_s=2.0 if mode == "robust"
                                else 0.35),
                       traffic=JPoissonTraffic(rate=5, prompt_len=16,
                                               decode_len=4), **kw)

    def head(text):
        return text.split("\nserved ")[0]

    assert head(got) == head(want)
    assert "autoconfigured: max_batch=" in got
    assert "served 3 requests, 12 tokens" in got


def test_serve_cli_takes_the_autoconfigure_flags(capsys, tmp_path):
    trace = str(tmp_path / "trace.json")
    assert serve.main(["--device", "cpu", "--arch", QWEN, "--autoconfigure",
                       "--machine", "gap9-fc", "--slo-p99", "0.35",
                       "--rate", "5", "--requests", "3", "--max-new", "4",
                       "--precision", "int8xint8", "--trace", trace]) == 0
    out = capsys.readouterr().out
    assert "autoconfigured: max_batch=2 dtype=bf16 machine=gap9-fc" in out
    assert "SLO mode (poisson@5rps)" in out
    assert "python -m repro_torch.simulate replay --trace" in out
    with open(trace) as f:
        assert json.load(f)["max_batch"] == 2
    assert serve.main(["--device", "cpu", "--arch", QWEN, "--autoconfigure",
                       "--backend", "cuda", "--no-memory", "--requests",
                       "2", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "machine=h100" in out and "served 2 requests" in out
    assert serve.NOT_PORTED == {}     # --ckpt-dir came with the checkpoints


def test_serve_cli_needs_an_slo_for_faults(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--autoconfigure", "--faults",
                    "throttle20"])
    assert e.value.code == 2
    assert "--faults needs --slo-p99" in capsys.readouterr().err
