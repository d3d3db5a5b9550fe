"""The port's serving path against the JAX package, on the CPU, at smoke size.

Attention, the LM's prefill and decode logits, and the serving engine's
generated tokens are held against ``repro`` on the same inputs and the
same weights (the JAX package's, carried across by
``interop.load_jax_params``), in f32: greedy decoding is only exact in
f32, as ``tests/test_runtime.py::test_engine_matches_sequential_greedy``
notes.  The JAX package runs its CPU path (the ``reference`` GEMM backend,
``grouped_gemm_ref``); the port runs its kernels' plain versions because
its tensors lie on the CPU.

Tolerances: attention 1e-5 (f32, another order of the same sums); logits
rtol = atol = 1e-4 over a few layers; tokens exactly.  The engine seeds
were checked for near-ties: in the JAX runs no greedy step has a top-2
logit gap under 1e-5.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import gemm
from repro_torch.configs import get_config
from repro_torch.interop import load_jax_params
from repro_torch.kernels import grouped_gemm as G
from repro_torch.kernels.gemm import check_tile, launch_config
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models.common import HOST_MESH
from repro_torch.models.model import LM
from repro_torch.models.moe import _capacity
from repro_torch.serving import PREFILL_BUCKETS
from repro_torch.serving.engine import Request, ServingEngine

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ["granite-moe-3b-a800m", "qwen2-1.5b"]
#: the prompts of tests/test_runtime.py::test_engine_matches_sequential_greedy
PROMPTS = [[5, 6, 7, 8], [1, 2, 3], [9, 4, 2, 7, 5, 3], [11, 12]]


def _f32(arch, **kw):
    """The smoke config in f32 compute and KV cache, for both packages."""
    kw = {"compute_dtype": "float32", "kv_cache_dtype": "float32", **kw}
    return (dataclasses.replace(get_config(arch, smoke=True), **kw),
            dataclasses.replace(jget_config(arch, smoke=True), **kw))


def _carried(arch, seed, **kw):
    """(port LM, its values, JAX LM, JAX values) with the JAX package's
    weights in both."""
    cfg, jcfg = _f32(arch, **kw)
    jlm = JLM(jcfg, JHOST_MESH)
    jvalues, _ = split_params(jlm.init(jax.random.key(seed)))
    lm = LM(cfg, HOST_MESH, device="cpu")
    values = load_jax_params(lm, jax.tree.map(np.array, jvalues))
    return lm, values, jlm, jvalues


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,prefix_len,chunk", [
    (True, 0, 16), (True, 5, 16), (False, 0, 64), (True, 0, 1024)])
def test_blockwise_attention_matches_jax(causal, prefix_len, chunk):
    q, k, v = (_np((2, 40, 4, 16), s) for s in (1, 2, 3))
    want = jattn.blockwise_attention(jnp.array(q), jnp.array(k), jnp.array(v),
                                     chunk=chunk, causal=causal,
                                     prefix_len=prefix_len)
    got = attn.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                   chunk=chunk, causal=causal,
                                   prefix_len=prefix_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("per_slot", [True, False])
def test_decode_attention_matches_jax(arch, kv, per_slot):
    cfg, jcfg = _f32(arch, kv_cache_dtype=kv)
    jp, _ = split_params(jattn.init_attention(jax.random.key(0), jcfg,
                                              JHOST_MESH, jnp.float32))
    if "bq" in jp:                     # non-zero biases exercise the adds
        jp = dict(jp, **{n: jnp.array(_np(jp[n].shape, i))
                         for i, n in enumerate(("bq", "bk", "bv"))})
    b, max_len = 3, 24
    jcache, _ = split_params(jattn.init_kv_cache(jcfg, JHOST_MESH, b,
                                                 max_len, jnp.float32))
    # a cache already holding a history (int8 entries with their scales)
    hist = {n: (np.random.default_rng(9).integers(-127, 128, size=c.shape)
                .astype(np.int8) if c.dtype == jnp.int8
                else np.abs(_np(c.shape, 10)) * 0.01 if "scale" in n
                else _np(c.shape, 11))
            for n, c in jcache.items()}
    jcache = {n: jnp.array(v) for n, v in hist.items()}
    cache = {n: torch.from_numpy(v.copy()) for n, v in hist.items()}
    p = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    x = _np((b, 1, cfg.d_model), 12)
    pos = np.array([5, 0, 17]) if per_slot else 9
    jout, jnew = jattn.decode_attention(jp, jcache, jnp.array(x), jcfg,
                                        JHOST_MESH, pos=jnp.array(pos))
    out, new = attn.decode_attention(p, cache, torch.from_numpy(x), cfg,
                                     HOST_MESH, pos=torch.tensor(pos))
    assert new is cache                          # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for n in hist:
        if kv == "int8" and n in ("k", "v"):
            # a rounding tie may land one int8 step apart
            assert np.abs(new[n].numpy().astype(int)
                          - np.asarray(jnew[n]).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(new[n].numpy(), np.asarray(jnew[n]),
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    lm, values, jlm, jvalues = _carried(arch, seed=0)
    cfg = lm.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 12))
    jlogits, jcaches = jlm.prefill(jvalues, {"tokens": jnp.array(toks)})
    logits, caches = lm.prefill(values, {"tokens": torch.from_numpy(toks)})
    assert logits.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    jk = np.asarray(jcaches["stack"]["b0_" + cfg.block_pattern[0]]["k"])
    for i, period in enumerate(caches["stack"]):
        np.testing.assert_allclose(
            period["b0_" + cfg.block_pattern[0]]["k"].numpy(), jk[i],
            rtol=1e-4, atol=1e-4)

    jc, _ = split_params(jlm.init_cache(2, 16))
    c = lm.init_cache(2, 16)
    params = lm.compute_params(values)
    for step in range(3):
        tok = np.random.default_rng(2 + step).integers(
            0, cfg.vocab_size, size=(2, 1))
        pos = np.array([step, 2 * step + 1])
        jl, jc = jlm.decode_step(jvalues, jc, jnp.array(tok), jnp.array(pos))
        lg, c = lm.decode_step(params, c, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


def test_weight_carry_over_round_trips_and_checks_the_layout():
    lm, values, _, jvalues = _carried("granite-moe-3b-a800m", seed=4)
    n = lm.cfg.n_layers
    assert len(values["stack"]) == n
    seen = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jvalues):
        keys = [k.key for k in path]
        stacked = keys[0] == "stack"
        for i in range(n if stacked else 1):
            node = values["stack"][i] if stacked else values
            for key in keys[1:] if stacked else keys:
                node = node[key]
            want = np.asarray(leaf)[i] if stacked else np.asarray(leaf)
            np.testing.assert_array_equal(node.numpy(), want)
            seen += 1
    assert seen == len(list(lm.parameters()))

    vals = jax.tree.map(np.array, jvalues)
    missing = dict(vals, final_norm={})
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(lm, missing)
    extra = dict(vals, embed=dict(vals["embed"],
                                  unembed=np.zeros((64, 512), np.float32)))
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(lm, extra)
    short = dict(vals, final_norm={"scale": np.ones(63, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(lm, short)


def test_compute_copy_is_made_once():
    cfg, _ = _f32("granite-moe-3b-a800m")
    lm = LM(dataclasses.replace(cfg, compute_dtype="bfloat16"),
            device="cpu")
    values = lm.init(torch.Generator().manual_seed(0))
    params = lm.compute_params(values)
    head = params["embed"]["head"]
    # tied: the head is the compute table's .t(), a view, not a copy
    assert head.dtype == torch.bfloat16 and head.t().is_contiguous()
    assert head.data_ptr() == params["embed"]["table"].data_ptr()
    assert tuple(head.shape) == (cfg.d_model, cfg.padded_vocab)
    assert params["stack"][0]["b0_moe"]["norm1"]["scale"].dtype == \
        torch.float32
    again = lm.compute_params(params)            # no copies the second time
    assert again["embed"]["head"] is head
    assert again["stack"][1]["b0_moe"]["moe"]["w_up"] is \
        params["stack"][1]["b0_moe"]["moe"]["w_up"]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _serve(engine, prompts):
    for i, p in enumerate(prompts):
        engine.submit((JRequest if isinstance(engine, JServingEngine)
                       else Request)(rid=i, prompt=p, max_new_tokens=5))
    done = engine.run_until_drained()
    return {r.rid: r.generated for r in done}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_the_jax_engine(arch):
    lm, values, jlm, jvalues = _carried(arch, seed=3)
    jeng = JServingEngine(jlm, jvalues, max_batch=3, max_len=128)
    eng = ServingEngine(lm, values, max_batch=3, max_len=128)
    want, got = _serve(jeng, PROMPTS), _serve(eng, PROMPTS)
    assert got == want
    # the same report (plus the port's note on its machine) and the same
    # sequence of trace-v1 events
    report, jreport = eng.perf_report(), jeng.perf_report()
    assert set(report) == set(jreport) | {"machine"}
    assert report["machine"]["name"] == "h100"
    assert report["machine"]["uncalibrated"] is True
    assert set(report["measured_requests"]) == \
        set(jreport["measured_requests"])
    assert [e["type"] for e in eng.trace_events] == \
        [e["type"] for e in jeng.trace_events]
    trace = eng.trace_json()
    assert trace["schema"] == "repro.serving/trace-v1"
    assert set(trace) == set(jeng.trace_json())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_sequential_greedy(arch):
    cfg, _ = _f32(arch)
    lm = LM(cfg, device="cpu")
    values = lm.init(torch.Generator().manual_seed(3))
    params = lm.compute_params(values)

    def reference(prompt, n_new):
        caches = lm.init_cache(1, 128)
        toks = list(prompt)
        for t in range(len(prompt) + n_new - 1):
            logits, caches = lm.decode_step(params, caches,
                                            torch.tensor([[toks[t]]]), t)
            if t >= len(prompt) - 1:
                logits[..., cfg.vocab_size:] = -1e9
                toks.append(int(torch.argmax(logits, dim=-1)[0]))
        return toks[len(prompt):]

    got = _serve(ServingEngine(lm, values, max_batch=3, max_len=128),
                 PROMPTS)
    assert got == {i: reference(p, 5) for i, p in enumerate(PROMPTS)}


def test_engine_resilience_knobs_report_like_the_jax_engine():
    lm, values, jlm, jvalues = _carried("qwen2-1.5b", seed=3)
    kw = dict(max_batch=2, max_len=64, deadline_s=60.0, queue_limit=8)
    jeng, eng = JServingEngine(jlm, jvalues, **kw), ServingEngine(lm, values,
                                                                  **kw)
    assert _serve(eng, PROMPTS) == _serve(jeng, PROMPTS)
    res, jres = eng.perf_report()["resilience"], \
        jeng.perf_report()["resilience"]
    assert set(res) == set(jres)
    assert res["shed"] == jres["shed"] == {"count": 0, "causes": {}}


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


def test_serve_cli_serves_on_the_cpu_when_asked(capsys):
    assert serve.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                       "--requests", "4", "--max-new", "6"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests, 24 tokens" in out


def test_serve_cli_takes_every_flag_of_the_reference(tmp_path, capsys):
    """Every flag of ``repro.launch.serve`` is ported (``--ckpt-dir`` came
    with the checkpoint manager; ``test_torch_checkpoint.py`` serves
    checkpoints of both trainers through it), and a directory without a
    checkpoint serves the seeded random weights."""
    import re
    flags = {}
    for pkg in ("repro", "repro_torch"):
        with open(os.path.join(ROOT, "src", pkg, "launch", "serve.py")) as f:
            flags[pkg] = set(re.findall(r'add_argument\("(--[a-z0-9-]+)"',
                                        f.read()))
    assert "--ckpt-dir" in flags["repro"]
    assert flags["repro"] <= flags["repro_torch"]
    assert serve.NOT_PORTED == {}
    assert serve.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                       "--requests", "1", "--max-new", "2", "--ckpt-dir",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "served 1 requests" in out and "serving checkpoint" not in out


def test_serving_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_demo("granite-moe-3b-a800m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(get_config("granite-moe-3b-a800m", smoke=True))
    assert serve.main(["--arch", "granite-moe-3b-a800m"]) == 2


def test_serve_module_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for hosts without")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-moe-3b-a800m"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "served" not in out.stdout


def test_full_width_granite_shapes_have_tiles_the_kernels_take():
    """The card's kernels refuse tiles they were not built for; the shapes
    that serving granite at full width gives them must all be accepted, and
    so must the ``gemm.matmul`` shapes of the model families at full width
    (zamba2's shared MLP and every family's logits; recurrent archs
    prefill at every exact length, the vision prefix adds its patches)."""
    cfg = get_config("granite-moe-3b-a800m")
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for m in (1, 2, 3, 4):                  # logits: prefill + decode
            t = gemm.plan((m, cfg.padded_vocab, cfg.d_model), backend="cuda",
                          dtype=tag).selection
            launch_config(t, tag)
        caps = {_capacity(1, cfg) * b for b in (1, 4)}
        caps |= {_capacity(s, cfg) for s in PREFILL_BUCKETS if s <= 256}
        for c in sorted(caps):
            G.check_tile(G.grouped_tile(c, dt), dt)
    for arch in ("zamba2-1.2b", "xlstm-125m", "paligemma-3b",
                 "musicgen-medium"):
        fam = get_config(arch)
        shapes = {(fam.padded_vocab, fam.d_model)}      # logits
        if fam.d_ff:                                    # the (shared) MLP
            shapes |= {(fam.d_ff, fam.d_model), (fam.d_model, fam.d_ff)}
        ms = set(range(1, 17)) | {32, 64, 127, 128, 255, 256}
        if fam.frontend == "vision_stub":
            ms |= {fam.num_prefix_tokens + m for m in (1, 12, 256)}
        for tag in ("bf16", "f32"):
            for m in sorted(ms):
                for n, k in sorted(shapes):
                    t = gemm.plan((m, n, k), backend="cuda",
                                  dtype=tag).selection
                    launch_config(t, tag)
                    if tag == "bf16":
                        check_tile(t, tag)


def test_mesh_info_builds_and_follows_the_jax_divisibility_rule():
    """MeshInfo is the JAX package's description: a mesh builds, and
    shard_if / fsdp_if shard a dim only when the axis divides it."""
    from repro.models.common import MeshInfo as JMeshInfo
    from repro_torch.models.common import MeshInfo

    for kw in ({"data": 2}, {"data": 2, "model": 4, "fsdp": True},
               {"data": 32, "model": 16, "data_axes": ("pod", "data"),
                "fsdp": True}):
        mi, jmi = MeshInfo(**kw), JMeshInfo(**kw)
        assert dataclasses.asdict(mi) == dataclasses.asdict(jmi)
        assert mi.dp() == jmi.dp()
        for size in (1, 2, 3, 4, 6, 16, 28, 32, 151936):
            assert mi.shard_if(size) == jmi.shard_if(size)
            assert mi.fsdp_if(size) == jmi.fsdp_if(size)
    assert MeshInfo(data=2).fsdp_if(8) is None           # FSDP off
    assert MeshInfo(model=4).shard_if(6) is None          # 4 does not divide 6
