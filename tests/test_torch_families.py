"""The port's model families against the JAX package, on the CPU.

zamba2 (Mamba2 + one shared attention block), xlstm (mLSTM + sLSTM),
paligemma (vision patches as a bidirectional prefix) and musicgen (audio
frame embeddings) at their smoke widths, in f32, with the JAX package's
weights carried across by ``interop.load_jax_params``: the prefill logits
and four ``decode_step`` logits equal the JAX LM's at rtol = atol = 1e-4,
the tolerance ``tests/test_torch_serving.py`` holds granite and qwen2 to.
xlstm-125m also at its published widths (the absolute part of the
tolerance taken relative to the largest |logit|).  Within the port: decode
equals prefill with ``tests/test_models.py``'s bounds (2e-2 for attention
archs, 0.06 of the largest |logit| for recurrent ones), and the engine
equals sequential greedy decode (f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import load_jax_params
from repro_torch.launch import serve
from repro_torch.models import model as model_mod
from repro_torch.models.common import HOST_MESH, MeshInfo
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine

FAMILIES = ["zamba2-1.2b", "xlstm-125m", "paligemma-3b", "musicgen-medium"]
#: the prompts of tests/test_runtime.py::test_engine_matches_sequential_greedy
PROMPTS = [[5, 6, 7, 8], [1, 2, 3], [9, 4, 2, 7, 5, 3], [11, 12]]


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               kv_cache_dtype="float32")


def _carried(arch, seed, smoke=True):
    """(port LM, its values, JAX LM, JAX values), f32, the JAX package's
    weights in both."""
    cfg = _f32(get_config(arch, smoke=smoke))
    jlm = JLM(_f32(jget_config(arch, smoke=smoke)), JHOST_MESH)
    jvalues, _ = split_params(jlm.init(jax.random.key(seed)))
    lm = LM(cfg, HOST_MESH, device="cpu")
    values = load_jax_params(lm, jax.tree.map(np.array, jvalues))
    return lm, values, jlm, jvalues


def _batch(cfg, b, s, seed):
    """A prefill batch as numpy arrays: tokens; patches before them
    (vision); frames instead of them (audio)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": rng.normal(size=(b, s, cfg.d_model))
                .astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s))}
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.normal(
            size=(b, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _step_input(cfg, b, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(b, 1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_logits_match_jax(arch):
    lm, values, jlm, jvalues = _carried(arch, seed=0)
    cfg = lm.cfg
    batch = _batch(cfg, 2, 12, 1)
    jlogits, jcaches = jlm.prefill(jvalues, {k: jnp.array(v)
                                             for k, v in batch.items()})
    logits, caches = lm.prefill(values, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert logits.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    # the prefill caches (every leaf, every period) are the JAX package's
    for i, period in enumerate(caches["stack"]):
        for key, cache in period.items():
            for leaf, val in cache.items():
                np.testing.assert_allclose(
                    val.numpy(), np.asarray(jcaches["stack"][key][leaf])[i],
                    rtol=1e-4, atol=1e-4)

    jc, _ = split_params(jlm.init_cache(2, 16))
    c = lm.init_cache(2, 16)
    params = lm.compute_params(values)
    for step in range(4):
        tok = _step_input(cfg, 2, 2 + step)
        pos = np.array([step, 2 * step + 1])
        jl, jc = jlm.decode_step(jvalues, jc, jnp.array(tok), jnp.array(pos))
        lg, c = lm.decode_step(params, c, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


def test_xlstm_125m_at_published_widths_matches_jax():
    lm, values, jlm, jvalues = _carried("xlstm-125m", seed=0, smoke=False)
    assert lm.cfg.d_model == 768 and lm.cfg.n_layers == 12
    toks = np.random.default_rng(3).integers(0, lm.cfg.vocab_size,
                                             size=(1, 16))
    jlogits, _ = jlm.prefill(jvalues, {"tokens": jnp.array(toks)})
    logits, _ = lm.prefill(values, {"tokens": torch.from_numpy(toks)})
    # 12 layers of sums 768 to 1536 long: the smoke widths' 1e-4, taken
    # relative to the largest |logit| for the absolute part
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_the_shared_block_is_one_set_of_tensors():
    cfg = get_config("zamba2-1.2b", smoke=True)
    lm = LM(cfg, device="cpu")
    values = lm.init(torch.Generator().manual_seed(0))
    params = lm.compute_params(values)
    sites = [ppath for kind, ppath, _ in lm._layout()
             if kind == "shared_attn"]
    assert len(sites) == cfg.block_pattern.count("shared_attn") == 2
    for tree in (values, params):
        blocks = [model_mod._get(tree, p) for p in sites]
        assert all(b is tree["shared"] for b in blocks)
        for period in tree["stack"]:
            assert not any(k.endswith("shared_attn") for k in period)
    # one parameter per JAX leaf: the block is not copied per site
    jvalues, _ = split_params(JLM(jget_config("zamba2-1.2b", smoke=True),
                                  JHOST_MESH).init(jax.random.key(0)))
    n_jax = sum(np.shape(v)[0] if path[0].key == "stack" else 1
                for path, v in jax.tree_util.tree_leaves_with_path(jvalues))
    assert len(list(lm.parameters())) == n_jax
    # each site keeps its own KV cache
    caches = lm.init_cache(2, 8)
    site_caches = [model_mod._get(caches, c) for kind, _, c in lm._layout()
                   if kind == "shared_attn"]
    assert site_caches[0]["k"] is not site_caches[1]["k"]
    # at full width: six sites, all on the one block
    full = LM(get_config("zamba2-1.2b"), device="cpu")
    assert [p for kind, p, _ in full._layout() if kind == "shared_attn"] \
        == [("shared",)] * 6


@pytest.mark.parametrize("arch,recurrent", [
    ("zamba2-1.2b", True), ("xlstm-125m", True), ("musicgen-medium", False),
    ("paligemma-3b", False), ("qwen2-7b", False), ("stablelm-12b", False)])
def test_decode_matches_prefill(arch, recurrent):
    """bf16 as the configs serve: a decode loop over the sequence ends on
    the prefill's logits (``tests/test_models.py``'s bounds)."""
    cfg = get_config(arch, smoke=True)
    lm = LM(cfg, device="cpu")
    params = lm.compute_params(lm.init(torch.Generator().manual_seed(1)))
    b, s = 2, 12
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, b, s, 2).items()}
    if cfg.frontend == "vision_stub":
        # the patches' prefix, then the tokens one at a time
        full, _ = lm.prefill(params, batch)
        _, caches = lm.prefill(params, dict(batch,
                                            tokens=batch["tokens"][:, :-1]))
        c = lm.init_cache(b, cfg.num_prefix_tokens + s + 4)
        _copy_prefix(c, caches)
        lg, _ = lm.decode_step(params, c, batch["tokens"][:, -1:],
                               cfg.num_prefix_tokens + s - 1)
    else:
        full, _ = lm.prefill(params, batch)
        c = lm.init_cache(b, s + 4)
        steps = batch["frames"] if "frames" in batch else batch["tokens"]
        for t in range(s):
            lg, c = lm.decode_step(params, c, steps[:, t:t + 1], t)
    lg, full = lg.float(), full.float()
    if recurrent:
        scale = full.abs().max().item() + 1e-6
        assert (lg - full).abs().max().item() / scale < 0.06
    else:
        np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=2e-2,
                                   atol=2e-2)


def _copy_prefix(caches, pref):
    """Copy a prefill's caches into the front of decode caches."""
    if isinstance(caches, dict):
        for k in caches:
            _copy_prefix(caches[k], pref[k])
    elif isinstance(caches, list):
        for c, p in zip(caches, pref):
            _copy_prefix(c, p)
    else:
        caches[tuple(slice(0, n) for n in pref.shape)] = \
            pref.to(caches.dtype)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_engine_matches_sequential_greedy(arch):
    cfg = _f32(get_config(arch, smoke=True))
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

    eng = ServingEngine(lm, values, max_batch=3, max_len=128)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    got = {r.rid: r.generated for r in eng.run_until_drained()}
    assert got == {i: reference(p, 5) for i, p in enumerate(PROMPTS)}
    # recurrent archs prefill at the exact prefix length, never a bucket
    admits = [e for e in eng.trace_events if e["type"] == "admit"]
    assert [e["bucket"] for e in admits] == [len(p) - 1 for p in PROMPTS]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_lm_builds_every_arch(arch):
    cfg = get_config(arch, smoke=True)
    lm = LM(cfg, device="cpu")
    values = lm.init(torch.Generator().manual_seed(0))
    assert ("proj" in values["frontend"]) == (cfg.frontend != "none")
    assert ("shared" in values) == cfg.shared_block
    caches = lm.init_cache(2, 8)
    params = lm.compute_params(values)
    tok = torch.zeros((2, 1, cfg.d_model)) if cfg.frontend == "audio_stub" \
        else torch.zeros((2, 1), dtype=torch.long)
    logits, _ = lm.decode_step(params, caches, tok, 0)
    assert logits.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()


def test_only_meshes_are_refused():
    """Meshes are no longer refused (MeshInfo describes one); an unknown
    block kind still is."""
    assert MeshInfo(data=2).data == 2
    cfg = get_config("zamba2-1.2b", smoke=True)
    with pytest.raises(ValueError, match="unknown block kind"):
        LM(dataclasses.replace(cfg, block_pattern=("rwkv",) * cfg.n_layers),
           device="cpu")


def test_serve_cli_serves_a_recurrent_arch_on_the_cpu(capsys):
    assert serve.main(["--device", "cpu", "--arch", "zamba2-1.2b",
                       "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
