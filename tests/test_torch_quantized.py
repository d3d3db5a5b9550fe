"""The port's weight-only int8 quantisation against the JAX package, on the
CPU: twins of ``tests/test_quantized.py``'s value tests (the round trip's
error bound, small tensors kept, decode logits close to the float ones,
per-channel scales) and the round trip beside ``quantize_params`` /
``dequantize_params`` on the same weights: the int8 values exact, the
scales and the dequantised values f32 rtol 1e-6.  ``quantized_specs`` maps
sharding specs and waits for the multi-device queue.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.common import split_params
from repro.models.model import LM as JLM
from repro.runtime import quantized as jq
from repro_torch.configs import get_config
from repro_torch.interop import _unstack, load_jax_params
from repro_torch.models.model import LM
from repro_torch.runtime.quantized import (
    QuantizedTensor,
    dequantize_params,
    quantization_error,
    quantize_params,
)


def _lm(seed=0):
    lm = LM(get_config("qwen2-1.5b", smoke=True), device="cpu")
    return lm, lm.init(torch.Generator().manual_seed(seed))


def test_quantize_roundtrip_error_bounded():
    _, values = _lm()
    errs = quantization_error(values)
    assert errs, "expected at least one quantised leaf"
    assert max(errs.values()) < 1.0 / 127 + 1e-3   # per-channel symmetric
    assert "['embed']['table']" in errs


def test_small_tensors_not_quantized():
    tree = {"norm": torch.ones(64), "w": torch.ones(256, 256),
            "ids": torch.ones(256, 256, dtype=torch.int32)}
    q = quantize_params(tree, min_size=1 << 10)
    assert not isinstance(q["norm"], QuantizedTensor)
    assert not isinstance(q["ids"], QuantizedTensor)
    assert isinstance(q["w"], QuantizedTensor)
    assert q["w"].q.dtype == torch.int8 and q["w"].shape == (256, 256)


def test_quantized_decode_logits_close_to_fp():
    """Decode logits with int8 weights stay close to the fp logits."""
    lm, values = _lm(1)
    cfg = lm.cfg
    vq = dequantize_params(quantize_params(values, min_size=1 << 10),
                           getattr(torch, cfg.compute_dtype))

    def logits_seq(vals):
        caches = lm.init_cache(1, 16)
        out = []
        with torch.no_grad():
            for t, tok in enumerate([3, 7, 11, 2, 5]):
                lg, caches = lm.decode_step(vals, caches,
                                            torch.tensor([[tok]]), t)
                out.append(lg.float()[..., :cfg.vocab_size])
        return torch.stack(out)

    fp, q = logits_seq(values), logits_seq(vq)
    scale = float(fp.abs().max()) + 1e-6
    assert float((fp - q).abs().max()) / scale < 0.15


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_quantization_per_channel_scales(seed):
    rng = np.random.default_rng(seed)
    # rows with wildly different magnitudes: per-channel scales must adapt
    w = torch.tensor(rng.normal(size=(256, 128))
                     * (10.0 ** rng.integers(-3, 3, size=(256, 1))),
                     dtype=torch.float32)
    qt = quantize_params({"w": w}, min_size=1)["w"]
    back = qt.q.float() * qt.scale
    rel = (back - w).abs() / (w.abs() + 1e-9)
    row_max = w.abs().amax(dim=1, keepdim=True)
    big = w.abs() > 0.01 * row_max
    assert float(rel[big].max()) < 0.5


def test_roundtrip_matches_the_reference_on_carried_weights():
    """Both packages quantise the same flat tree: every leaf of the model
    (the layer stack unstacked: the JAX package's stacked leaves would put
    the period on axis 0) and a 3-D tensor."""
    jlm = JLM(jget_config("qwen2-1.5b", smoke=True), JHOST_MESH)
    jvalues, _ = split_params(jlm.init(jax.random.key(2)))
    flat = {"/".join(map(str, path)): np.asarray(v, np.float32)
            for path, v in _unstack(jax.tree.map(np.array, jvalues)).items()}
    flat["w3"] = np.random.default_rng(0).normal(size=(4, 64, 96)).astype(
        np.float32)
    counts = []
    for min_size in (1 << 14, 1 << 10):
        want = jq.quantize_params({k: jnp.asarray(v) for k, v in flat.items()},
                                  min_size)
        got = quantize_params({k: torch.tensor(v) for k, v in flat.items()},
                              min_size)
        n = 0
        for k, w in want.items():
            g = got[k]
            assert isinstance(g, QuantizedTensor) == isinstance(
                w, jq.QuantizedTensor), k
            if isinstance(g, QuantizedTensor):
                n += 1
                np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
                np.testing.assert_allclose(g.scale.numpy(),
                                           np.asarray(w.scale), rtol=1e-6)
        counts.append(n)
        back = dequantize_params(got, torch.float32)
        jback = jq.dequantize_params(want, jnp.float32)
        for k, v in jback.items():
            np.testing.assert_allclose(back[k].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-7)
    assert counts[1] > counts[0] >= 2     # the table and w3 at the default


def test_quantization_error_matches_the_reference():
    cfg = get_config("qwen2-1.5b", smoke=True)
    jlm = JLM(jget_config("qwen2-1.5b", smoke=True), JHOST_MESH)
    jvalues, _ = split_params(jlm.init(jax.random.key(3)))
    lm = LM(cfg, device="cpu")
    values = load_jax_params(lm, jax.tree.map(np.array, jvalues))
    got = quantization_error({k: v for k, v in values.items()
                              if k != "stack"})
    want = jq.quantization_error({k: v for k, v in jvalues.items()
                                  if k != "stack"})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-9)
