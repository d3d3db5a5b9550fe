"""``models.attention.apply_attention`` against the JAX package's, on
weights carried across.

The JAX package's ``init_attention`` draws the weights for one device and
for a tensor-parallel layout with padded heads (``head_layout``:
qwen2-7b's 6 query heads padded to 8, musicgen's heads both padded,
paligemma's one KV head replicated); the port's ``apply_attention`` on
those weights (``interop.operands_from_numpy``) equals the JAX function
(f32 rtol = atol = 2e-4, ``tests/test_models.py``'s), and the padded
weights give the unpadded result, as the JAX package's own test holds.
Positions and a bidirectional prefix pass through.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models.common import MeshInfo as JMeshInfo
from repro.models.common import split_params
from repro_torch.configs import get_config
from repro_torch.interop import operands_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models.common import MeshInfo

TOL = 2e-4


def _carried(jcfg, jmesh, seed):
    values = split_params(jattn.init_attention(jax.random.key(seed), jcfg,
                                               jmesh, jnp.float32))[0]
    names = sorted(values)
    arrays = operands_from_numpy(*(np.asarray(values[k]) for k in names),
                                 device="cpu")
    return values, dict(zip(names, arrays))


@pytest.mark.parametrize("arch,tp", [("qwen2-7b", 4), ("musicgen-medium", 4),
                                     ("paligemma-3b", 8)])
def test_apply_attention_equals_the_jax_package_with_padded_heads(arch, tp):
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    xt = operands_from_numpy(x, device="cpu")
    outs = []
    for model in (1, tp):
        jvalues, values = _carried(jcfg, JMeshInfo(model=model), 5)
        want = jattn.apply_attention(jvalues, jnp.asarray(x), jcfg,
                                     JMeshInfo(model=model))
        got = attn.apply_attention(values, xt, cfg, MeshInfo(model=model))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        outs.append(got.numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)


def test_apply_attention_takes_positions_and_a_prefix():
    cfg, jcfg = (get_config("qwen2-1.5b", smoke=True),
                 jget_config("qwen2-1.5b", smoke=True))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = (np.arange(12)[None] + np.array([[0], [7]])).astype(np.int32)
    jvalues, values = _carried(jcfg, JMeshInfo(), 2)
    want = jattn.apply_attention(jvalues, jnp.asarray(x), jcfg, JMeshInfo(),
                                 positions=jnp.asarray(pos), prefix_len=4)
    xt, pt = operands_from_numpy(x, pos, device="cpu")
    got = attn.apply_attention(values, xt, cfg, MeshInfo(), positions=pt,
                               prefix_len=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
