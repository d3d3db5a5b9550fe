"""GPipe pipeline parallelism (``runtime.pipeline_parallel``) on gloo
processes on the CPU: forward and gradients equal the sequential stack.

The twins of ``tests/test_pipeline.py``: 8 layers in 4 stages with 4
microbatches, and 6 layers in 2 stages with 3.  The sequential stack is
computed here in torch and held to the JAX package's; each spawned group
(``_torch_dist.run_group``) holds ``pipeline_apply``'s outputs (f32 rtol
1e-5, atol 1e-6, as the JAX test) and every stage's gradients of
sum(y^2) (1e-5 relative L2 a leaf) to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as W
from repro.runtime.pipeline_parallel import split_stages as jsplit_stages
from repro_torch.runtime.pipeline_parallel import split_stages


def _setup(n_layers=8, d=16, n_micro=4, mb=2, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.normal(size=(n_layers, d, d)) * 0.2
                    ).astype(np.float32),
              "b": (rng.normal(size=(n_layers, d)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(n_micro, mb, d)).astype(np.float32)
    return params, x


def _sequential(params, x):
    h = x
    for w, b in zip(params["w"], params["b"]):
        h = torch.tanh(h @ w + b)
    return h


def _jsequential(params, x_micro):
    def one(x):
        def layer(x, wl):
            return jnp.tanh(x @ wl[0] + wl[1]), None
        y, _ = jax.lax.scan(layer, x, (params["w"], params["b"]))
        return y
    return jax.vmap(one)(x_micro)


def _reference(params, x):
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in
         params.items()}
    y = _sequential(p, torch.from_numpy(x))
    grads = torch.autograd.grad(y.square().sum(), list(p.values()))
    jy = _jsequential({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    return y.detach().numpy(), {k: g.numpy() for k, g in zip(p, grads)}


@pytest.mark.parametrize("n_stages,n_layers,n_micro", [(4, 8, 4),
                                                        (2, 6, 3)])
def test_pipeline_matches_sequential(tmp_path, n_stages, n_layers, n_micro):
    params, x = _setup(n_layers=n_layers, n_micro=n_micro)
    want_y, want_grads = _reference(params, x)
    W.run_group(W.pipeline, n_stages, tmp_path, params, x, want_y,
                want_grads)


def test_split_stages_equals_the_jax_package():
    params, _ = _setup()
    got = split_stages({k: torch.from_numpy(v) for k, v in params.items()},
                       4)
    want = jsplit_stages({k: jnp.asarray(v) for k, v in params.items()}, 4)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="do not split"):
        split_stages({"w": torch.zeros(6, 2)}, 4)
