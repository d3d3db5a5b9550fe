"""Parameter plumbing shared by all model code.

The JAX package builds nested dicts of ``Param`` (an array plus its
PartitionSpec) and splits them into value and spec trees for ``jit``.  The
port runs on one device and eagerly, so a parameter is a plain tensor and a
model's parameters are a nested dict of tensors in the JAX package's
layout (same keys, same shapes, same axis order); :class:`ParamTree` holds
such a dict as registered ``nn.Parameter``s of an ``nn.Module``.

Initialisers draw from an explicit ``torch.Generator`` with the JAX
package's distributions (fan-in-scaled normal, unit normal embeddings).
The numbers differ from ``jax.random``'s; parity with the JAX package is
held on carried weights (``interop.load_jax_params``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested dict (lists allowed) of tensors as an ``nn.Module``: dicts
    become child modules, lists ``nn.ModuleList``s, tensors frozen
    ``nn.Parameter``s.  :meth:`tree` gives the nested dict back, its leaves
    the parameters themselves (no copies)."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, list):
                self.add_module(key, nn.ModuleList(ParamTree(v)
                                                   for v in val))
            else:
                self.register_parameter(key, nn.Parameter(
                    val, requires_grad=False))

    def tree(self) -> dict:
        out = {}
        for key in self._keys:
            val = getattr(self, key)
            if isinstance(val, ParamTree):
                out[key] = val.tree()
            elif isinstance(val, nn.ModuleList):
                out[key] = [m.tree() for m in val]
            else:
                out[key] = val
        return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Initialisers.  All take an explicit generator and the target device.
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, shape: tuple, dtype,
               device) -> torch.Tensor:
    """Fan-in-scaled normal init (the shape's contraction dim is d_in)."""
    std = d_in ** -0.5
    v = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (v * std).to(dtype)


def zeros_init(shape: tuple, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape: tuple, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


# ---------------------------------------------------------------------------
# Mesh description (one device).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Sizes of the logical mesh axes.  The port runs on one device, so
    both axes are 1, nothing shards (``shard_if`` / ``fsdp_if`` return
    None) and head and expert padding never applies; the multi-device
    layouts come with the multi-device queue."""
    data: int = 1
    model: int = 1

    def __post_init__(self):
        if self.data != 1 or self.model != 1:
            raise NotImplementedError(
                "the port runs on one device; meshes come with the "
                "multi-device queue (ROADMAP queue 1 item 3)")

    def shard_if(self, size: int):
        return None

    def fsdp_if(self, size: int):
        return None


HOST_MESH = MeshInfo(data=1, model=1)


def cast_for_compute(tree, dtype):
    """Mixed-precision cast: matrices go to the compute dtype; small vectors
    and scalars (norm scales, biases) keep their init dtype (f32) for
    numerical stability.  A leaf already in ``dtype`` is returned as is, so
    casting a compute copy again costs nothing."""
    def f(x):
        if x.is_floating_point() and x.ndim >= 2:
            return x.to(dtype)
        return x
    return tree_map(f, tree)
