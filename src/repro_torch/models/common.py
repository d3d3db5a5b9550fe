"""Parameter plumbing shared by all model code.

The JAX package builds nested dicts of ``Param`` (an array plus its
PartitionSpec) and splits them into value and spec trees for ``jit``.  The
port runs eagerly, so a parameter is a plain tensor and a model's
parameters are a nested dict of tensors in the JAX package's layout (same
keys, same shapes, same axis order); :class:`ParamTree` holds such a dict
as registered ``nn.Parameter``s of an ``nn.Module``.  The specs are a
second tree of the same structure (``LM.specs``), built by each module's
``*_specs`` function beside its ``init_*``.

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
    become child modules, lists ``nn.ModuleList``s, tensors
    ``nn.Parameter``s, frozen unless ``requires_grad`` (serving keeps them
    frozen; ``LM.train_mode`` makes them trainable).  :meth:`tree` gives
    the nested dict back, its leaves the parameters themselves (no
    copies)."""

    def __init__(self, tree: dict, requires_grad: bool = False):
        super().__init__()
        self._keys = list(tree)
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, requires_grad))
            elif isinstance(val, list):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v, requires_grad) for v in val))
            else:
                self.register_parameter(key, nn.Parameter(
                    val, requires_grad=requires_grad))

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


def tree_map(fn, tree, *, is_leaf=None):
    """``fn`` over the leaves of a nested dict / list, the structure kept;
    ``is_leaf`` stops the descent at the nodes it accepts."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf=is_leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, is_leaf=is_leaf) for v in tree]
    return fn(tree)


def tree_zip(fn, tree, *rest, is_leaf=None):
    """``fn(leaf, *leaves)`` over trees of one structure (``tree``'s:
    ``is_leaf`` applies to it)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_zip(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_zip(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict / list, in insertion order: a
    path is the tuple of dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_copy_(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``, in place
    (across devices and dtypes)."""
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
            d.copy_(s)


# ---------------------------------------------------------------------------
# Initialisers.  All take an explicit generator and the target device.
# ---------------------------------------------------------------------------


class Cut:
    """What an initialiser keeps of each leaf it draws, by the leaf's key.

    ``Cut()`` keeps every leaf whole.  ``Cut(specs, sh)`` keeps this
    rank's part of leaf ``key`` under ``specs[key]`` on the ambient mesh,
    ``sh`` being ``runtime.sharding`` (passed in: that module imports this
    one).  ``LM.init(shard=True)`` hands one to every initialiser, so that
    no leaf outlives its draw whole: a dense leaf is cut in f32 as it is
    drawn, before it is scaled and cast (:func:`dense_init`), and a stack
    of experts is drawn and cut one expert at a time
    (``moe.init_moe``).  Cutting a draw and then scaling and casting it
    gives the bits that cutting the finished leaf gives.
    """

    def __init__(self, specs=None, sh=None):
        self.specs, self._sh = specs, sh

    def at(self, key) -> "Cut":
        """The cut of the subtree ``key``."""
        return self if self.specs is None else Cut(self.specs[key],
                                                   self._sh)

    def __call__(self, key, x):
        """What is kept of leaf ``key``, given whole as ``x``."""
        return x if self.specs is None else self._sh.shard_tensor(
            x, self.specs[key])

    def of(self, key, pad=None):
        """The cut of leaf ``key`` as a function of its f32 draw, which
        ``pad`` (if given) first takes to the leaf's padded shape."""
        def cut(x):
            return self(key, x if pad is None else pad(x))
        return cut

    def rows(self, key, n: int):
        """(the indices along dim 0 of leaf ``key``, ``n`` long, that are
        kept; the cut of one slice along it, None for whole)."""
        if self.specs is None:
            return range(n), None
        spec = self.specs[key]
        per = n // self._sh.axis_size(spec[0])
        i = self._sh.axis_index(spec[0])
        return (range(i * per, (i + 1) * per),
                lambda x: self._sh.shard_tensor(x, spec[1:]))


#: keeps every leaf whole
WHOLE = Cut()


def dense_init(gen: torch.Generator, d_in: int, shape: tuple, dtype,
               device, cut=None) -> torch.Tensor:
    """Fan-in-scaled normal init (the shape's contraction dim is d_in).
    ``cut`` (a function, see :meth:`Cut.of`) takes the f32 draw to the
    part that is kept before it is scaled and cast."""
    std = d_in ** -0.5
    v = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if cut is not None:
        v = cut(v)
    return (v * std).to(dtype)


def zeros_init(shape: tuple, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape: tuple, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device, cut=None) -> torch.Tensor:
    v = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (v if cut is None else cut(v)).to(dtype)


# ---------------------------------------------------------------------------
# Mesh description and spec construction.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Sizes of the logical axes actually present on the mesh.

    A pure description, equal field for field to the JAX package's: the
    process groups live on the ``DeviceMesh`` that
    ``runtime.sharding.use_mesh`` installs.  ``shard_if`` returns the axis
    name only when it divides ``size`` -- non-divisible dims fall back to
    replication rather than failing (e.g. paligemma's single KV head vs a
    16-way model axis).  ``fsdp_if`` is the same rule for the data
    (-parallel) axes when ZeRO-style parameter sharding is enabled.

    A spec is a tuple with one entry per tensor axis: ``None``, an axis
    name, or a tuple of axis names (the data axes of a multi-pod mesh), so
    that it compares equal with ``tuple(PartitionSpec(...))``.
    """
    data: int = 1                  # combined DP size (pod x data)
    model: int = 1
    data_axes: tuple = ("data",)   # mesh axis names folded into DP
    model_axis: str = "model"
    fsdp: bool = False

    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def shard_if(self, size: int):
        return self.model_axis if size % self.model == 0 else None

    def fsdp_if(self, size: int):
        if not self.fsdp:
            return None
        return self.dp() if size % self.data == 0 else None


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
