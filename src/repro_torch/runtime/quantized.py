"""Weight-only int8 quantization for serving.

The counterpart of ``repro.runtime.quantized``.  Decode reads every
parameter once a step, so storing the large matrices as int8 with one f32
scale per axis-0 channel halves the bytes a decoded token reads against
bf16.  ``quantize_params`` maps every large floating matrix to a
:class:`QuantizedTensor` (int8 data plus its f32 scale);
``dequantize_params`` restores a compute-dtype tree.  Small tensors (norm
scales, biases) and integer tensors stay as they are.

``quantized_specs`` maps a spec tree onto the quantised tree.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import tree_map, tree_paths, tree_zip

#: the size from which a floating matrix is quantised
MIN_SIZE = 1 << 14


@dataclasses.dataclass
class QuantizedTensor:
    q: torch.Tensor          # int8
    scale: torch.Tensor      # f32, broadcastable to q's shape

    @property
    def shape(self):
        return self.q.shape


def _quantizable(x, min_size: int) -> bool:
    return (isinstance(x, torch.Tensor) and x.ndim >= 2
            and x.numel() >= min_size and x.is_floating_point())


def quantize_params(values, min_size: int = MIN_SIZE):
    """Per-axis-0-channel symmetric int8 quantisation of large matrices."""
    def q(x):
        if not _quantizable(x, min_size):
            return x
        xf = x.float()
        amax = xf.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)
        scale = amax.clamp_min(1e-12) / 127.0
        qv = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return QuantizedTensor(qv, scale)
    return tree_map(q, values)


def quantized_specs(values, specs, min_size: int = MIN_SIZE):
    """The spec tree of ``quantize_params(values)``: a quantised leaf's
    int8 data keeps its spec, its scale (one per axis-0 channel) shards
    like axis 0."""
    def q(x, s):
        if not _quantizable(x, min_size):
            return s
        return QuantizedTensor(s, (s[0] if len(s) else None,)
                               + (None,) * (x.ndim - 1))
    return tree_zip(q, values, specs)


def dequantize_params(tree, dtype):
    """QuantizedTensor leaves -> ``dtype`` tensors; other leaves as they
    are."""
    def d(x):
        if isinstance(x, QuantizedTensor):
            return (x.q.float() * x.scale).to(dtype)
        return x
    return tree_map(d, tree)


def _keystr(path) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it: ``['a'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def quantization_error(values, dtype=torch.bfloat16) -> dict:
    """Max error relative to the leaf's max |value|, per quantised leaf,
    keyed by path (for tests)."""
    dq = dict(tree_paths(dequantize_params(quantize_params(values),
                                           torch.float32)))
    errs = {}
    for path, v in tree_paths(values):
        if _quantizable(v, MIN_SIZE):
            vf = v.float()
            denom = vf.abs().max() + 1e-12
            errs[_keystr(path)] = float((vf - dq[path]).abs().max() / denom)
    return errs
