"""int8 error-feedback gradient compression.

The counterpart of ``repro.optim.compression``.  ``compress_tree`` /
``decompress_tree`` quantise gradients to int8 with one f32 scale a
tensor; the quantisation error is fed back into the next step's gradient
(error feedback), which keeps Adam's convergence (Karimireddy et al.,
2019).  The train step applies the round trip when
``ParallelConfig.grad_compression == "int8_ef"``, on the gradient
synchronised over the data ranks, as the JAX package's step does
(``runtime/train_lib.py``).  :func:`psum_compressed` is the JAX package's
compressed all-reduce itself (int8 payloads, each rank's own scale and
error buffer); the step does not use it.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_map, tree_zip
from repro_torch.runtime import sharding as sh


def quantize_int8(x, amax=None):
    """x: a float tensor -> (int8 values, f32 scale).  Symmetric,
    per tensor: ``amax`` is the tensor's max |x| (``x``'s own by default;
    a shard passes its whole tensor's)."""
    xf = x.float()
    amax = xf.abs().max() if amax is None else amax
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_tree(grads, error_buf):
    """Apply error feedback, then quantise every leaf.  Returns (a tree of
    (q, scale) pairs, the new error buffer)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        return (q, s), corrected - dequantize_int8(q, s)

    pairs = tree_zip(one, grads, error_buf)
    return (tree_map(lambda t: t[0], pairs, is_leaf=_is_pair),
            tree_map(lambda t: t[1], pairs, is_leaf=_is_pair))


def decompress_tree(qtree, like):
    """(q, scale) leaves -> tensors in the dtype of ``like``'s leaves."""
    return tree_zip(lambda qs, g: dequantize_int8(*qs).to(g.dtype), qtree,
                    like, is_leaf=_is_pair)


def psum_compressed(grads, error_buf, group):
    """Error-feedback int8 all-reduce over ``group`` (a spec axis: a name
    or a tuple of names of the ambient mesh).  The int8 payloads are summed
    in int32 (no overflow for the group sizes used here), the scales are
    summed and divided by the group size (they are near-equal), and the
    sum is dequantised with the mean scale.  Each rank keeps its own error
    buffer.  Returns (the summed gradients, the new error buffer)."""
    n = sh.axis_size(group)

    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        local_deq = dequantize_int8(q, s)
        q_sum = sh.all_reduce_(q.to(torch.int32), group)
        s_mean = sh.all_reduce_(s.clone(), group) / n
        return (q_sum.float() * s_mean).to(g.dtype), corrected - local_deq

    pairs = tree_zip(one, grads, error_buf)
    return (tree_map(lambda t: t[0], pairs, is_leaf=_is_pair),
            tree_map(lambda t: t[1], pairs, is_leaf=_is_pair))


def init_error_buffer(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _is_pair(x) -> bool:
    return isinstance(x, tuple)
