"""Flash attention forward as a hand-written CUDA kernel.

``flash_attention_fwd(q, k, v)`` computes causal (or full) softmax
attention over q ``(B, S, H, D)`` and k, v ``(B, Skv, H, D)`` in one launch
of ``csrc/flash_attention.cu``; it replaces
``repro.kernels.flash_attention.flash_attention_fwd``
(src/repro/kernels/flash_attention.py:68).  q is scaled by ``D**-0.5`` in
f32, the causal mask is top-left aligned (key j visible to query i when
j <= i) and filled with -1e30, the softmax runs online in f32 and the
output is cast to q's dtype.  bf16 and f32 are taken, at any head dim up
to :data:`MAX_HEAD_DIM`: the kernel is compiled for the widths
:data:`HEAD_DIMS` and a head dim runs on the smallest that holds it
(:func:`compiled_width`), loads past it reading zero and stores past it
skipped; a wider head dim raises.  B * H and S are limited only by the
grid (:func:`_check_grid`).  There is no GQA: callers repeat the KV heads,
as for the JAX kernel.

Bound on an H100: bytes at the served prefill (S = 32), operations from a
few hundred positions on.  The kernel keeps the scores out of device
memory and stops the key loop at the diagonal when causal; this first
version multiplies on the CUDA cores in f32 (see the CUDA source).

``block_q`` and ``block_k`` only decide which calls are accepted: as the
JAX kernel asserts, ``S % min(block_q, S)`` and ``Skv % min(block_k, Skv)``
must be 0, else ValueError, on any device.  The kernel's own tile is
:data:`BLOCK_Q` x :data:`BLOCK_K` and masks ragged edges itself.

``flash_attention_plain`` beside it is the same function in plain PyTorch
(``ref.flash_attention_ref``, which holds the S x Skv scores).  The wrapper
runs it only when its operands lie on the CPU; CUDA operands launch the
kernel or raise.  ``LAUNCHES["flash_attention"]`` counts kernel launches,
one per call, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gemm import _on_cpu, on_device, raw_stream

#: kernel launches since the last reset
LAUNCHES = {"flash_attention": 0}
_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: head-dim widths the kernel is compiled for
HEAD_DIMS = (64, 128, 256)
#: the widest head dim taken
MAX_HEAD_DIM = HEAD_DIMS[-1]
#: the kernel's tile: query rows per block, keys per step
BLOCK_Q = 64
BLOCK_K = 64


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def compiled_width(d: int) -> int:
    """The compiled head-dim width that runs head dim ``d``: the smallest
    of :data:`HEAD_DIMS` that holds it.  Raises ValueError past
    :data:`MAX_HEAD_DIM`."""
    for width in HEAD_DIMS:
        if 0 < d <= width:
            return width
    raise ValueError(f"the flash attention kernel takes head dims from 1 "
                     f"to {MAX_HEAD_DIM}, not {d}")


def smem_bytes(d: int) -> int:
    """Dynamic shared memory one block claims at head dim ``d``: the f32
    q and k tiles with rows padded to D + 1, the v tile, and the
    probabilities with rows padded to BLOCK_K + 16, where D is the
    compiled width that runs ``d``."""
    w = compiled_width(d)
    return 4 * (BLOCK_Q * (w + 1) + BLOCK_K * (w + 1) + BLOCK_K * w
                + BLOCK_Q * (BLOCK_K + 16))


def _check_grid(b: int, s: int, h: int, skv: int) -> None:
    """The launch grid is (B*H, ceil(S/BLOCK_Q)): B*H on gridDim.x, the
    query tiles on gridDim.y (at most 65,535)."""
    if b * h >= 2 ** 31 or -(-s // BLOCK_Q) > 65535 or skv >= 2 ** 31:
        raise ValueError(f"B * H = {b * h}, S = {s}, Skv = {skv}: the grid "
                         f"takes B * H < 2**31 and S <= "
                         f"{65535 * BLOCK_Q}")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain PyTorch version of :func:`flash_attention_fwd`."""
    return ref.flash_attention_ref(q, k, v, causal=causal)


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (B, S, H, D) and "
                         f"(B, Skv, H, D) with equal B, H and D")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"operand dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dtype not in _TAGS:
        raise ValueError(f"the flash attention kernel takes bf16 or f32, "
                         f"not {q.dtype}")
    s, skv = q.shape[1], k.shape[1]
    bq, bk = min(block_q, s), min(block_k, skv)
    if bq <= 0 or bk <= 0 or s % bq or skv % bk:
        raise ValueError(f"S = {s} and Skv = {skv} must be multiples of "
                         f"min(block_q, S) = {bq} and min(block_k, Skv) = "
                         f"{bk}")


def _launch(q, k, v, o, causal: bool) -> None:
    from repro_torch.kernels import build

    b, s, h, d = q.shape
    lib = build.load(f"flash_attention_{_TAGS[q.dtype]}")
    strides = [st for t in (q, k, v) for st in (t.stride(0), t.stride(1),
                                                t.stride(2))]
    with on_device(q):
        stream = raw_stream(q)
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
            k.shape[1], h, d, *strides, int(causal), stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed for q "
                           f"{tuple(q.shape)}, kv {tuple(k.shape)}: {msg} "
                           f"(cuda error {err})")


def flash_attention_fwd(q, k, v, *, causal: bool = True, block_q: int = 128,
                        block_k: int = 128):
    """q: (B, S, H, D), k, v: (B, Skv, H, D) -> (B, S, H, D) in q's dtype."""
    _check(q, k, v, block_q, block_k)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal)
    b, s, h, d = q.shape
    compiled_width(d)
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the flash attention kernel takes a unit stride on "
                         "the head dim")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("operands on different CUDA devices")
    _check_grid(b, s, h, k.shape[1])
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    _launch(q, k, v, o, causal)
    LAUNCHES["flash_attention"] += 1
    return o
