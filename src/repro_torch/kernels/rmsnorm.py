"""Fused RMSNorm as a hand-written CUDA kernel.

``rmsnorm(x, scale)`` computes ``x * rsqrt(mean(x**2) + eps) * scale`` over
the last axis in one launch of ``csrc/rmsnorm.cu``; it replaces
``repro.kernels.rmsnorm.rmsnorm`` (src/repro/kernels/rmsnorm.py:29).  The
statistics are f32, ``scale`` is widened to f32 (exact from bf16) and the
output has x's dtype; bf16 and f32 x are taken, anything else raises.

Bound on an H100: bytes (each row read once and written once for four
operations per element).  One warp per row.  Any D and any x are taken;
:func:`path` names the kernel path a call takes:

* ``"registers"``: D a multiple of 8 (bf16) or 4 (f32), at most
  :func:`max_dim`, x and scale 16-byte aligned: 16-byte loads, the row
  held in registers between the sum of squares and the scaling (read
  once);
* ``"two-pass"``: the same, with a wider row: 16-byte loads, the row read
  twice from device memory (once for the sum, once for the scaling);
* ``"scalar"``: D not a multiple of the vector width, or x or the scale not
  16-byte aligned: element loads with the last group masked at D, the row
  read twice.

The kernel reads a bf16 or f32 scale in its own dtype and widens it in
registers, as the JAX kernel's body does (:func:`kernel_scale`), so a call
launches one kernel and allocates only y.  A scale of another dtype is
converted to f32 once, a non-contiguous x or scale copied once
(:func:`kernel_input`).  The wrapper switches device only when x is not on
the current one.

``block_rows`` only decides which calls are accepted: as the JAX kernel
asserts, ``rows % min(block_rows, rows)`` must be 0, else ValueError, on
any device.  The kernel's own block is 8 rows.

``rmsnorm_plain`` beside it is the same function in plain PyTorch
(``ref.rmsnorm_ref``).  The wrapper runs it only when its operands lie on
the CPU; CUDA operands launch the kernel or raise.
``LAUNCHES["rmsnorm"]`` counts kernel launches, one per call, and nothing
else.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.gemm import _on_cpu, on_device, raw_stream

#: kernel launches since the last reset
LAUNCHES = {"rmsnorm": 0}
_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: 16-byte vectors one lane holds, at most (csrc/rmsnorm.cu)
MAX_VECS_PER_LANE = 32


def reset_launch_counts() -> None:
    LAUNCHES["rmsnorm"] = 0


def vector_elems(dtype) -> int:
    """Elements of ``dtype`` in one 16-byte load."""
    return 16 // dtype.itemsize


def max_dim(dtype) -> int:
    """The widest row the kernel takes: 32 lanes x 32 vectors."""
    return 32 * MAX_VECS_PER_LANE * vector_elems(dtype)


def kernel_input(x, scale=None):
    """(the x the kernel reads, its path): a non-contiguous x is copied
    into a contiguous tensor (one copy); the path follows from D and the
    alignment of that tensor's base and of ``scale`` (as
    :func:`kernel_scale` gives it; None: an aligned one), as the launcher
    in ``csrc/rmsnorm.cu`` decides it."""
    if not x.is_contiguous():
        x = x.contiguous()
    return x, path(x, scale)


def kernel_scale(scale):
    """The scale as the kernel reads it: a bf16 or f32 scale as it is (one
    copy only if it is not contiguous), any other dtype converted to f32
    once."""
    if scale.dtype not in _TAGS:
        scale = scale.to(torch.float32)
    return scale.contiguous()


def path(x, scale=None) -> str:
    """The kernel path for a contiguous x and the kernel's ``scale``
    (None: an aligned one): ``"registers"``, ``"two-pass"`` or
    ``"scalar"`` (see the module note)."""
    d, vec = x.shape[-1], vector_elems(x.dtype)
    if d % vec or x.data_ptr() % 16 or (
            scale is not None and scale.data_ptr() % 16):
        return "scalar"
    return "registers" if d <= max_dim(x.dtype) else "two-pass"


def rmsnorm_plain(x, scale, *, eps: float = 1e-5):
    """Plain PyTorch version of :func:`rmsnorm`."""
    return ref.rmsnorm_ref(x, scale, eps=eps)


#: row counts of call signatures already checked (x's and the scale's
#: shapes, x's dtype, block_rows); dropped past 256
_ROWS: dict[tuple, int] = {}


def _check(x, scale, block_rows: int) -> int:
    """The row count; raises ValueError for what neither path takes.  The
    checks follow from the call's signature alone, so each signature is
    checked once."""
    key = (x.shape, scale.shape, x.dtype, block_rows)
    rows = _ROWS.get(key)
    if rows is None:
        rows = _check_signature(x, scale, block_rows)
        if len(_ROWS) >= 256:
            _ROWS.clear()
        _ROWS[key] = rows
    return rows


def _check_signature(x, scale, block_rows: int) -> int:
    if x.ndim < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"last axis of x {tuple(x.shape)}")
    if x.dtype not in _TAGS:
        raise ValueError(f"the RMSNorm kernel takes bf16 or f32 x, not "
                         f"{x.dtype}")
    rows = math.prod(x.shape[:-1])
    br = min(block_rows, rows)
    if br <= 0 or rows % br:
        raise ValueError(f"{rows} rows are not a multiple of "
                         f"min(block_rows, rows) = {br}")
    return rows


def _launch(x, scale, y, rows: int, eps: float) -> None:
    d = x.shape[-1]
    lib = build.load(f"rmsnorm_{_TAGS[x.dtype]}")
    with on_device(x):
        err = lib.repro_rmsnorm(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                rows, d, eps, scale.dtype == torch.bfloat16,
                                raw_stream(x))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed for {rows} x {d}: "
                           f"{msg} (cuda error {err})")


def rmsnorm(x, scale, *, eps: float = 1e-5, block_rows: int = 256):
    """x: (..., D); scale: (D,) -> the same shape and dtype as x."""
    rows = _check(x, scale, block_rows)
    if not (x.is_cuda and scale.is_cuda) and _on_cpu(x, scale):
        return rmsnorm_plain(x, scale, eps=eps)
    if rows >= 2 ** 31 or x.shape[-1] >= 2 ** 31:
        raise ValueError(f"{rows} rows of {x.shape[-1]} exceed int32")
    if x.get_device() != scale.get_device():
        raise ValueError("x and scale on different CUDA devices")
    if not x.is_contiguous():
        x = x.contiguous()
    y = torch.empty_like(x)
    if y.numel():
        _launch(x, kernel_scale(scale), y, rows, float(eps))
        LAUNCHES["rmsnorm"] += 1
    return y
