"""Fused RMSNorm as a hand-written CUDA kernel.

``rmsnorm(x, scale)`` computes ``x * rsqrt(mean(x**2) + eps) * scale`` over
the last axis in one launch of ``csrc/rmsnorm.cu``; it replaces
``repro.kernels.rmsnorm.rmsnorm`` (src/repro/kernels/rmsnorm.py:29).  The
statistics are f32, ``scale`` is widened to f32 (exact from bf16) and the
output has x's dtype; bf16 and f32 x are taken, anything else raises.

Bound on an H100: bytes (each row read once and written once for four
operations per element).  The leading axes of x merge into rows, read in
place; :func:`path` names the kernel path a call takes:

* ``"direct"``: the last axis unit-stride, D a multiple of 8 (bf16) or 4
  (f32) and at most ``MAX_DIM`` (16384, both dtypes), x's base and row
  stride 16-byte aligned: a warp group a row, the row and the scale loaded
  into registers at once, up to four 16-byte vectors a lane within eight
  warps a row and up to eight past that, or, with fewer rows than the
  card has SMs, up to two a lane on up to sixteen warps (read once; on an
  H100 faster than the ring at every such shape timed, 256 to 32768 rows,
  1536 to 16384 wide);
* ``"element"``: the last axis unit-stride, any other D up to ``MAX_DIM``,
  base or row stride (a slice of a wider buffer, a ragged D): persistent
  blocks of 32 warps, one a SM, whose warp groups each walk their rows
  through a ring of two shared-memory stages, each filled by one bulk
  asynchronous copy of the 16-byte granules a row touches, then element
  by element, bf16 y in 4-byte pairs (read once);
* ``"columns"``: the row axis unit-stride and the last axis not (a
  transposed x), x's base and column stride in bytes 4-aligned, D at most
  :func:`max_columns_dim`: a block stages :func:`column_rows` rows, read
  along the row axis, in shared memory and writes y row-major (read once);
* ``"two-pass"``: D past ``MAX_DIM``, the last axis unit-stride: a block a
  row, the row read twice from device memory;
* ``"copy"``: any other layout: :func:`kernel_input` copies x once into a
  contiguous tensor, which then takes one of the paths above.

The kernel reads a bf16 or f32 scale in its own dtype and widens it in
registers, as the JAX kernel's body does (:func:`kernel_scale`), so a call
launches one kernel and allocates only y, for every layout read in place.
A scale of another dtype is converted to f32 once, a non-contiguous scale
copied once.  y is contiguous and row-major, as the JAX kernel returns it.
The wrapper switches device only when x is not on the current one.

``block_rows`` only decides which calls are accepted: as the JAX kernel
asserts, ``rows % min(block_rows, rows)`` must be 0, else ValueError, on
any device.

``rmsnorm_plain`` beside it is the same function in plain PyTorch
(``ref.rmsnorm_ref``).  The wrapper runs it only when its operands lie on
the CPU; CUDA operands launch the kernel or raise.
``LAUNCHES["rmsnorm"]`` counts kernel launches, one per call, and nothing
else.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.gemm import _on_cpu, on_device, raw_stream

#: kernel launches since the last reset
LAUNCHES = {"rmsnorm": 0}
_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: the widest row read once (csrc/rmsnorm.cu kMaxD)
MAX_DIM = 16384
#: the columns path's shared memory a block, at most: two blocks a SM
#: (csrc/rmsnorm.cu kColumnsSmem)
COLUMNS_SMEM = 232448 // 2 - 1024


def reset_launch_counts() -> None:
    LAUNCHES["rmsnorm"] = 0


def vector_elems(dtype) -> int:
    """Elements of ``dtype`` in one 16-byte load."""
    return 16 // dtype.itemsize


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=256)
def _columns_words(d: int) -> int:
    """Words of rows (16, 8, 4, 2 or 1) a columns block stages: the most
    whose tile, ``(d | 1)`` words a word of rows, and f32 scale fit in
    ``COLUMNS_SMEM``; 0 if none does (csrc/rmsnorm.cu columns_words)."""
    tq = 16
    while tq and _round16(tq * (d | 1) * 4) + 4 * d > COLUMNS_SMEM:
        tq //= 2
    return tq


def column_rows(dtype, d: int) -> int:
    """Rows a columns block normalises at width ``d`` (a 4-byte word holds
    two bf16 rows or one f32 row); 0 past :func:`max_columns_dim`."""
    return _columns_words(d) * 4 // dtype.itemsize


def max_columns_dim() -> int:
    """The widest row the columns path takes (one word of rows a block)."""
    d = COLUMNS_SMEM // 8
    while not _columns_words(d):
        d -= 1
    return d


def _rows_view(x):
    """x as (rows, D) without a copy, or None where its leading axes do
    not merge into one row axis."""
    d = x.shape[-1]
    try:
        return x.view(math.prod(x.shape[:-1]), d)
    except RuntimeError:
        return None


def _kernel_strides(x2) -> tuple[int, int]:
    """(row stride, column stride) of a (rows, D) tensor as the launcher
    takes them: a stride of an axis of length 1 does not matter, and is
    given as what suits the other axis."""
    rows, d = x2.shape
    sr, sd = x2.stride()
    if d == 1:
        sd = 1
    if rows == 1:
        sr = d if sd == 1 else 1
    return sr, sd


def _reads_in_place(x2, sr: int, sd: int) -> bool:
    """Whether a path reads the (rows, D) tensor ``x2`` with these strides
    in place (csrc/rmsnorm.cu dispatch)."""
    return sd == 1 or (sr == 1 and x2.data_ptr() % 4 == 0
                       and sd * x2.element_size() % 4 == 0
                       and _columns_words(x2.shape[1]) > 0)


def _read_path(x2, sr: int, sd: int) -> str:
    """The path for a (rows, D) tensor a path reads in place, as the
    launcher in ``csrc/rmsnorm.cu`` decides it (y assumed 16-byte
    aligned, as the caching allocator gives it)."""
    rows, d = x2.shape
    if sd != 1:
        return "columns"
    if d > MAX_DIM:
        return "two-pass"
    if (x2.data_ptr() % 16 == 0 and d % vector_elems(x2.dtype) == 0
            and (rows == 1 or sr * x2.element_size() % 16 == 0)):
        return "direct"
    return "element"


def _operand(x):
    """(the (rows, D) tensor the kernel reads, its row stride, its column
    stride): a view of x where a path reads it in place, else one
    contiguous copy."""
    x2 = x if x.dim() == 2 else _rows_view(x)
    if x2 is not None:
        sr, sd = _kernel_strides(x2)
        if _reads_in_place(x2, sr, sd):
            return x2, sr, sd
    x2 = x.contiguous().view(-1, x.shape[-1])
    return (x2, *_kernel_strides(x2))


def path(x) -> str:
    """The kernel path for x: ``"direct"``, ``"element"``, ``"columns"``,
    ``"two-pass"``, or ``"copy"`` for a layout the kernel does not read
    (see the module note)."""
    x2 = x if x.dim() == 2 else _rows_view(x)
    if x2 is None:
        return "copy"
    sr, sd = _kernel_strides(x2)
    return _read_path(x2, sr, sd) if _reads_in_place(x2, sr, sd) else "copy"


def kernel_input(x):
    """(the (rows, D) tensor the kernel reads, its path): a view of x where
    :func:`path` reads it in place, else one contiguous copy of x (whose
    path is never ``"copy"``)."""
    x2, sr, sd = _operand(x)
    return x2, _read_path(x2, sr, sd)


def kernel_scale(scale):
    """The scale as the kernel reads it: a bf16 or f32 scale as it is (one
    copy only if it is not contiguous), any other dtype converted to f32
    once."""
    if scale.dtype not in _TAGS:
        scale = scale.to(torch.float32)
    return scale.contiguous()


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
    x2, sr, sd = _operand(x)
    d = x2.shape[-1]
    lib = build.load(f"rmsnorm_{_TAGS[x2.dtype]}")
    with on_device(x2):
        err = lib.repro_rmsnorm(x2.data_ptr(), sr, sd, scale.data_ptr(),
                                y.data_ptr(), rows, d, eps,
                                scale.dtype == torch.bfloat16,
                                raw_stream(x2))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed for {rows} x {d}: "
                           f"{msg} (cuda error {err})")


def rmsnorm(x, scale, *, eps: float = 1e-5, block_rows: int = 256):
    """x: (..., D); scale: (D,) -> the same shape and dtype as x,
    contiguous."""
    rows = _check(x, scale, block_rows)
    if not (x.is_cuda and scale.is_cuda) and _on_cpu(x, scale):
        return rmsnorm_plain(x, scale, eps=eps)
    if rows >= 2 ** 31 or x.shape[-1] >= 2 ** 31:
        raise ValueError(f"{rows} rows of {x.shape[-1]} exceed int32")
    if x.get_device() != scale.get_device():
        raise ValueError("x and scale on different CUDA devices")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel():
        _launch(x, kernel_scale(scale), y, rows, float(eps))
        LAUNCHES["rmsnorm"] += 1
    return y
