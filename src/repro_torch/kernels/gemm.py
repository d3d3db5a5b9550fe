"""The paper's two GEMM loop orders as hand-written CUDA kernels for Hopper.

Two kernels realise the two cost-model variants (core/tpu_model.GridOrder),
both from ``csrc/gemm.cu`` with the plan's ``(bm, bn, bk)`` as the
thread-block tile:

* ``gemm_k_inner`` — replaces ``repro.kernels.gemm.gemm_k_inner``
  (src/repro/kernels/gemm.py:56).  Output-stationary: one launch, each block
  loops over K in bk slabs and keeps its C tile's f32 (int32) accumulator in
  registers, writing C once — the **B3A2C0 analogue**.
* ``gemm_k_outer`` — replaces ``repro.kernels.gemm._k_step_call``
  (src/repro/kernels/gemm.py:89) as driven by ``gemm_k_outer`` (:113).  One
  launch per k block over the ``(M/bm, N/bn)`` grid, each reading C, adding
  ``A_k . B_k`` and writing C back rounded to its dtype — the
  **C3B2A0/B3C2A0 analogue** (C streamed).  The caller's ``c`` is never
  mutated: it is cloned once and the passes update the clone in place.

Bound on an H100: at the planner's tiles both are arithmetic-bound (far
above the ~295 flop/byte bf16 ridge point); this first version multiplies
on the CUDA cores (FP32 FMA, int32 multiply-add, no TF32), so it runs
against 67 TFLOP/s, not the tensor cores' 989.  Design notes are in the
CUDA source.

Each kernel has a plain PyTorch version beside it (``*_plain``), the same
function computed by ``kernels/ref.py``.  A wrapper runs the plain version
only when its operands lie on the CPU; CUDA operands launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches, one per launch, and nothing
else.  Unlike the Pallas kernels, these mask ragged edges themselves, so
shapes need not divide the tile.
"""
from __future__ import annotations

import torch

from repro_torch.core.tpu_model import DTYPE_BYTES, GridOrder, TileConfig
from repro_torch.kernels import ref

#: shared memory one Hopper thread block may claim (bytes)
MAX_SMEM_BYTES = 232448
MAX_THREADS = 256
#: largest per-thread register tile (RM x RN accumulators) compiled
MAX_REGISTER_TILE = 64

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"gemm_k_inner": 0, "gemm_k_outer": 0}

_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _tag(dtype) -> str:
    if isinstance(dtype, str):
        if dtype not in DTYPE_BYTES:
            raise ValueError(f"unknown dtype tag {dtype!r}")
        return dtype
    try:
        return _TAGS[dtype]
    except KeyError:
        raise ValueError(f"the GEMM kernels take bf16, f32 or int8 operands, "
                         f"not {dtype}") from None


def out_dtype(dtype: torch.dtype) -> torch.dtype:
    """The product's dtype: int32 for int8 operands, else the input's."""
    return torch.int32 if dtype == torch.int8 else dtype


def smem_bytes(tile: TileConfig, dtype) -> int:
    """Dynamic shared memory one block of either kernel claims: the A and B
    slabs (bm x bk and bk x bn) in the operand dtype; the accumulator lives
    in registers."""
    s = DTYPE_BYTES[_tag(dtype)]
    return (tile.bm * tile.bk + tile.bk * tile.bn) * s


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def launch_config(tile: TileConfig, dtype) -> tuple[int, int, int]:
    """``(threads, RM, RN)`` of the block that runs ``tile``: threads form a
    TY x TX grid with TX = min(bn, 32), and each owns an RM x RN register
    tile of C.  Raises ValueError for a tile the kernels do not take (the
    same rule ``csrc/gemm.cu`` applies)."""
    bm, bn, bk = tile.bm, tile.bn, tile.bk
    if not (_pow2(bm) and _pow2(bn) and _pow2(bk)):
        raise ValueError(f"tile {tile}: the kernels take power-of-two "
                         f"bm, bn, bk")
    threads = min(MAX_THREADS, bm * bn)
    tx = min(bn, 32)
    rm, rn = bm // (threads // tx), bn // tx
    if rm * rn > MAX_REGISTER_TILE or rn > 32:
        raise ValueError(
            f"tile {tile}: {rm}x{rn} accumulators per thread exceed the "
            f"compiled register tiles (at most {MAX_REGISTER_TILE}, RN <= 32)")
    need = smem_bytes(tile, dtype)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"tile {tile}: {need} bytes of shared memory exceed "
                         f"the {MAX_SMEM_BYTES} a Hopper block may claim")
    return threads, rm, rn


def gemm_k_inner_plain(a, b):
    """Plain PyTorch version of :func:`gemm_k_inner`."""
    return ref.gemm_ref(a, b)


def gemm_k_outer_plain(a, b, c, *, bk: int):
    """Plain PyTorch version of :func:`gemm_k_outer` (per-pass rounding)."""
    return ref.gemm_ref_streamed(a, b, c, bk)


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if len(devs) > 1:
        raise ValueError(f"operands on different devices: {sorted(devs)}")
    dev = devs.pop()
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"the GEMM kernels run on CUDA tensors (CPU tensors "
                         f"run their plain versions), not on {dev!r}")
    return dev == "cpu"


def _check_operands(a, b) -> tuple[int, int, int]:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"operands {tuple(a.shape)} @ {tuple(b.shape)} are "
                         f"not an (m, k) @ (k, n) pair")
    if a.dtype != b.dtype:
        raise ValueError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    m, k = a.shape
    return m, b.shape[1], k


def _check_cuda(*ts) -> None:
    for t in ts:
        if t.stride(-1) != 1 and t.numel() > 1:
            raise ValueError(f"the kernels take row-major operands (unit "
                             f"column stride), got strides {t.stride()}")
        if max(t.shape) >= 2 ** 31:
            raise ValueError(f"dimension {max(t.shape)} exceeds int32")
    if len({t.device for t in ts}) != 1:
        raise ValueError("operands on different CUDA devices")


def _launch(a, b, c_in, c_out, m: int, n: int, k: int, tile) -> None:
    from repro_torch.kernels import build

    lib = build.load(f"gemm_{_tag(a.dtype)}")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_gemm_tile(
            a.data_ptr(), b.data_ptr(),
            None if c_in is None else c_in.data_ptr(), c_out.data_ptr(),
            m, n, k, a.stride(0), b.stride(0), c_out.stride(0),
            tile.bm, tile.bn, tile.bk, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"gemm kernel launch failed for {m}x{n}x{k} on "
                           f"tile {tile}: {msg} (cuda error {err})")


def gemm_k_inner(a, b, *, tile: TileConfig):
    """C = A @ B, output-stationary (B3A2C0 analogue)."""
    m, n, k = _check_operands(a, b)
    launch_config(tile, a.dtype)
    if _on_cpu(a, b):
        return gemm_k_inner_plain(a, b)
    _check_cuda(a, b)
    out = torch.empty((m, n), dtype=out_dtype(a.dtype), device=a.device)
    _launch(a, b, None, out, m, n, k, tile)
    LAUNCHES["gemm_k_inner"] += 1
    return out


def gemm_k_outer(a, b, c, *, tile: TileConfig):
    """C + A @ B with C streamed once per k block (C3B2A0/B3C2A0 analogue);
    C is rounded to its dtype after every pass."""
    m, n, k = _check_operands(a, b)
    launch_config(tile, a.dtype)
    if tuple(c.shape) != (m, n):
        raise ValueError(f"C {tuple(c.shape)} does not match the "
                         f"{m}x{n} product")
    if _on_cpu(a, b, c):
        return gemm_k_outer_plain(a, b, c, bk=tile.bk)
    if c.dtype != out_dtype(a.dtype):
        raise ValueError(f"the k-outer kernel streams C in "
                         f"{out_dtype(a.dtype)} for {a.dtype} operands, "
                         f"got {c.dtype}")
    _check_cuda(a, b, c)
    out = c.clone(memory_format=torch.contiguous_format)
    bk = tile.bk
    for k0 in range(0, k, bk):
        span = min(bk, k - k0)
        _launch(a[:, k0:k0 + span], b[k0:k0 + span], out, out, m, n, span,
                tile)
        LAUNCHES["gemm_k_outer"] += 1
    return out


def gemm(a, b, c=None, *, tile: TileConfig):
    """C (+)= A @ B in the loop order ``tile.order`` selects."""
    if tile.order is GridOrder.K_INNER:
        out = gemm_k_inner(a, b, tile=tile)
        return out if c is None else c + out
    if c is None:
        c = torch.zeros((a.shape[0], b.shape[1]), dtype=out_dtype(a.dtype),
                        device=a.device)
    return gemm_k_outer(a, b, c, tile=tile)
