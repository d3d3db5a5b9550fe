"""Grouped (per-expert) GEMM for the MoE experts as a hand-written CUDA kernel.

``grouped_gemm(x, w)`` computes ``y[e] = x[e] @ w[e]`` for x ``(E, C, D)``
and w ``(E, D, F)`` in one launch of ``csrc/grouped_gemm.cu``; it replaces
``repro.kernels.grouped_gemm.grouped_gemm_kernel``
(src/repro/kernels/grouped_gemm.py:37).  The sum over D is float32 and is
rounded once to ``x.dtype``, as in the Pallas kernel; bf16 and f32 are
taken, anything else raises.

Bound on an H100: at serving's decode shapes each call reads every
expert's weights once (62.9 MB for one granite projection) for about
2 GFLOP, far below the ~295 flop/byte bf16 ridge, so the bound is bytes.
This first version stages tiles through shared memory with scalar loads and
multiplies on the CUDA cores (see the CUDA source).

Tile: one thread block per (expert, C tile, F tile).  The JAX default
128/128/512 would stage 262,144 B of shared memory in bf16, over the
232,448 B a Hopper block may claim, so :func:`grouped_tile` takes
bc = the smallest power of two >= min(C, 128), bf = 128 and bk = 256 (bf16)
or 128 (f32), at most 131,072 B.  Ragged edges are masked in the kernel, so
C (any multiple of 8 from the MoE capacity), D and F need not divide the
tile.

``grouped_gemm_plain`` beside it is the same function in plain PyTorch
(``ref.grouped_gemm_ref``).  The wrapper runs it only when its operands lie
on the CPU; CUDA operands launch the kernel or raise.
``LAUNCHES["grouped_gemm"]`` counts kernel launches, one per launch, and
nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.core.tpu_model import TileConfig
from repro_torch.kernels import ref
from repro_torch.kernels.gemm import _on_cpu, launch_config

#: kernel launches since the last reset
LAUNCHES = {"grouped_gemm": 0}
_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: the sum-depth slab per element type: 256 * (bc + bf) * 2 B and
#: 128 * (bc + bf) * 4 B stay at or under 131,072 B for bc, bf <= 128
BLOCK_K = {"bf16": 256, "f32": 128}
BLOCK_F = 128
MAX_BLOCK_C = 128


def reset_launch_counts() -> None:
    LAUNCHES["grouped_gemm"] = 0


def _tag(dtype) -> str:
    try:
        return _TAGS[dtype]
    except KeyError:
        raise ValueError(f"the grouped GEMM kernel takes bf16 or f32 "
                         f"operands, not {dtype}") from None


def grouped_tile(c: int, dtype) -> TileConfig:
    """The ``(bc, bf, bk)`` thread-block tile for capacity ``c``: bc is the
    smallest power of two >= min(c, 128)."""
    bc = 1
    while bc < min(max(c, 1), MAX_BLOCK_C):
        bc *= 2
    return TileConfig(bc, BLOCK_F, BLOCK_K[_tag(dtype)])


def grouped_gemm_plain(x, w):
    """Plain PyTorch version of :func:`grouped_gemm`."""
    return ref.grouped_gemm_ref(x, w)


def _check(x, w) -> None:
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"operands {tuple(x.shape)} @ {tuple(w.shape)} are "
                         f"not an (E, C, D) @ (E, D, F) pair")
    if x.dtype != w.dtype:
        raise ValueError(f"operand dtypes differ: {x.dtype} vs {w.dtype}")
    _tag(x.dtype)


def _launch(x, w, y, tile: TileConfig) -> None:
    from repro_torch.kernels import build

    e, c, d = x.shape
    f = w.shape[2]
    lib = build.load(f"grouped_gemm_{_tag(x.dtype)}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_grouped_gemm(x.data_ptr(), w.data_ptr(),
                                     y.data_ptr(), e, c, d, f, tile.bm,
                                     tile.bn, tile.bk, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"grouped gemm kernel launch failed for "
                           f"({e}, {c}, {d}) @ ({e}, {d}, {f}) on tile "
                           f"{tile}: {msg} (cuda error {err})")


def grouped_gemm(x, w, *, tile: TileConfig | None = None):
    """x: (E, C, D) @ w: (E, D, F) -> (E, C, F) in ``x.dtype``.

    ``tile`` overrides :func:`grouped_tile`; a tile the kernel does not take
    (over the shared-memory limit, or a register tile it was not compiled
    for) raises ValueError, on any device."""
    _check(x, w)
    tile = grouped_tile(x.shape[1], x.dtype) if tile is None else tile
    launch_config(tile, x.dtype)
    if _on_cpu(x, w):
        return grouped_gemm_plain(x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the grouped GEMM kernel takes contiguous operands")
    if x.device != w.device:
        raise ValueError("operands on different CUDA devices")
    y = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype,
                    device=x.device)
    _launch(x, w, y, tile)
    LAUNCHES["grouped_gemm"] += 1
    return y
