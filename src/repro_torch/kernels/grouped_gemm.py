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

Two routes, by dtype (:func:`route`), as for the GEMM (``kernels/gemm.py``):

* ``"wgmma"``: bf16 runs on the tensor cores, the kernel body of
  ``csrc/wgmma_gemm.cuh`` with the expert as ``blockIdx.z`` and rank-3
  tensor maps, so every TMA box fills and clips at its own expert's edges.
  The tile (:func:`grouped_tile`) is bc = C rounded up to a power of two
  (at most 128) tokens by 64 F columns, in slabs 64 deep, in a ring of at
  most three stages (:func:`grouped_config`): the kernel is bound by bytes,
  and its blocks are short-lived, so what matters is many blocks in flight
  on every SM, each with a few slabs of weights.  Each encoded tensor map
  is kept, keyed by everything the encoding is a function of
  (:func:`map_key`), so the expert weights' maps are encoded once and a
  call encodes none.  Operands whose rows TMA cannot read (D or F not a
  multiple of 8, a misaligned base) are first copied once to aligned rows
  (``kernels.gemm.aligned_copy``, counted in ``COPIES["aligned"]``).  The
  backward products' ``x.transpose(1, 2)`` and ``w.transpose(1, 2)``
  (views of contiguous tensors) are read in place, in wgmma's transposed
  layouts (``kernels.gemm.wgmma_layout``); an MN-major x's blocks walk the
  tiles of every expert persistently.
* ``"cuda_cores"``: f32 runs the GEMM's CUDA-core kernel,
  ``csrc/tile_gemm.cuh`` (FP32 FMA: TF32 would not compute the f32
  function), with the expert as ``blockIdx.z``, on a bc x 128 x 128 tile:
  register tiles of 4-wide fragments fed by a cp.async ring of weight
  sub-slabs (``kernels.gemm.launch_config``).  It reads contiguous
  operands only: a transposed view is copied once (counted in
  ``COPIES["transposed"]``; so is bf16's x when both operands are
  transposed).

A tile the route does not take raises ValueError, on any device.  Ragged
edges are handled in the kernels, so C, D and F need not divide the tile.

``grouped_gemm_plain`` beside it is the same function in plain PyTorch
(``ref.grouped_gemm_ref``).  The wrapper runs it only when its operands lie
on the CPU; CUDA operands launch the kernel or raise.
``LAUNCHES["grouped_gemm"]`` counts kernel launches, one per launch, and
nothing else; ``ROUTES`` counts the same launches by route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.tpu_model import TileConfig
from repro_torch.kernels import build, ref
from repro_torch.kernels import gemm as K
from repro_torch.kernels.gemm import on_device, raw_stream

#: kernel launches since the last reset
LAUNCHES = {"grouped_gemm": 0}
#: the same launches by route: tensor cores (bf16) or CUDA cores (f32)
ROUTES = {"wgmma": 0, "cuda_cores": 0}
#: operands copied before a launch: into a TMA-aligned buffer (wgmma), or
#: from a transposed view the route does not read in place
COPIES = {"aligned": 0, "transposed": 0}
_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32"}
MAX_BLOCK_C = 128
#: the CUDA-core route's tile: bf x bk
BLOCK_F = 128
BLOCK_K = 128
#: the wgmma route's tile: F columns per block (gate/up at F = 512 then has
#: 8 blocks per expert, 320 in all; down at F = 1536, 960) and slab depth
#: (one 64-wide A box and one B box a stage)
WGMMA_BLOCK_F = 64
WGMMA_BLOCK_K = 64
#: blocks the stages are sized to share an SM, and the deepest ring.  More
#: blocks in flight beat a deeper ring for these short-lived blocks: at the
#: served shapes three stages (four blocks per SM, as registers allow) took
#: less time than two, four or as many as fit three blocks (chip_smoke.py
#: phase 6, PERF.md)
WGMMA_BLOCKS_PER_SM = 3
WGMMA_MAX_STAGES = 3
#: an H100 SM's shared memory, and what the system keeps of it per block
SM_SMEM_BYTES = K.SM_SMEM_BYTES
BLOCK_RESERVED_SMEM = K.BLOCK_RESERVED_SMEM
SMS = K.SMS


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTES, COPIES):
        for name in counts:
            counts[name] = 0


def _tag(dtype) -> str:
    try:
        return _TAGS[dtype]
    except KeyError:
        raise ValueError(f"the grouped GEMM kernel takes bf16 or f32 "
                         f"operands, not {dtype}") from None


def route(dtype) -> str:
    """``"wgmma"`` for bf16 operands, ``"cuda_cores"`` for f32."""
    return "wgmma" if _tag(dtype) == "bf16" else "cuda_cores"


def grouped_tile(c: int, dtype) -> TileConfig:
    """The ``(bc, bf, bk)`` thread-block tile of the route for capacity
    ``c``: bc is the smallest power of two >= min(c, 128)."""
    bc = 1
    while bc < min(max(c, 1), MAX_BLOCK_C):
        bc *= 2
    if route(dtype) == "wgmma":
        return TileConfig(bc, WGMMA_BLOCK_F, WGMMA_BLOCK_K)
    return TileConfig(bc, BLOCK_F, BLOCK_K)


def grouped_config(tile: TileConfig, layout: tuple[int, int] = (0, 1)
                   ) -> K.WgmmaConfig:
    """How the wgmma route runs ``tile`` (bc x bf tokens by columns, slabs
    bk deep) on operands in ``layout`` (``kernels.gemm.wgmma_layout``): as
    many stages as fit :data:`WGMMA_BLOCKS_PER_SM` blocks to an SM, at
    most :data:`WGMMA_MAX_STAGES`; a tile of which two stages do not fit
    that share gets as many as fit a block's whole limit.  A transposed
    layout takes ``kernels.gemm.WGMMA_TRANSPOSED_STAGES``, as many as fit
    a block's limit, and an MN-major x walks its tiles (two stages at
    least: its consumers release a stage one slab late).  Raises
    ValueError for a tile the route does not take (one stage over the
    232,448 B a Hopper block may claim)."""
    bm, bn, bk = tile.bm, tile.bn, tile.bk
    if not all(v > 0 and v & (v - 1) == 0 for v in (bm, bn, bk)):
        raise ValueError(f"tile {tile}: the kernels take power-of-two "
                         f"bm, bn, bk")
    ta, tb = layout
    if ta and not tb:
        raise ValueError("the bf16 route reads one transposed operand at a "
                         "time")
    walk = bool(ta)
    stage, rest = K._wgmma_stage(bm, bn, bk, bn >= 8, ta, tb)
    share = SM_SMEM_BYTES // WGMMA_BLOCKS_PER_SM - BLOCK_RESERVED_SMEM
    fit = (share - rest) // (stage + 16)
    if fit < 2:
        fit = (K.MAX_SMEM_BYTES - rest) // (stage + 16)
    if fit < (2 if walk else 1):
        raise ValueError(
            f"tile {tile}: {2 if walk else 1} {stage}-byte stage(s) exceed "
            f"the {K.MAX_SMEM_BYTES} bytes of shared memory a Hopper block "
            f"may claim")
    stages = min(fit, WGMMA_MAX_STAGES)
    if ta or not tb:
        # the backward products are deeper than a served step's: a ring of
        # kernels.gemm.WGMMA_TRANSPOSED_STAGES, as a block's limit allows
        # (two blocks an SM at 128 x 64 x 64, where three stages of the
        # row-major ring fit three)
        stages = min(K.WGMMA_TRANSPOSED_STAGES,
                     (K.MAX_SMEM_BYTES - rest) // (stage + 16))
    bnp = max(bn, K.WGMMA_BOX_COLS)
    nw = min(bnp, 256)
    units = -(-max(bm, 8) // 64) * (bnp // nw)
    consumers = 1 if units < 2 or nw == 256 else 2     # as wgmma_config
    smem, threads = K._wgmma_smem(stage, rest, stages), consumers * 128 + 32
    return K.WgmmaConfig(nw, consumers, -(-units // consumers), bk, stages,
                         stage, smem, threads, walk,
                         K.resident_blocks(smem, threads))


def check_tile(tile: TileConfig, dtype, layout: tuple[int, int] = (0, 1)):
    """The route's config for ``tile`` (:func:`grouped_config` for bf16, in
    the operands' ``layout``, ``kernels.gemm.launch_config`` for f32);
    raises ValueError for a tile the route does not take."""
    if route(dtype) == "wgmma":
        return grouped_config(tile, layout)
    return K.launch_config(tile, dtype)


def resident_blocks(cfg: K.WgmmaConfig) -> int:
    """Blocks of ``cfg`` one SM holds at once by shared memory."""
    return SM_SMEM_BYTES // (cfg.smem_bytes + BLOCK_RESERVED_SMEM)


def grid_blocks(e: int, c: int, f: int, tile: TileConfig) -> int:
    """Thread blocks of one launch: experts x C tiles x F tiles."""
    return e * -(-c // tile.bm) * -(-f // tile.bn)


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


class Plan(NamedTuple):
    """What one call signature (shapes, dtypes, layout, tile) needs:
    checked and configured once, since both follow from the signature
    alone."""
    e: int
    c: int
    d: int
    f: int
    tile: TileConfig
    route: str
    ks: int         #: the wgmma route's slab depth, stages and raster
    stages: int     #: group (0 on the CUDA-core route)
    group: int
    #: wgmma's transpose bits for x and w as read (:func:`layout`)
    layout: tuple[int, int] = (0, 1)


#: plans by (x's shape, w's shape, dtypes, layout, the tile asked for);
#: dropped past :data:`MAX_PLANS`
_PLANS: dict[tuple, Plan] = {}
MAX_PLANS = 256


def stored_transposed(t) -> bool:
    """Whether the 3-D operand ``t`` is the ``transpose(1, 2)`` of a
    contiguous tensor, not contiguous itself; raises ValueError for one
    that is neither."""
    if t.is_contiguous():
        return False
    if t.transpose(1, 2).is_contiguous():
        return True
    raise ValueError("the grouped GEMM kernel takes contiguous operands "
                     "and their transpose(1, 2) views")


def layout(x, w) -> tuple[int, int]:
    """wgmma's transpose bits ``(ta, tb)`` for the operands as the route
    reads them: ``ta = 1`` for an x stored transposed, ``tb = 0`` for a w
    stored transposed; bf16 reads one of them at a time (with both, x is
    copied first: :func:`_as_read`), f32 neither."""
    if route(x.dtype) != "wgmma":
        return 0, 1
    tw = stored_transposed(w)
    return int(stored_transposed(x) and not tw), int(not tw)


def plan(x, w, tile: TileConfig | None = None,
         lay: tuple[int, int] | None = None) -> Plan:
    """The :class:`Plan` of ``grouped_gemm(x, w, tile=tile)`` in the layout
    ``lay`` (default: :func:`layout`); raises ValueError for operands or a
    tile the kernels do not take."""
    _check(x, w)
    lay = layout(x, w) if lay is None else lay
    key = (x.shape, w.shape, x.dtype, w.dtype, lay, tile)
    p = _PLANS.get(key)
    if p is None:
        e, c, d = x.shape
        f = w.shape[2]
        t = grouped_tile(c, x.dtype) if tile is None else tile
        cfg = check_tile(t, x.dtype, lay)
        rt = route(x.dtype)
        p = (Plan(e, c, d, f, t, rt, cfg.ks, cfg.stages,
                  K.raster_group(c, d, t.bm), lay) if rt == "wgmma"
             else Plan(e, c, d, f, t, rt, 0, 0, 0))
        if len(_PLANS) >= MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = p
    return p


#: x, w and y as the tensor maps see them
OPERANDS = {"x": 0, "w": 1, "y": 2}
#: encoded tensor maps (128 bytes each) by :func:`map_key`; the oldest go
#: first past :data:`MAX_MAPS`
_MAPS: dict[tuple, ctypes.Array] = {}
MAX_MAPS = 1024


def map_key(operand: str, ptr: int, rows: int, cols: int, depth: int,
            ld: int, plane: int, tile: TileConfig, trans: bool = False
            ) -> tuple:
    """What the tensor map of one operand is a pure function of: its base
    address, its extents as stored (``depth`` matrices of ``rows`` x
    ``cols``), its strides (``ld`` between rows, ``plane`` between
    experts, in elements), whether it is read as its transpose (``trans``)
    and, through the tile and that layout, its box and swizzle.  A map kept
    under this key is right for any tensor with these values, whatever
    memory it reuses."""
    return (OPERANDS[operand], ptr, rows, cols, depth, ld, plane, tile.bm,
            tile.bn, tile.bk, bool(trans))


def _tensor_map(lib, operand: str, ptr: int, rows: int, cols: int,
                depth: int, ld: int, tile: TileConfig, trans: bool = False):
    key = map_key(operand, ptr, rows, cols, depth, ld, rows * ld, tile,
                  trans)
    m = _MAPS.get(key)
    if m is None:
        m = ctypes.create_string_buffer(128)
        err = lib.repro_grouped_encode(m, ptr, rows, cols, depth, ld,
                                       rows * ld, key[0], tile.bm, tile.bn,
                                       tile.bk, int(trans))
        if err != 0:
            msg = lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"tensor map of {operand} ({depth}, {rows}, "
                               f"{cols}) on tile {tile}: {msg} (error {err})")
        if len(_MAPS) >= MAX_MAPS:
            del _MAPS[next(iter(_MAPS))]
        _MAPS[key] = m
    return m


def tma_rows(t, cols: int):
    """The contiguous operand ``t``, its experts' matrices of ``cols``
    columns stacked, as TMA reads it: ``(t, or an aligned copy of its
    rows, the row stride, copied)``.  Rows of whole 16-byte units on a
    16-byte aligned base are read in place (the served shapes: no view, no
    copy); any other rows are copied once (``kernels.gemm.aligned_copy``)."""
    if cols % 8 == 0 and t.data_ptr() % 16 == 0:
        return t, cols, False
    t = t.view(-1, cols)
    if K.needs_aligned_copy(t):
        with obs.span("gemm.copy", kind="aligned"):
            t = K.aligned_copy(t)
        return t, K._tma_row_stride(t), True
    return t, K._tma_row_stride(t), False


def _launch(x, w, y, p: Plan) -> None:
    """One launch of the route's kernel: y = x @ w per expert."""
    if p.route == "wgmma":
        _launch_wgmma(x, w, y, p)
        return
    e, c, d, f, tile = p.e, p.c, p.d, p.f, p.tile
    lib = build.load("grouped_gemm_f32")
    with on_device(x):
        err = lib.repro_grouped_gemm(x.data_ptr(), w.data_ptr(),
                                     y.data_ptr(), e, c, d, f, tile.bm,
                                     tile.bn, tile.bk, raw_stream(x))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"grouped gemm kernel launch failed for "
                           f"({e}, {c}, {d}) @ ({e}, {d}, {f}) on tile "
                           f"{tile}: {msg} (cuda error {err})")


def _launch_wgmma(x, w, y, p: Plan) -> None:
    e, c, d, f, tile = p.e, p.c, p.d, p.f, p.tile
    ta, tb = p.layout
    lib = build.load("grouped_gemm_bf16")
    # each operand as stored: x (C, D) a matrix, or x^T's (D, C); w (D, F),
    # or w^T's (F, D).  The operands read (aligned copies among them) live
    # until the launch is enqueued
    xs = x.transpose(1, 2) if ta else x
    ws = w if tb else w.transpose(1, 2)
    xa, ldx, cx = tma_rows(xs, xs.shape[2])
    wa, ldw, cw = tma_rows(ws, ws.shape[2])
    COPIES["aligned"] += cx + cw
    with on_device(y):
        mx = _tensor_map(lib, "x", xa.data_ptr(), *xs.shape[1:], e, ldx,
                         tile, ta)
        mw = _tensor_map(lib, "w", wa.data_ptr(), *ws.shape[1:], e, ldw,
                         tile, not tb)
        # y (fresh, contiguous) goes out by TMA where its rows are 16 bytes
        my = (_tensor_map(lib, "y", y.data_ptr(), c, f, e, f, tile)
              if f % 8 == 0 and y.data_ptr() % 16 == 0 and tile.bn >= 8
              else None)
        err = lib.repro_grouped_gemm_wgmma(
            mx, mw, my, y.data_ptr(), e, c, d, f, f, c * f, tile.bm, tile.bn,
            p.ks, p.stages, p.group, ta, tb, raw_stream(y))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"grouped wgmma launch failed for ({e}, {c}, {d}) "
                           f"@ ({e}, {d}, {f}) on tile {tile}: {msg} (cuda "
                           f"error {err})")


def _as_read(x, w, p: Plan):
    """x and w as the route reads them: a transposed view the plan's layout
    does not read in place (f32: any; bf16: x when both are transposed) is
    copied contiguous once, counted in ``COPIES["transposed"]``."""
    ta, tb = p.layout
    if not ta and stored_transposed(x):
        with obs.span("gemm.copy", kind="transposed"):
            x = x.contiguous()
        COPIES["transposed"] += 1
    if tb and stored_transposed(w):
        with obs.span("gemm.copy", kind="transposed"):
            w = w.contiguous()
        COPIES["transposed"] += 1
    return x, w


def grouped_gemm(x, w, *, tile: TileConfig | None = None):
    """x: (E, C, D) @ w: (E, D, F) -> (E, C, F) in ``x.dtype``.  Each
    operand is contiguous or the ``transpose(1, 2)`` of a contiguous
    tensor (:func:`layout`).

    ``tile`` overrides :func:`grouped_tile`; a tile the route does not take
    raises ValueError, on any device."""
    cpu = not (x.is_cuda and w.is_cuda) and K._on_cpu(x, w)
    # the plain version reads any strides: a CPU call checks the tile in
    # the row-major layout
    p = plan(x, w, tile, (0, 1) if cpu else None)
    if cpu:
        return grouped_gemm_plain(x, w)
    if x.get_device() != w.get_device():
        raise ValueError("operands on different CUDA devices")
    y = x.new_empty((p.e, p.c, p.f))
    if not y.numel():
        return y
    if p.d == 0:
        return y.zero_()
    x, w = _as_read(x, w, p)
    _launch(x, w, y, p)
    LAUNCHES["grouped_gemm"] += 1
    ROUTES[p.route] += 1
    return y
