"""The H100 tile cost model: what the ``cuda`` backend's GEMM kernels cost.

``core/tpu_model.py`` prices a Pallas GEMM on a TPU: a VMEM budget, sublane
and lane padding, the MXU rate.  This module is its counterpart for the
port's hand-written Hopper kernels (``kernels/gemm.py``), and prices what
they do.  Each route's geometry comes from the wrappers' own config
functions (:func:`kernels.gemm.wgmma_config` for bf16,
:func:`~kernels.gemm.int8_config` for int8, :func:`~kernels.gemm.launch_config`
for f32 on the CUDA cores, :func:`~kernels.gemm.check_tile` for what a route
takes), so the model and the kernels cannot drift apart.

The time of one ``plan.execute`` call (what the ``cuda`` harness times: the
wrapper call and its device work, to a synchronize) is a plain sum of terms,
each a count times one machine constant:

* **arithmetic** — operations the SMs spend, over the dtype's own rate
  (``arith_rate[dtype]``: bf16 and int8 on wgmma, f32 on the CUDA cores).
  A block computes its tile padded to the unit its route uses (wgmma: m64
  rows per consumer warpgroup, the instruction's N, in rounds; f32: the
  register tiles, which cover bm x bn) and K padded to its slab depth.
  Blocks run in waves of ``SMS x resident`` (resident blocks per SM from
  the config's shared memory and threads, and for f32 also the registers
  its instantiations take), and a wave costs as much as a full one.
* **HBM bytes** (``M->L2``) — A, B and C once; the copies a call makes
  (k-outer's zeroed C and its clone, int8's transposed B, an operand TMA
  cannot read in place); re-fetched tiles whose wave does not fit in L2;
  k-outer's C stream when C does not.
* **L2 bytes** (``L2->L1``) — re-fetched A and B tiles (every tile a block
  stages beyond the compulsory bytes) when a wave's working set fits in
  L2, and k-outer's C stream (C read and written every pass) when C does.
* **per call** — the wrapper's host cost in its dtype
  (``call_costs[dtype]``) once, and ``call_costs["launch"]`` per device
  operation it enqueues (k-outer: one per k block).

No term overlaps another: :attr:`HopperCost.total` is the sum, and it is
exactly the function ``Calibrator(model="hopper")`` fits, so a fitted
spec predicts with the rates its fit solved for.  :func:`estimate_batch`
replays :func:`estimate` over a (problem x candidate) lattice with the
same operations in the same order, bit for bit; :func:`tune_batch` takes
the argmin over every lattice tile :func:`~kernels.gemm.check_tile`
accepts, in both loop orders.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core.autotune import _CAND_K, _CAND_MN
from repro_torch.core.tpu_model import (
    DTYPE_BYTES,
    GemmShape,
    GridOrder,
    TileConfig,
)
from repro_torch.kernels import gemm as K
from repro_torch.machines.spec import MachineSpec

#: the dtypes the port's GEMM kernels compute
DTYPES = ("bf16", "int8", "f32")
#: bytes of one element of C: int8 products accumulate into int32
OUT_BYTES = {"bf16": 2, "int8": 4, "f32": 4}
#: the row alignment (bytes) TMA reads in place
TMA_ROW_ALIGN = 16


class TileGeometry(NamedTuple):
    """How the route of one dtype runs one tile, as the model counts it."""
    route: str          #: "wgmma" or "cuda_cores"
    ks: int             #: slab (wgmma) or sub-slab (f32) depth
    work: int           #: C elements a block computes per k, padded
    resident: int       #: blocks one SM holds at once
    piece_bytes: int    #: bytes a block stages per ks of K, all rounds


@functools.lru_cache(maxsize=None)
def tile_geometry(tile: TileConfig, dtype: str) -> TileGeometry:
    """The route's geometry for ``tile`` in ``dtype``, from the wrappers'
    config functions; raises ValueError for a tile the route does not
    take (:func:`kernels.gemm.check_tile`)."""
    if dtype not in DTYPES:
        raise ValueError(f"the GEMM kernels compute {DTYPES}, not {dtype!r}")
    k_outer = tile.order is GridOrder.K_OUTER
    cfg = K.check_tile(tile, dtype, k_outer=k_outer)
    if K.route(dtype) == "cuda_cores":
        cfg = K.launch_config(tile, dtype, k_outer=k_outer)
        resident = min(cfg.blocks_per_sm,
                       K.SM_REGISTERS // (cfg.threads * K.CORE_REGISTERS))
        return TileGeometry("cuda_cores", cfg.ks, tile.bm * tile.bn,
                            max(1, resident),
                            (tile.bm + tile.bn) * cfg.ks * DTYPE_BYTES[dtype])
    resident = min(K.SM_SMEM_BYTES // (cfg.smem_bytes + K.BLOCK_RESERVED_SMEM),
                   K.SM_THREADS // cfg.threads, K.SM_BLOCKS)
    return TileGeometry("wgmma", cfg.ks,
                        cfg.rounds * cfg.consumers * 64 * cfg.nw, resident,
                        cfg.rounds * cfg.stage_bytes)


@functools.lru_cache(maxsize=None)
def lattice(dtype: str) -> tuple[TileConfig, ...]:
    """Every tile of TileTuner's (bm, bn, bk) lattice (``_CAND_MN`` x
    ``_CAND_MN`` x ``_CAND_K``) that the route of ``dtype`` takes, in both
    loop orders, k-inner first."""
    out = []
    for bm in _CAND_MN:
        for bn in _CAND_MN:
            for bk in _CAND_K:
                for order in (GridOrder.K_INNER, GridOrder.K_OUTER):
                    t = TileConfig(bm, bn, bk, order)
                    try:
                        tile_geometry(t, dtype)
                    except ValueError:
                        continue
                    out.append(t)
    return tuple(out)


class MachineTerms(NamedTuple):
    """The constants of one machine the model charges, for one dtype."""
    arith: float        #: ops/s of the dtype's route
    hbm: float          #: bytes/s, M -> L2
    l2: float           #: bytes/s, L2 -> L1
    call: float         #: seconds per wrapper call in the dtype
    launch: float       #: seconds per enqueued device operation
    l2_bytes: int       #: L2 capacity


def machine_terms(machine: MachineSpec, dtype: str) -> MachineTerms:
    """The constants the model needs from ``machine``; raises ValueError
    for a machine without them (an L2 level of its own, M->L2 and L2->L1
    rates, the dtype's arithmetic rate and its per-call costs)."""
    lv = machine.level
    if lv("L2") in (lv("M"), lv("L1")):
        raise ValueError(
            f"{machine.name}: the Hopper tile model needs an L2 level of its "
            f"own (levels {list(machine.levels)}, L2 -> {lv('L2')!r})")
    missing = [key for key in (dtype, "launch")
               if key not in machine.call_costs]
    if dtype not in machine.arith_rate:
        missing.append(f"arith_rate[{dtype}]")
    try:
        hbm, l2 = machine.rate("M", "L2"), machine.rate("L2", "L1")
    except KeyError as e:
        raise ValueError(f"{machine.name}: the Hopper tile model needs "
                         f"M->L2 and L2->L1 rates ({e})") from None
    if missing:
        raise ValueError(f"{machine.name}: the Hopper tile model needs "
                         f"call_costs and rates for {missing}")
    return MachineTerms(machine.arith_rate[dtype], hbm, l2,
                        machine.call_costs[dtype],
                        machine.call_costs["launch"], machine.capacity("L2"))


def _check_shape(shape: GemmShape) -> None:
    if shape.dtype not in DTYPES:
        raise ValueError(f"the GEMM kernels compute {DTYPES}, not "
                         f"{shape.dtype!r}")
    if shape.mixed_precision is not None:
        raise ValueError("the GEMM kernels compute one dtype; mixed "
                         "precision has no kernel on the card")


@dataclasses.dataclass(frozen=True)
class HopperCost:
    """Predicted cost of one ``cuda`` GEMM call on a Hopper card."""
    shape: GemmShape
    tile: TileConfig
    route: str
    blocks: int
    waves: int
    flops: float        #: padded operations the waves spend
    hbm_bytes: float    #: bytes served by HBM
    l2_bytes: float     #: bytes served by L2
    calls: int          #: wrapper calls (one)
    launches: int       #: device operations the call enqueues
    t_compute: float
    t_hbm: float
    t_l2: float
    t_call: float
    t_launch: float

    @property
    def total(self) -> float:
        """The sum of the terms: nothing overlaps in this model."""
        return (self.t_compute + self.t_hbm + self.t_l2 + self.t_call
                + self.t_launch)


def estimate(shape: GemmShape, tile: TileConfig,
             machine: MachineSpec) -> HopperCost:
    """The predicted cost of running ``shape`` on ``tile`` (see the module
    docstring for the terms).  Raises ValueError for a tile the route does
    not take or a machine without the model's constants."""
    _check_shape(shape)
    dt = shape.dtype
    g = tile_geometry(tile, dt)
    mt = machine_terms(machine, dt)
    m, n, k = shape.m, shape.n, shape.k
    s, so = DTYPE_BYTES[dt], OUT_BYTES[dt]
    bm, bn, bk = tile.bm, tile.bn, tile.bk
    inner = tile.order is GridOrder.K_INNER
    gm, gn, gk = -(-m // bm), -(-n // bn), -(-k // bk)
    blocks = gm * gn
    slots = K.SMS * g.resident
    waves = -(-blocks // slots)
    pieces = -(-k // g.ks)
    flops = 2.0 * waves * slots * g.work * pieces * g.ks
    loads = float(blocks) * pieces * g.piece_bytes
    ab = float((m * k + k * n) * s)
    refetch = max(loads - ab, 0.0)
    # Raster order (kernels/gemm.py:raster_group): blocks walk groups of
    # m tiles, m fastest.  A wave of blocks reads the same k slabs at about
    # the same time, so its blocks' re-reads of one another's tiles are L2
    # hits; a tile a later wave reads again is one only when all the A rows
    # and B columns a wave reads (over the depth one launch covers) fit.
    depth = k if inner else min(bk, k)
    group = max(1, min(gm, K.RASTER_L2_BYTES // (bm * depth * s)))
    front = min(slots, blocks)
    per_wave = max(1, front // (group * gn))    # whole groups in a wave
    cols = min(gn, -(-front // group))          # n tiles a wave reads
    rows = min(gm, group * per_wave)            # m tiles a wave reads
    wave_set = (rows * bm + cols * bn) * depth * s
    groups = -(-gm // group)
    later = float(((-(-gn // cols) - 1) * m * k
                   + (-(-groups // per_wave) - 1) * k * n) * s)
    later = min(later, refetch)
    c = float(m * n * so)
    fits_c = m * n * so <= mt.l2_bytes
    hbm, l2 = ab, refetch - later
    if wave_set <= mt.l2_bytes:
        l2 = l2 + later
    else:
        hbm = hbm + later
    launches = 1
    if inner:
        hbm = hbm + c
        if shape.accumulate:            # c + out: two reads, one write
            hbm = hbm + 3.0 * c
            launches += 1
    else:
        stream = 2.0 * gk * c           # C read and written every pass
        if fits_c:
            l2 = l2 + stream
        else:
            hbm = hbm + stream
        hbm = hbm + 2.0 * c             # the clone the passes update
        launches += gk
        if not shape.accumulate:        # the zeroed C the call starts from
            hbm = hbm + c
            launches += 1
    if dt == "int8":                    # B written transposed, rows of 16
        hbm = hbm + float(k * n + n * (-(-k // 16) * 16))
        launches += 1
    if g.route == "wgmma":              # copies into TMA-aligned rows
        if m > 1 and (k * s) % TMA_ROW_ALIGN:
            hbm = hbm + 2.0 * m * k * s
            launches += 1
        if dt == "bf16" and k > 1 and (n * s) % TMA_ROW_ALIGN:
            hbm = hbm + 2.0 * k * n * s
            launches += 1
    return HopperCost(
        shape=shape, tile=tile, route=g.route, blocks=blocks, waves=waves,
        flops=flops, hbm_bytes=hbm, l2_bytes=l2, calls=1, launches=launches,
        t_compute=flops / mt.arith, t_hbm=hbm / mt.hbm, t_l2=l2 / mt.l2,
        t_call=1 * mt.call, t_launch=launches * mt.launch)


# ---------------------------------------------------------------------------
# Batched evaluation: ``estimate`` as a NumPy array program over a
# (problem x candidate) lattice.  Every float operation replays the scalar
# one in the same order (integer intermediates are exact in int64), so
# totals are bit-identical and argmin selections agree.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TileArrays:
    """Candidate tiles and their geometry as flat arrays."""
    bm: np.ndarray
    bn: np.ndarray
    bk: np.ndarray
    k_inner: np.ndarray
    ks: np.ndarray
    work: np.ndarray
    resident: np.ndarray
    piece_bytes: np.ndarray
    wgmma: np.ndarray

    @classmethod
    def of(cls, tiles: Sequence[TileConfig], dtypes: Sequence[str]
           ) -> "TileArrays":
        """Arrays of ``tiles``, the i-th priced for ``dtypes[i]``."""
        geo = [tile_geometry(t, dt) for t, dt in zip(tiles, dtypes)]
        i64 = np.int64
        return cls(
            bm=np.array([t.bm for t in tiles], i64),
            bn=np.array([t.bn for t in tiles], i64),
            bk=np.array([t.bk for t in tiles], i64),
            k_inner=np.array([t.order is GridOrder.K_INNER for t in tiles],
                             bool),
            ks=np.array([g.ks for g in geo], i64),
            work=np.array([g.work for g in geo], i64),
            resident=np.array([g.resident for g in geo], i64),
            piece_bytes=np.array([g.piece_bytes for g in geo], i64),
            wgmma=np.array([g.route == "wgmma" for g in geo], bool))


@functools.lru_cache(maxsize=None)
def lattice_arrays(dtype: str) -> TileArrays:
    """:class:`TileArrays` of :func:`lattice` for ``dtype``."""
    tiles = lattice(dtype)
    return TileArrays.of(tiles, [dtype] * len(tiles))


@dataclasses.dataclass(frozen=True)
class HopperCostBatch:
    """Structure-of-arrays :class:`HopperCost` (broadcast shapes)."""
    flops: np.ndarray
    hbm_bytes: np.ndarray
    l2_bytes: np.ndarray
    calls: np.ndarray
    launches: np.ndarray
    waves: np.ndarray
    t_compute: np.ndarray
    t_hbm: np.ndarray
    t_l2: np.ndarray
    t_call: np.ndarray
    t_launch: np.ndarray

    @property
    def total(self) -> np.ndarray:
        return (self.t_compute + self.t_hbm + self.t_l2 + self.t_call
                + self.t_launch)


def estimate_batch(shapes: Sequence[GemmShape], tiles: TileArrays,
                   machine: MachineSpec, *, lattice: bool = False
                   ) -> HopperCostBatch:
    """Vectorized :func:`estimate`.  With ``lattice=False`` the i-th shape
    is priced on the i-th tile (``(P,)`` results, the tiles' geometry for
    each shape's dtype); with ``lattice=True`` every shape on every tile
    (``(P, C)``; the tiles' geometry must be that of the shapes' one
    dtype)."""
    for sh in shapes:
        _check_shape(sh)
    terms = [machine_terms(machine, sh.dtype) for sh in shapes]

    def col(values, dtype):
        a = np.array(values, dtype)
        return a[:, None] if lattice else a

    i64, f64 = np.int64, np.float64
    m = col([sh.m for sh in shapes], i64)
    n = col([sh.n for sh in shapes], i64)
    k = col([sh.k for sh in shapes], i64)
    s = col([DTYPE_BYTES[sh.dtype] for sh in shapes], i64)
    so = col([OUT_BYTES[sh.dtype] for sh in shapes], i64)
    acc = col([sh.accumulate for sh in shapes], bool)
    int8 = col([sh.dtype == "int8" for sh in shapes], bool)
    bf16 = col([sh.dtype == "bf16" for sh in shapes], bool)
    arith = col([t.arith for t in terms], f64)
    r_hbm = col([t.hbm for t in terms], f64)
    r_l2 = col([t.l2 for t in terms], f64)
    call = col([t.call for t in terms], f64)
    launch = col([t.launch for t in terms], f64)
    l2_cap = col([t.l2_bytes for t in terms], i64)

    bm, bn, bk, inner = tiles.bm, tiles.bn, tiles.bk, tiles.k_inner
    gm, gn, gk = -(-m // bm), -(-n // bn), -(-k // bk)
    blocks = gm * gn
    slots = K.SMS * tiles.resident
    waves = -(-blocks // slots)
    pieces = -(-k // tiles.ks)
    flops = (2.0 * waves.astype(f64) * slots.astype(f64)
             * tiles.work.astype(f64) * pieces.astype(f64)
             * tiles.ks.astype(f64))
    loads = blocks.astype(f64) * pieces.astype(f64) \
        * tiles.piece_bytes.astype(f64)
    ab = ((m * k + k * n) * s).astype(f64)
    refetch = np.maximum(loads - ab, 0.0)
    depth = np.where(inner, k, np.minimum(bk, k))
    group = np.maximum(1, np.minimum(gm, K.RASTER_L2_BYTES
                                     // (bm * depth * s)))
    front = np.minimum(slots, blocks)
    per_wave = np.maximum(1, front // (group * gn))
    cols = np.minimum(gn, -(-front // group))
    rows = np.minimum(gm, group * per_wave)
    wave_set = (rows * bm + cols * bn) * depth * s
    groups = -(-gm // group)
    later = (((-(-gn // cols) - 1) * m * k
              + (-(-groups // per_wave) - 1) * k * n) * s).astype(f64)
    later = np.minimum(later, refetch)
    c = (m * n * so).astype(f64)
    fits_c = m * n * so <= l2_cap
    fits = wave_set <= l2_cap

    l2 = refetch - later
    l2 = np.where(fits, l2 + later, l2)
    hbm = np.where(fits, ab + np.zeros_like(later), ab + later)
    stream = 2.0 * gk.astype(f64) * c
    l2 = np.where(~inner & fits_c, l2 + stream, l2)
    hbm = np.where(inner, hbm + c,
                   np.where(fits_c, hbm, hbm + stream) + 2.0 * c)
    hbm = np.where(acc, np.where(inner, hbm + 3.0 * c, hbm),
                   np.where(inner, hbm, hbm + c))
    launches = np.where(inner, 1 + acc.astype(i64),
                        1 + gk + (~acc).astype(i64))
    hbm = np.where(int8, hbm + (k * n + n * (-(-k // 16) * 16)).astype(f64),
                   hbm)
    launches = launches + int8.astype(i64)
    copy_a = tiles.wgmma & (m > 1) & ((k * s) % TMA_ROW_ALIGN != 0)
    hbm = np.where(copy_a, hbm + 2.0 * m * k * s, hbm)
    copy_b = tiles.wgmma & bf16 & (k > 1) & ((n * s) % TMA_ROW_ALIGN != 0)
    hbm = np.where(copy_b, hbm + 2.0 * k * n * s, hbm)
    launches = launches + copy_a.astype(i64) + copy_b.astype(i64)
    calls = np.ones_like(launches)
    return HopperCostBatch(
        flops=flops, hbm_bytes=hbm, l2_bytes=l2, calls=calls,
        launches=launches, waves=waves,
        t_compute=flops / arith, t_hbm=hbm / r_hbm, t_l2=l2 / r_l2,
        t_call=calls * call, t_launch=launches * launch)


def tune_batch(shapes: Sequence[GemmShape], machine: MachineSpec
               ) -> list[HopperCost]:
    """The cheapest lattice tile for every shape (the first one on ties,
    in :func:`lattice` order), one vectorized evaluation per dtype; the
    winners are re-priced by the scalar :func:`estimate`."""
    shapes = list(shapes)
    out: list[HopperCost | None] = [None] * len(shapes)
    by_dtype: dict[str, list[int]] = {}
    for i, sh in enumerate(shapes):
        _check_shape(sh)
        by_dtype.setdefault(sh.dtype, []).append(i)
    for dt, idx in by_dtype.items():
        tiles = lattice(dt)
        costs = estimate_batch([shapes[i] for i in idx], lattice_arrays(dt),
                               machine, lattice=True)
        best = np.argmin(costs.total, axis=1)
        for i, j in zip(idx, best):
            out[i] = estimate(shapes[i], tiles[int(j)], machine)
    return out  # type: ignore[return-value]
