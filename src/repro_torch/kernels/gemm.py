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

Two routes, by operand dtype (:func:`route`):

* ``"wgmma"``: bf16 and int8 run on the tensor cores, ``wgmma.mma_async``
  fed by TMA through a ring of shared-memory stages: bf16 in
  ``csrc/wgmma_gemm.cuh`` (configured by :func:`wgmma_config`), int8 (s8 x
  s8 -> s32, exact) in ``csrc/wgmma_s8.cuh`` (:func:`int8_config`).  8-bit
  wgmma reads both operands K-major, so an int8 call first writes B
  transposed, once (:func:`transposed_copy`, a kernel, counted in
  ``COPIES["transposed"]``; all k-outer passes share it).  The tensor maps
  are encoded once per wrapper call; a k-outer pass differs only in its
  k0.  TMA needs 16-byte aligned bases and row strides: an operand without
  them is first copied once into an aligned buffer (:func:`aligned_copy`,
  counted in ``COPIES["aligned"]``).
* ``"cuda_cores"``: f32 runs ``csrc/tile_gemm.cuh`` on the CUDA cores
  (FP32 FMA; no TF32, which would not compute the f32 function): register
  tiles read as 16-byte fragments from a cp.async ring of sub-slabs,
  configured by :func:`launch_config`.  A call resolves the library once
  and passes each launch its k range, so a k-outer pass is one ctypes
  call.

Bound on an H100: at the planner's tiles and Qwen2-1.5B's shapes k-inner is
bound by operations; at decode (M of a few rows) by the bytes of B; k-outer
by the C stream its variant defines.  Design notes are in the CUDA sources.

Each kernel has a plain PyTorch version beside it (``*_plain``), the same
function computed by ``kernels/ref.py``.  A wrapper runs the plain version
only when its operands lie on the CPU; CUDA operands launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches, one per launch, and nothing
else.  Unlike the Pallas kernels, these mask ragged edges themselves, so
shapes need not divide the tile.  ``ROUTES`` counts the same launches by
route, so a run can show that every bf16 and int8 launch used ``wgmma``.
The transpose that precedes an int8 launch is not a GEMM launch: it is
counted in ``COPIES`` only.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.core.tpu_model import DTYPE_BYTES, GridOrder, TileConfig
from repro_torch.kernels import ref

#: shared memory one Hopper thread block may claim (bytes)
MAX_SMEM_BYTES = 232448
MAX_THREADS = 256
#: accumulators one thread of the CUDA-core kernel keeps, at most
MAX_REGISTER_TILE = 64
#: registers ptxas gives a thread of the CUDA-core kernel's compile-time
#: instantiations (254-255; ``chip_smoke.py`` phase 1 prints them): what
#: bounds an SM's resident blocks besides :func:`launch_config`'s shared
#: memory and threads
CORE_REGISTERS = 255
#: an H100 SM's register file (32-bit registers)
SM_REGISTERS = 65536
#: floats after each row of A's sub-slab in a CUDA-core stage (sub-slabs
#: of 4 k or more; shallower rows are packed)
A_ROW_PAD = 4
#: sub-slabs the CUDA-core kernel's cp.async ring holds, at most
CORE_STAGES = 3

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"gemm_k_inner": 0, "gemm_k_outer": 0}
#: the same launches by route: tensor cores (bf16, int8) or CUDA cores
ROUTES = {"wgmma": 0, "cuda_cores": 0}
#: operands copied before a wgmma launch: into a TMA-aligned buffer, or
#: (int8's B) transposed
COPIES = {"aligned": 0, "transposed": 0}

_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTES, COPIES):
        for name in counts:
            counts[name] = 0


def route(dtype) -> str:
    """``"wgmma"`` for bf16 and int8 operands, ``"cuda_cores"`` for f32."""
    return "cuda_cores" if _tag(dtype) == "f32" else "wgmma"


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


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


class CoreConfig(NamedTuple):
    """How ``csrc/tile_gemm.cuh`` runs one tile on the CUDA cores (the f32
    GEMM and the f32 grouped GEMM)."""
    threads: int        #: (bm / rm) x (bn / rn), at most 256
    rm: int             #: rows of C one thread owns (its register tile)
    rn: int             #: columns of C one thread owns
    ks: int             #: sub-slab depth staged at a time; divides bk
    stages: int         #: sub-slabs the cp.async ring holds
    smem_bytes: int     #: dynamic shared memory one block claims
    blocks_per_sm: int  #: resident blocks by shared memory and threads


def register_tile(bm: int, bn: int) -> tuple[int, int]:
    """(rm, rn): the rows and columns of C one thread of a bm x bn block
    owns (``reg_tile`` in csrc/tile_gemm.cuh): 64 accumulators from 8,192
    elements of C, 32 from 2,048, else as many as leave 128 threads (a
    narrow tile has few blocks, and its threads must fill the SM); split as
    square as powers of two allow, rn >= rm, at most 8 a side unless the
    other side is too short, and never more than :data:`MAX_THREADS`
    threads."""
    e = bm * bn
    acc = 64 if e >= 8192 else 32 if e >= 2048 else max(1, e // 128)
    acc = min(acc, min(8, bm) * min(8, bn))
    if e // acc > MAX_THREADS:
        acc = e // MAX_THREADS
    rn = min(8, bn, 1 << (acc.bit_length() // 2))
    rm = acc // rn
    if rm > bm:
        rm, rn = bm, acc // bm
    return rm, rn


def launch_config(tile: TileConfig, dtype="f32", *,
                  k_outer: bool = False) -> CoreConfig:
    """The block that runs ``tile`` on the CUDA-core kernel
    (``csrc/tile_gemm.cuh``, built for f32; shared memory scales with
    ``dtype``'s element size), mirroring its ``tile_config``: the register
    tile of :func:`register_tile`; sub-slabs ``ks`` = min(bk, 32) deep; a
    ring of :data:`CORE_STAGES` stages (a k-outer pass at most as many as
    its sub-slabs, at least two), each bm rows of A (ks + 4 floats; ks
    below 4) and ks rows of B, and for k-outer the bm x bn C tile after
    them.  Where that exceeds a block's shared memory the ring drops to
    two stages, then ks halves.  Raises ValueError for a tile the kernel
    does not take (the same rule ``csrc/gemm.cu`` applies)."""
    bm, bn, bk = tile.bm, tile.bn, tile.bk
    if not (_pow2(bm) and _pow2(bn) and _pow2(bk)):
        raise ValueError(f"tile {tile}: the kernels take power-of-two "
                         f"bm, bn, bk")
    e = bm * bn
    if e > MAX_REGISTER_TILE * MAX_THREADS:
        raise ValueError(
            f"tile {tile}: {e} elements of C need more than "
            f"{MAX_REGISTER_TILE} accumulators on each of {MAX_THREADS} "
            f"threads, past the compiled register tiles")
    s = DTYPE_BYTES[_tag(dtype)]
    rm, rn = register_tile(bm, bn)
    threads = (bm // rm) * (bn // rn)
    ks = min(32, bk)
    stages = min(CORE_STAGES, max(2, bk // ks)) if k_outer else CORE_STAGES
    c_tile = -(-e // 4) * 4 if k_outer else 0

    def need(ks, stages):
        a_row = ks + A_ROW_PAD if ks >= 4 else ks
        stage = -(-bm * a_row // 4) * 4 + ks * -(-bn // 4) * 4
        return (stages * stage + c_tile) * s

    while need(ks, stages) > MAX_SMEM_BYTES:
        if stages > 2:
            stages -= 1
        elif ks > 1:
            ks //= 2
        else:
            raise ValueError(
                f"tile {tile}: {need(ks, stages)} bytes of shared memory "
                f"exceed the {MAX_SMEM_BYTES} a Hopper block may claim")
    smem = need(ks, stages)
    resident = min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM),
                   SM_THREADS // threads, SM_BLOCKS)
    return CoreConfig(threads, rm, rn, ks, stages, smem, resident)


def smem_bytes(tile: TileConfig, dtype="f32", *, k_outer: bool = False) -> int:
    """Dynamic shared memory one block of the CUDA-core kernel
    (``tile_gemm.cuh``: f32 and the f32 grouped GEMM) claims: the cp.async
    ring of :func:`launch_config` and, for k-outer, the C tile; the
    accumulators live in registers.  The wgmma route's is
    :func:`wgmma_config`'s (bf16) or :func:`int8_config`'s."""
    return launch_config(tile, dtype, k_outer=k_outer).smem_bytes


#: bf16 columns of one 128-byte-swizzled TMA box (csrc/wgmma_gemm.cuh)
WGMMA_BOX_COLS = 64
#: shared-memory stages a wgmma block keeps in flight, at most; fewer when
#: fewer fit (see :func:`wgmma_config`).  Two: at the planner's 64x128x128
#: tile two 48 KB stages leave room for a second block on the SM, which
#: measured faster than four stages and one block (PERF.md, PR 14).
WGMMA_STAGES = 2


class WgmmaConfig(NamedTuple):
    """How ``csrc/wgmma_gemm.cuh`` runs one bf16 tile."""
    nw: int           #: the instruction's N (m64nNk16)
    consumers: int    #: consumer warpgroups (each owns a 64 x nw unit)
    rounds: int       #: passes over K, when the tile has more units
    ks: int           #: slab depth: bk, or less when two slabs do not fit
    stages: int       #: shared-memory stages in the ring
    stage_bytes: int
    smem_bytes: int   #: dynamic shared memory one block claims
    threads: int      #: consumers x 128 + one producer warp


def _wgmma_stage(bm: int, bn: int, ks: int,
                 c_tile: bool) -> tuple[int, int]:
    """(bytes of one stage, bytes after the stages) for a bm x bn tile
    staged ks deep, as ``Geom`` in csrc/wgmma_gemm.cuh lays them out: a
    stage holds A in ceil(ks/64) bands of max(bm, 8) rows and B in
    max(bn, 64)/64 bands of max(ks, 16) rows, 128 bytes a row; after the
    stages come the bf16 C tile (``c_tile``), the pad an m64 read of a
    band shorter than 64 rows reaches into, and one C-tile mbarrier."""
    bmp = max(bm, 8)
    a = -(-ks // WGMMA_BOX_COLS) * bmp * 128
    b = max(bn, WGMMA_BOX_COLS) // WGMMA_BOX_COLS * max(ks, 16) * 128
    pad = (64 - bmp) * 128 if bmp < 64 else 0
    c = -(-bm * bn * 2 // 128) * 128 if c_tile else 0
    return a + b, c + pad + 8


def _wgmma_smem(stage_bytes: int, rest: int, stages: int) -> int:
    # the stages with two mbarriers each, then the rest
    return stages * (stage_bytes + 16) + rest


def wgmma_config(tile: TileConfig, *, k_outer: bool = False) -> WgmmaConfig:
    """How the tensor-core route runs the bf16 ``tile``; raises ValueError
    for a tile it does not take.  The slab is the plan's bk deep unless two
    such slabs do not fit in a block's shared memory, then the deepest
    power of two (at least 16) that fits twice.  The stages are as many as
    fit, at most :data:`WGMMA_STAGES`, and for a k-outer pass (one bk
    block) at most its slabs: a deeper ring would hold nothing."""
    bm, bn, bk = tile.bm, tile.bn, tile.bk
    if not (_pow2(bm) and _pow2(bn) and _pow2(bk)):
        raise ValueError(f"tile {tile}: the kernels take power-of-two "
                         f"bm, bn, bk")
    ks = bk
    # C goes through a tile in shared memory where TMA can move its rows
    # (bn >= 8; the launcher also checks C's alignment, and a tile reserved
    # but unused only costs shared memory)
    c_tile = bn >= 8
    while ks > 16 and _wgmma_smem(*_wgmma_stage(bm, bn, ks, c_tile), 2) \
            > MAX_SMEM_BYTES:
        ks //= 2
    stage, rest = _wgmma_stage(bm, bn, ks, c_tile)
    fit = (MAX_SMEM_BYTES - rest) // (stage + 16)
    if fit < 1:
        raise ValueError(
            f"tile {tile}: one {stage}-byte stage exceeds the "
            f"{MAX_SMEM_BYTES} bytes of shared memory a Hopper block may "
            f"claim")
    stages = min(fit, WGMMA_STAGES, bk // ks if k_outer else fit)
    bnp = max(bn, WGMMA_BOX_COLS)
    nw = min(bnp, 256)
    units = -(-max(bm, 8) // 64) * (bnp // nw)
    # two warpgroups of 256 columns would each hold 128 accumulators under
    # ptxas's 168 registers a thread of a two-warpgroup block and spill
    # (1,820 bytes), so N = 256 runs one warpgroup, in rounds
    consumers = 1 if units < 2 or nw == 256 else 2
    return WgmmaConfig(nw, consumers, -(-units // consumers), ks, stages,
                       stage, _wgmma_smem(stage, rest, stages),
                       consumers * 128 + 32)


#: int8 columns (bytes) of one 128-byte-swizzled TMA box (csrc/wgmma_s8.cuh)
S8_BOX_K = 128
#: shared-memory stages an int8 block keeps in flight, at most; below this
#: cap, as many as fit without costing an SM a resident block (see
#: :func:`int8_config`)
S8_STAGES = 8
#: an H100 SM's shared memory, and what the system keeps of it per block
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
#: threads and blocks an H100 SM holds at once
SM_THREADS = 2048
SM_BLOCKS = 32
#: SMs of an H100 SXM
SMS = 132


def _s8_stage(bm: int, bn: int, ks: int, c_tile: bool) -> tuple[int, int]:
    """(bytes of one stage, bytes after the stages) for an int8 bm x bn
    tile staged ks deep, as ``GeomS8`` in csrc/wgmma_s8.cuh lays them out:
    a stage holds ceil(ks/128) bands of A (max(bm, 8) rows) and of B
    transposed (max(bn, 64) rows), 128 bytes a row; after the stages come
    the int32 C tile (``c_tile``) and one C-tile mbarrier."""
    bands = -(-ks // S8_BOX_K)
    stage = bands * (max(bm, 8) + max(bn, WGMMA_BOX_COLS)) * 128
    c = -(-bm * bn * 4 // 128) * 128 if c_tile else 0
    return stage, c + 8


def int8_config(tile: TileConfig, *, k_outer: bool = False) -> WgmmaConfig:
    """How the tensor-core route runs the int8 ``tile`` (csrc/wgmma_s8.cuh);
    raises ValueError for a tile it does not take.  The slab is the plan's
    bk deep unless two such slabs do not fit in a block's shared memory,
    then the deepest power of two (at least 128: a band is 128 k wide
    whatever the depth) that fits twice.  The ring holds as many slabs as
    fit, at most :data:`S8_STAGES`, without leaving room for fewer blocks
    on an SM than two slabs do (at 64x128x128 three, two blocks an SM; at
    128x128x128, whose 64 KB C tile leaves one block an SM anyway, five),
    and for a k-outer pass at most its slabs.  Warpgroups and rounds follow
    :func:`wgmma_config`'s rules."""
    bm, bn, bk = tile.bm, tile.bn, tile.bk
    if not (_pow2(bm) and _pow2(bn) and _pow2(bk)):
        raise ValueError(f"tile {tile}: the kernels take power-of-two "
                         f"bm, bn, bk")
    ks = bk
    # C goes through a tile in shared memory where TMA can move its rows
    # (bn >= 4 int32; the launcher also checks C's alignment)
    c_tile = bn >= 4
    while ks > S8_BOX_K and _wgmma_smem(*_s8_stage(bm, bn, ks, c_tile), 2) \
            > MAX_SMEM_BYTES:
        ks //= 2
    stage, rest = _s8_stage(bm, bn, ks, c_tile)
    fit = (MAX_SMEM_BYTES - rest) // (stage + 16)
    if fit < 1:
        raise ValueError(
            f"tile {tile}: one {stage}-byte stage and the {rest - 8}-byte "
            f"C tile exceed the {MAX_SMEM_BYTES} bytes of shared memory a "
            f"Hopper block may claim")

    def resident(n):
        return SM_SMEM_BYTES // (_wgmma_smem(stage, rest, n)
                                 + BLOCK_RESERVED_SMEM)

    stages = min(fit, 2)
    while stages < min(fit, S8_STAGES) and \
            resident(stages + 1) >= resident(min(fit, 2)):
        stages += 1
    stages = min(stages, S8_STAGES, bk // ks if k_outer else stages)
    bnp = max(bn, WGMMA_BOX_COLS)
    nw = min(bnp, 256)
    units = -(-max(bm, 8) // 64) * (bnp // nw)
    consumers = 1 if units < 2 else 2
    return WgmmaConfig(nw, consumers, -(-units // consumers), ks, stages,
                       stage, _wgmma_smem(stage, rest, stages),
                       consumers * 128 + 32)


def check_tile(tile: TileConfig, dtype, *, k_outer: bool = False):
    """The route's config for ``tile`` (:func:`wgmma_config` for bf16,
    :func:`int8_config` for int8, :func:`launch_config` for f32); raises
    ValueError for a tile the route does not take, on any device."""
    tag = _tag(dtype)
    if tag == "int8":
        return int8_config(tile, k_outer=k_outer)
    if tag == "bf16":
        return wgmma_config(tile, k_outer=k_outer)
    return launch_config(tile, dtype)


def _row_unit(t) -> int:
    """Elements of ``t`` in the 16 bytes TMA aligns rows to."""
    return 16 // t.element_size()


def _tma_row_stride(t) -> int:
    """The row stride a tensor map is given for row-major ``t``: its own,
    or, for a single row (never stepped), its width rounded up to 16
    bytes."""
    unit = _row_unit(t)
    return t.stride(0) if t.shape[0] > 1 else -(-t.shape[1] // unit) * unit


def needs_aligned_copy(t) -> bool:
    """Whether TMA cannot read the row-major matrix ``t`` in place: a base
    that is not 16-byte aligned, or a row stride that is not a multiple of
    16 bytes (8 bf16, 16 int8)."""
    return t.data_ptr() % 16 != 0 or _tma_row_stride(t) % _row_unit(t) != 0


def aligned_copy(t):
    """``t`` copied once into a buffer whose row stride is its width rounded
    up to 16 bytes, returned as the view of ``t``'s logical extent (the
    tensor map is given that extent, so the padding is never read)."""
    rows, cols = t.shape
    unit = _row_unit(t)
    buf = torch.empty((rows, -(-cols // unit) * unit), dtype=t.dtype,
                      device=t.device)
    view = buf[:, :cols]
    view.copy_(t)
    return view


def transposed_copy_plain(b):
    """Plain PyTorch version of :func:`transposed_copy`."""
    k, n = b.shape
    buf = torch.zeros((n, -(-k // 16) * 16), dtype=b.dtype, device=b.device)
    view = buf[:, :k]
    view.copy_(b.t())
    return view


def transposed_copy(b):
    """The int8 (K, N) matrix ``b`` as Bt, its (N, K) transpose, in rows
    padded with zeros to a multiple of 16 bytes (so that TMA can read any
    K), returned as the view of the logical (N, K) extent: the K-major B
    that 8-bit wgmma reads.  On CUDA a kernel (``repro_transpose_s8``)
    writes it; CPU tensors take :func:`transposed_copy_plain`."""
    if _on_cpu(b):
        return transposed_copy_plain(b)
    from repro_torch.kernels import build

    k, n = b.shape
    kp = -(-k // 16) * 16
    lib = build.load("gemm_int8")
    buf = torch.empty((n, kp), dtype=b.dtype, device=b.device)
    with on_device(b):
        err = lib.repro_transpose_s8(b.data_ptr(), buf.data_ptr(), k, n,
                                     b.stride(0), kp, raw_stream(b))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"int8 transpose of a {k}x{n} B failed: {msg} "
                           f"(cuda error {err})")
    return buf[:, :k]


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
        raise ValueError(f"the kernels run on CUDA tensors (CPU tensors run "
                         f"their plain versions), not on {dev!r}")
    return dev == "cpu"


def on_device(t):
    """A context in which ``t``'s CUDA device is current: no switch at all
    when it already is, so that a launch on the current device costs no
    device guard."""
    if t.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def raw_stream(t) -> int:
    """The handle (``cudaStream_t``) of the current stream on ``t``'s
    device, which a launch takes, read without building the Python Stream
    object that ``torch.cuda.current_stream()`` returns (a host cost paid
    on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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


def _core_launches(kname: str, a, b, c_in, c_out, m: int, n: int, k: int,
                   tile, step: int) -> None:
    """The CUDA-core kernel over k in passes of ``step`` (k-inner: one
    pass over [0, k), even when k is 0; k-outer: bk), each one launch that
    adds one to ``LAUNCHES[kname]``; the library, pointers and stream are
    resolved once."""
    from repro_torch.kernels import build

    lib = build.load("gemm_f32")
    launch = lib.repro_gemm_tile
    group = raster_group(m, max(1, min(step, k)), tile.bm, 4)
    pa, pb, pc = (a.data_ptr(), b.data_ptr(),
                  None if c_in is None else c_in.data_ptr())
    po, lda, ldb, ldc = c_out.data_ptr(), a.stride(0), b.stride(0), \
        c_out.stride(0)
    with on_device(c_out):
        stream = raw_stream(c_out)
        for k0 in range(0, max(k, 1), step):
            k1 = min(k0 + step, k)
            err = launch(pa, pb, pc, po, m, n, k0, k1, lda, ldb, ldc,
                         tile.bm, tile.bn, tile.bk, group, stream)
            if err != 0:
                msg = lib.repro_cuda_error_string(err).decode()
                raise RuntimeError(
                    f"gemm kernel launch failed for {m}x{n}x{k} (k "
                    f"{k0}..{k1}) on tile {tile}: {msg} (cuda error {err})")
            LAUNCHES[kname] += 1
            ROUTES["cuda_cores"] += 1


#: per tensor-core dtype: its library, map encoder and launcher
_WGMMA_LIBS = {"bf16": ("gemm_bf16", "repro_gemm_wgmma_encode",
                        "repro_gemm_wgmma"),
               "int8": ("gemm_int8", "repro_gemm_s8_encode",
                        "repro_gemm_s8")}


def _wgmma_lib(dtype):
    """(library, map encoder, launcher) of the tensor-core route for
    ``dtype``."""
    from repro_torch.kernels import build

    name, encode, launch = _WGMMA_LIBS[_tag(dtype)]
    lib = build.load(name)
    return lib, getattr(lib, encode), getattr(lib, launch)


def _wgmma_maps(lib, encode, a, b, c, m: int, n: int, k: int, tile, cfg):
    """The tensor maps of A, B and C (384 bytes) of one wrapper call, after
    copying an operand TMA cannot read in place (int8: B always, into its
    transpose); returns (maps, the operands used), which the caller keeps
    alive until its launches are enqueued."""
    import ctypes

    if needs_aligned_copy(a):
        a = aligned_copy(a)
        COPIES["aligned"] += 1
    if a.dtype == torch.int8:
        b = transposed_copy(b)
        COPIES["transposed"] += 1
    elif needs_aligned_copy(b):
        b = aligned_copy(b)
        COPIES["aligned"] += 1
    maps = ctypes.create_string_buffer(384)
    err = encode(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                 _tma_row_stride(a), _tma_row_stride(b), c.stride(0),
                 tile.bm, tile.bn, cfg.ks, maps)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"tensor maps for {m}x{n}x{k} on tile {tile}: "
                           f"{msg} (error {err})")
    return maps, (a, b)


#: L2 bytes a group of m tiles may claim for the A rows it shares
RASTER_L2_BYTES = 16 << 20


def raster_group(m: int, k: int, bm: int, elem_bytes: int = 2) -> int:
    """How many m tiles the blocks of one launch walk before the next n
    tile: as many as keep the A rows they share (``bm`` x ``k`` elements of
    ``elem_bytes`` each, bf16 unless said otherwise, ``k`` the depth one
    launch reads) within :data:`RASTER_L2_BYTES` of L2, at least 1, at most
    all of them."""
    return max(1, min(-(-m // bm),
                      RASTER_L2_BYTES // (bm * k * elem_bytes)))


def _launch_wgmma(lib, launch, maps, c_in, c_out, m: int, n: int, k: int,
                  k0: int, k1: int, tile, cfg, group: int) -> None:
    with on_device(c_out):
        stream = raw_stream(c_out)
        err = launch(maps, None if c_in is None else c_in.data_ptr(),
                     c_out.data_ptr(), m, n, k, c_out.stride(0), k0, k1,
                     tile.bm, tile.bn, cfg.ks, cfg.stages, group, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"wgmma gemm launch failed for {m}x{n}x{k} "
                           f"(k {k0}..{k1}) on tile {tile}: {msg} (cuda "
                           f"error {err})")
    ROUTES["wgmma"] += 1


def gemm_k_inner(a, b, *, tile: TileConfig):
    """C = A @ B, output-stationary (B3A2C0 analogue)."""
    m, n, k = _check_operands(a, b)
    cfg = check_tile(tile, a.dtype)
    if _on_cpu(a, b):
        return gemm_k_inner_plain(a, b)
    _check_cuda(a, b)
    out = torch.empty((m, n), dtype=out_dtype(a.dtype), device=a.device)
    if route(a.dtype) == "cuda_cores":
        if out.numel():
            _core_launches("gemm_k_inner", a, b, None, out, m, n, k, tile,
                           max(k, 1))
        return out
    if out.numel() and k == 0:
        out.zero_()
        return out
    elif out.numel():
        lib, encode, launch = _wgmma_lib(a.dtype)
        maps, _keep = _wgmma_maps(lib, encode, a, b, out, m, n, k, tile, cfg)
        _launch_wgmma(lib, launch, maps, None, out, m, n, k, 0, k, tile, cfg,
                      raster_group(m, k, tile.bm, a.element_size()))
    else:
        return out
    LAUNCHES["gemm_k_inner"] += 1
    return out


def gemm_k_outer(a, b, c, *, tile: TileConfig):
    """C + A @ B with C streamed once per k block (C3B2A0/B3C2A0 analogue);
    C is rounded to its dtype after every pass."""
    m, n, k = _check_operands(a, b)
    cfg = check_tile(tile, a.dtype, k_outer=True)
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
    if route(a.dtype) == "cuda_cores":
        if out.numel() and k:
            _core_launches("gemm_k_outer", a, b, out, out, m, n, k, tile, bk)
        return out
    if not (out.numel() and k):
        return out
    lib, encode, launch = _wgmma_lib(a.dtype)
    maps, _keep = _wgmma_maps(lib, encode, a, b, out, m, n, k, tile, cfg)
    group = raster_group(m, min(bk, k), tile.bm, a.element_size())
    for k0 in range(0, k, bk):
        _launch_wgmma(lib, launch, maps, out, out, m, n, k, k0,
                      min(k0 + bk, k), tile, cfg, group)
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
