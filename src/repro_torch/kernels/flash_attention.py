"""Flash attention forward as a hand-written CUDA kernel.

``flash_attention_fwd(q, k, v)`` computes causal (or full) softmax
attention over q ``(B, S, H, D)`` and k, v ``(B, Skv, H, D)`` in one launch
of ``csrc/flash_attention.cu``; it replaces
``repro.kernels.flash_attention.flash_attention_fwd``
(src/repro/kernels/flash_attention.py:68).  The scores are scaled by
``D**-0.5``, the causal mask is top-left aligned (key j visible to query i
when j <= i) and filled with -1e30, the softmax runs online in f32 and the
output is cast to q's dtype.  bf16 and f32 are taken, at any head dim up
to :data:`MAX_HEAD_DIM`: each kernel is compiled for a few widths (bf16
:data:`HEAD_DIMS`, f32 :data:`F32_HEAD_DIMS`) and a head dim runs on the
smallest that holds it (:func:`compiled_width`, :func:`f32_width`), loads
past it reading zero and stores past it skipped; a wider head dim raises.
There is no GQA: callers repeat the KV heads, as for the JAX kernel.

Bound on an H100: bytes at the served prefill (S = 32), operations from a
few hundred positions on.  Both kernels keep the scores out of device
memory and stop the key loop at the diagonal when causal.  Two routes, by
dtype (:func:`route`); neither dtype ever takes the other's:

* ``"wgmma"``: bf16 runs on the tensor cores, ``wgmma`` fed by TMA (the CUDA
  source gives the design): 64 query rows per consumer warpgroup, q.k^T
  and p.v by wgmma, the scale on the f32 scores, p rounded to bf16 for
  p.v.
  :func:`wgmma_config` owns its tile, ring and shared memory per width.
  q, k and v are read in place through rank-4 tensor maps over their
  (B, S, H, D) strides; each map is encoded once and kept under the values
  it is a function of (:func:`map_key`).  An operand TMA cannot read (a
  stride that is not a multiple of 8 elements, e.g. d = 100 contiguous, or
  a base off 16 bytes) is first copied once to aligned rows
  (:func:`aligned_copy`, counted in ``COPIES``).  B * H times the query
  tiles is limited by the grid (:func:`_check_wgmma_grid`).
* ``"cuda_cores"``: f32 runs the FP32 kernel (TF32 would not compute the
  f32 function at 1e-5): q scaled in f32 before the product; each step of
  :data:`BLOCK_K` keys is two register-tiled products on the CUDA cores
  (q.k^T, then p.v), fed by a cp.async ring that streams K and V in pieces
  (the CUDA source gives the design).  :func:`f32_config` owns its tile,
  ring and shared memory per width; a block is :data:`BLOCK_Q` query rows,
  or half that where the grid would give fewer than two blocks an SM
  (:func:`f32_rows`).  q, k and v are read through their strides;
  ceil(S / :data:`BLOCK_Q`) * B * H is limited by the grid
  (:func:`_check_grid`).

``block_q`` and ``block_k`` only decide which calls are accepted: as the
JAX kernel asserts, ``S % min(block_q, S)`` and ``Skv % min(block_k, Skv)``
must be 0, else ValueError, on any device.  The kernels' own tiles mask
ragged edges themselves.  A call signature's checks and configuration are
worked out once (:func:`plan`).

``flash_attention_plain`` beside it is the same function in plain PyTorch
(``ref.flash_attention_ref``, which holds the S x Skv scores).  The wrapper
runs it only when its operands lie on the CPU; CUDA operands launch the
kernel of their route or raise.  ``LAUNCHES["flash_attention"]`` counts
kernel launches, one per call, and nothing else; ``ROUTES`` counts the same
launches by route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gemm import BLOCK_RESERVED_SMEM, MAX_SMEM_BYTES, \
    SM_SMEM_BYTES, SM_THREADS, _on_cpu, on_device, raw_stream
from repro_torch.kernels.grouped_gemm import SMS

#: kernel launches since the last reset
LAUNCHES = {"flash_attention": 0}
#: the same launches by route: tensor cores (bf16) or CUDA cores (f32)
ROUTES = {"wgmma": 0, "cuda_cores": 0}
#: operands copied into a TMA-aligned buffer before a wgmma launch
COPIES = {"aligned": 0}
_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: head-dim widths the bf16 (wgmma) kernel is compiled for
HEAD_DIMS = (64, 128, 256)
#: head-dim widths the f32 (CUDA-core) kernel is compiled for: stablelm-12b's
#: 160 and xlstm-125m's 192 run on widths of their own, not on 256
F32_HEAD_DIMS = (64, 128, 160, 192, 256)
#: the widest head dim taken
MAX_HEAD_DIM = HEAD_DIMS[-1]
#: the CUDA-core (f32) kernel (``flash_fwd`` in the CUDA source, whose
#: constants these mirror): query rows per block (32 on small grids, see
#: f32_rows) and keys per step; 128 threads, a 16 x 8 grid, each owning
#: F32_ROWS (or half) query rows x F32_KEYS keys of the scores; K streams
#: in pieces of F32_K_SLAB head-dim columns through F32_STAGES slots; the
#: p tile's rows are BLOCK_K + F32_P_PAD floats, q's and K's rows
#: F32_ROW_PAD past their width; the launch bounds ask for two blocks an SM
BLOCK_Q = 64
BLOCK_K = 64
F32_THREADS = 128
F32_TX = 8
F32_ROWS = BLOCK_Q * F32_TX // F32_THREADS
F32_KEYS = BLOCK_K // F32_TX
F32_K_SLAB = 32
F32_STAGES = 3
F32_ROW_PAD = 4
F32_P_PAD = 8
F32_MIN_BLOCKS = 2
#: the wgmma (bf16) kernel by compiled width: keys per step, consumer
#: warpgroups (64 query rows each; a block's rows), and the K/V ring's
#: depth.  A consumer holds its 64 x BK scores, their bf16 copy and its
#: 64 x D accumulator in registers: two consumers and a producer
#: warpgroup leave each thread 168, which D = 128 fits at 64 keys a step
#: (at 128 it spilled) and the 256-wide accumulator (128 alone) does not,
#: so that width runs one consumer (255 a thread).  Three slots: a slot is
#: released one step late, after its p.v (four measured no faster).
WGMMA_BLOCK_K = {64: 128, 128: 64, 256: 64}
WGMMA_CONSUMERS = {64: 2, 128: 2, 256: 1}
WGMMA_STAGES = 3


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTES, COPIES):
        for name in counts:
            counts[name] = 0


def _tag(dtype) -> str:
    try:
        return _TAGS[dtype]
    except KeyError:
        raise ValueError(f"the flash attention kernel takes bf16 or f32, "
                         f"not {dtype}") from None


def route(dtype) -> str:
    """``"wgmma"`` for bf16 operands, ``"cuda_cores"`` for f32."""
    return "wgmma" if _tag(dtype) == "bf16" else "cuda_cores"


def _smallest_width(d: int, widths: tuple) -> int:
    for width in widths:
        if 0 < d <= width:
            return width
    raise ValueError(f"the flash attention kernel takes head dims from 1 "
                     f"to {MAX_HEAD_DIM}, not {d}")


def compiled_width(d: int) -> int:
    """The compiled head-dim width that runs head dim ``d`` on the bf16
    route: the smallest of :data:`HEAD_DIMS` that holds it.  Raises
    ValueError past :data:`MAX_HEAD_DIM`."""
    return _smallest_width(d, HEAD_DIMS)


def f32_width(d: int) -> int:
    """The compiled width that runs head dim ``d`` on the f32 route: the
    smallest of :data:`F32_HEAD_DIMS` that holds it.  Raises ValueError past
    :data:`MAX_HEAD_DIM`."""
    return _smallest_width(d, F32_HEAD_DIMS)


def f32_rows(b: int, s: int, h: int) -> int:
    """Query rows one block of the f32 kernel takes for a (b, s, h) query:
    :data:`BLOCK_Q`, or half that where BLOCK_Q-row tiles would give fewer
    than two blocks an SM (few heads at a few thousand positions: a causal
    call's tiles differ in length, and with few of them the longest leave
    SMs idle).  ``f32_rows`` in the CUDA source."""
    return BLOCK_Q // 2 if -(-s // BLOCK_Q) * b * h < 2 * SMS else BLOCK_Q


class F32Config(NamedTuple):
    """How ``flash_fwd`` in the CUDA source runs one head-dim width."""
    width: int        #: compiled head-dim width
    block_q: int      #: query rows per block (16 x rows)
    block_k: int      #: keys per step
    threads: int      #: a 16 x 8 grid
    rows: int         #: query rows per thread (its register tile's rows)
    keys: int         #: keys per thread (the score tile's columns)
    columns: int      #: output columns per thread, in 4-wide fragments
    k_slab: int       #: head-dim columns of one K piece
    v_slab: int       #: keys of one V piece
    stages: int       #: slots in the cp.async ring
    q_bytes: int      #: the scaled q tile, rows of width + 4 floats
    p_bytes: int      #: the p tile, rows of block_k + 8 floats
    slot_bytes: int   #: one slot: block_k keys x (k_slab + 4) floats
    smem_bytes: int   #: dynamic shared memory one block claims
    blocks_per_sm: int  #: resident blocks by shared memory and threads


def f32_config(d: int, block_q: int = BLOCK_Q) -> F32Config:
    """The f32 route's configuration at head dim ``d`` (run on
    :func:`f32_width`'s width) with ``block_q`` query rows a block (64, or
    32: :func:`f32_rows`), as ``F32Tile`` in the CUDA source lays it out:
    the scaled q tile, the p tile, then :data:`F32_STAGES` slots, each a
    piece of K (:data:`BLOCK_K` keys x :data:`F32_K_SLAB` columns) or of V
    (``v_slab`` keys x the width: the largest power of two of keys whose
    piece fits a slot).  Raises ValueError for a head dim or a block the
    kernel does not take."""
    w = f32_width(d)
    if block_q not in (BLOCK_Q, BLOCK_Q // 2):
        raise ValueError(f"the f32 kernel runs blocks of {BLOCK_Q} or "
                         f"{BLOCK_Q // 2} query rows, not {block_q}")
    slot = BLOCK_K * (F32_K_SLAB + F32_ROW_PAD)
    v_slab = 1 << ((slot // w).bit_length() - 1)
    q_bytes = 4 * block_q * (w + F32_ROW_PAD)
    p_bytes = 4 * block_q * (BLOCK_K + F32_P_PAD)
    smem = q_bytes + p_bytes + F32_STAGES * 4 * slot
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"head dim {d}: {smem} bytes of shared memory "
                         f"exceed the {MAX_SMEM_BYTES} a Hopper block may "
                         f"claim")
    resident = min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM),
                   SM_THREADS // F32_THREADS)
    return F32Config(w, block_q, BLOCK_K, F32_THREADS,
                     block_q * F32_TX // F32_THREADS, F32_KEYS, w // F32_TX,
                     F32_K_SLAB, v_slab, F32_STAGES, q_bytes, p_bytes,
                     4 * slot, smem, resident)


def smem_bytes(d: int) -> int:
    """Dynamic shared memory one 64-row block of the CUDA-core (f32)
    kernel claims at head dim ``d`` (:func:`f32_config`'s).  The wgmma
    route's is :func:`wgmma_config`'s."""
    return f32_config(d).smem_bytes


class WgmmaConfig(NamedTuple):
    """How ``flash_wgmma`` in the CUDA source runs one head-dim width."""
    width: int        #: compiled head-dim width (the p.v instruction's N)
    block_q: int      #: query rows per block, 64 per consumer warpgroup
    block_k: int      #: keys per step (the q.k instruction's N)
    consumers: int    #: consumer warpgroups
    stages: int       #: K/V slots in the ring
    q_bytes: int      #: the q tile
    stage_bytes: int  #: one K and one V tile
    smem_bytes: int   #: dynamic shared memory one block claims
    threads: int      #: the consumer warpgroups and a producer warpgroup


def wgmma_config(d: int) -> WgmmaConfig:
    """The bf16 route's configuration at head dim ``d`` (run on
    :func:`compiled_width`'s width): the q tile, then
    :data:`WGMMA_STAGES` slots of K and V, all bf16 in boxes of 64 columns, then one mbarrier
    for q and two per slot, as ``FlashGeom`` in the CUDA source lays them
    out.  Raises ValueError for a head dim the kernels do not take."""
    w = compiled_width(d)
    bk, nc = WGMMA_BLOCK_K[w], WGMMA_CONSUMERS[w]
    q_bytes = w * 64 * nc * 2
    stage = 2 * w * bk * 2
    stages = WGMMA_STAGES
    smem = q_bytes + stages * stage + 8 * (1 + 2 * stages)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"head dim {d}: {smem} bytes of shared memory "
                         f"exceed the {MAX_SMEM_BYTES} a Hopper block may "
                         f"claim")
    return WgmmaConfig(w, 64 * nc, bk, nc, stages, q_bytes, stage, smem,
                       (nc + 1) * 128)


def _check_grid(b: int, s: int, h: int, skv: int) -> None:
    """The CUDA-core launch grid is one dimension of ceil(S/BLOCK_Q) * B *
    H blocks (at most 2**31 - 1; twice the tiles only where that stays
    under two an SM, see :func:`f32_rows`)."""
    if -(-s // BLOCK_Q) * b * h >= 2 ** 31 or s >= 2 ** 31 \
            or skv >= 2 ** 31:
        raise ValueError(f"B * H = {b * h}, S = {s}, Skv = {skv}: the grid "
                         f"takes ceil(S / {BLOCK_Q}) * B * H < 2**31")


def _check_wgmma_grid(b: int, s: int, h: int, skv: int,
                      block_q: int) -> None:
    """The wgmma launch grid is one dimension of ceil(S/block_q) * B * H
    blocks (at most 2**31 - 1); positions are int32 TMA coordinates."""
    if -(-s // block_q) * b * h >= 2 ** 31 or s >= 2 ** 31 \
            or skv >= 2 ** 31:
        raise ValueError(f"B * H = {b * h}, S = {s}, Skv = {skv}: the grid "
                         f"takes ceil(S / {block_q}) * B * H < 2**31")


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
    _tag(q.dtype)
    s, skv = q.shape[1], k.shape[1]
    bq, bk = min(block_q, s), min(block_k, skv)
    if bq <= 0 or bk <= 0 or s % bq or skv % bk:
        raise ValueError(f"S = {s} and Skv = {skv} must be multiples of "
                         f"min(block_q, S) = {bq} and min(block_k, Skv) = "
                         f"{bk}")


class Plan(NamedTuple):
    """What one call signature (shapes, dtype, blocks) needs: checked and
    configured once, since both follow from the signature alone."""
    b: int
    s: int
    skv: int
    h: int
    d: int
    route: str
    cfg: WgmmaConfig | None   #: the wgmma route's (None on the CUDA cores)


#: plans by (q's and k's shapes, the dtype, block_q, block_k); dropped past
#: :data:`MAX_PLANS`
_PLANS: dict[tuple, Plan] = {}
MAX_PLANS = 256


def plan(q, k, v, block_q: int = 128, block_k: int = 128) -> Plan:
    """The :class:`Plan` of ``flash_attention_fwd(q, k, v, block_q=block_q,
    block_k=block_k)``; raises ValueError for operands the kernels do not
    take (on any device, as the JAX kernel's asserts do)."""
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, block_q,
           block_k)
    p = _PLANS.get(key)
    if p is None:
        _check(q, k, v, block_q, block_k)
        b, s, h, d = q.shape
        skv = k.shape[1]
        rt = route(q.dtype)
        if rt == "wgmma":
            cfg = wgmma_config(d)
            _check_wgmma_grid(b, s, h, skv, cfg.block_q)
            p = Plan(b, s, skv, h, d, rt, cfg)
        else:
            f32_width(d)
            _check_grid(b, s, h, skv)
            p = Plan(b, s, skv, h, d, rt, None)
        if len(_PLANS) >= MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = p
    return p


def _tma_strides(t) -> tuple[int, int, int]:
    """The (sequence, head, batch) strides a tensor map is given for the
    (B, S, H, D) operand ``t``: its own, except that a dimension of size 1
    (never stepped, so its stride is arbitrary) takes the span of the
    others rounded up to 8, as a contiguous tensor's would be."""
    span = max(t.stride(i) * t.shape[i] for i in range(4))
    return tuple(t.stride(i) if t.shape[i] > 1 else max(8, -(-span // 8) * 8)
                 for i in (1, 2, 0))


def needs_aligned_copy(t) -> bool:
    """Whether TMA cannot read the (B, S, H, D) bf16 operand ``t`` in place:
    a base that is not 16-byte aligned, or a sequence, head or batch stride
    that is not a multiple of 16 bytes (8 elements)."""
    return t.data_ptr() % 16 != 0 or any(st % 8 for st in _tma_strides(t))


def aligned_copy(t):
    """``t`` copied once into a contiguous (B, S, H, D8) buffer, D8 the head
    dim rounded up to 8, returned as the view of ``t``'s extent (the tensor
    map is given d columns, so the padding is never read)."""
    b, s, h, d = t.shape
    buf = torch.empty((b, s, h, -(-d // 8) * 8), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :d]
    view.copy_(t)
    return view


def map_key(ptr: int, shape: tuple, strides: tuple, box_rows: int) -> tuple:
    """What the rank-4 tensor map of one (B, S, H, D) operand is a pure
    function of: its base address, its shape and strides (in elements) and
    its box's rows.  A map kept under this key is right for any tensor with
    these values, whatever memory it reuses; only operands TMA reads in
    place are kept, so a hit also says no aligned copy is needed."""
    return (ptr, *shape, *strides, box_rows)


#: encoded tensor maps (128 bytes each) by :func:`map_key`; the oldest go
#: first past :data:`MAX_MAPS`
_MAPS: dict[tuple, ctypes.Array] = {}
MAX_MAPS = 1024


def _tensor_map(lib, t, box_rows: int):
    """``(the tensor map of t in boxes of box_rows positions, the operand
    it reads)``: t itself, or its aligned copy (counted in ``COPIES``)."""
    key = map_key(t.data_ptr(), t.shape, t.stride(), box_rows)
    m = _MAPS.get(key)
    if m is not None:
        return m, t
    if needs_aligned_copy(t):
        t = aligned_copy(t)
        COPIES["aligned"] += 1
        key = map_key(t.data_ptr(), t.shape, t.stride(), box_rows)
    b, rows, h, d = t.shape
    m = ctypes.create_string_buffer(128)
    err = lib.repro_flash_encode(m, key[0], d, rows, h, b, *_tma_strides(t),
                                 box_rows)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"tensor map of a {tuple(t.shape)} operand with "
                           f"strides {t.stride()}: {msg} (error {err})")
    if len(_MAPS) >= MAX_MAPS:
        del _MAPS[next(iter(_MAPS))]
    _MAPS[key] = m
    return m, t


def _launch_wgmma(q, k, v, o, p: Plan, causal: bool) -> None:
    from repro_torch.kernels import build

    lib = build.load("flash_attention_bf16")
    cfg = p.cfg
    # the operands read (aligned copies among them) live until the launch
    # is enqueued
    mq, q = _tensor_map(lib, q, cfg.block_q)
    mk, k = _tensor_map(lib, k, cfg.block_k)
    mv, v = _tensor_map(lib, v, cfg.block_k)
    with on_device(o):
        err = lib.repro_flash_attention_wgmma(
            mq, mk, mv, o.data_ptr(), p.b, p.s, p.skv, p.h, p.d, cfg.width,
            cfg.block_k, cfg.consumers, cfg.stages, int(causal),
            raw_stream(o))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash attention wgmma launch failed for q "
                           f"{tuple(q.shape)}, kv {tuple(k.shape)}: {msg} "
                           f"(cuda error {err})")


def _launch(q, k, v, o, p: Plan, causal: bool) -> None:
    """One launch of the route's kernel."""
    if p.route == "wgmma":
        _launch_wgmma(q, k, v, o, p, causal)
        return
    from repro_torch.kernels import build

    lib = build.load("flash_attention_f32")
    strides = [st for t in (q, k, v) for st in (t.stride(0), t.stride(1),
                                                t.stride(2))]
    with on_device(q):
        stream = raw_stream(q)
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), p.b, p.s,
            p.skv, p.h, p.d, *strides, int(causal), stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed for q "
                           f"{tuple(q.shape)}, kv {tuple(k.shape)}: {msg} "
                           f"(cuda error {err})")


def flash_attention_fwd(q, k, v, *, causal: bool = True, block_q: int = 128,
                        block_k: int = 128):
    """q: (B, S, H, D), k, v: (B, Skv, H, D) -> (B, S, H, D) in q's dtype."""
    if _on_cpu(q, k, v):
        _check(q, k, v, block_q, block_k)
        return flash_attention_plain(q, k, v, causal=causal)
    p = plan(q, k, v, block_q, block_k)
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the flash attention kernel takes a unit stride on "
                         "the head dim")
    if not q.device == k.device == v.device:
        raise ValueError("operands on different CUDA devices")
    o = torch.empty((p.b, p.s, p.h, p.d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    _launch(q, k, v, o, p, causal)
    LAUNCHES["flash_attention"] += 1
    ROUTES[p.route] += 1
    return o
