"""Mesh-aware sharding on ``torch.distributed``: the ambient mesh, spec
trees -> per-leaf placements, batch specs, per-arch parallelism defaults,
and the collectives the sharded forward issues.

The counterpart of ``repro.runtime.sharding``.  The JAX package hands spec
trees to XLA's SPMD partitioner, which inserts the collectives.  The port
runs the Megatron idiom instead: every rank holds its local shard, as its
spec says; the model code calls the collective itself wherever the
partitioner would insert one; the GEMM and grouped kernels run unchanged on
the local shards.  Each collective that has a backward is an autograd
Function, in conjugate pairs:

* :func:`all_reduce` (sum forward, identity backward) ends a region whose
  ranks each hold a partial sum that every rank then consumes alike
  (a row-parallel product, a masked vocab lookup);
* :func:`copy_to` (identity forward, sum backward) starts a region whose
  ranks each consume part of a replicated tensor, so that its gradient
  arrives partial on every rank (the input of a column-parallel product);
* :func:`all_gather` (gather forward, reduce-scatter backward) rebuilds an
  FSDP-sharded weight before use: each data rank's gradient is its own
  batch's, summed by the scatter;
* :func:`gather_from` (gather forward, slice backward) and
  :func:`scatter_to` (slice forward, gather backward) move a tensor
  between split and replicated where every rank consumes the replicated
  one alike (expert parallelism's sequence split);
* :func:`all_to_all` is its own reverse.

Without an ambient mesh (``use_mesh``) or with an axis the spec leaves
unsharded (``None``) every wrapper returns its input unchanged and issues
nothing, so the one-device forward is the one the port had before meshes
came, bit for bit.  With a mesh, a collective over a size-1 axis is still
issued (the identity), so a one-card mesh drives the same code as a fleet.

:data:`COLLECTIVES` counts each wrapper's calls and bytes by op and axis,
as ``kernels.gemm.LAUNCHES`` counts launches.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models.common import MeshInfo, tree_map, tree_zip

#: the ambient mesh, per thread and context.  Autograd runs a backward on
#: a thread of its own on the card, where none is installed: a Function
#: keeps its forward's :class:`Comm` for its backward, and a checkpointed
#: block, whose recompute issues the forward's collectives again, installs
#: the mesh it captured in the forward (``LM._run_stack``)
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)

#: (op, axis) -> {"calls", "bytes"}: every collective the wrappers issued
#: since the last :func:`reset_collective_counts`; ``bytes`` is the payload
#: this rank handed in (an all-gather's local shard, a reduce-scatter's
#: full tensor, a send's buffer).  Backward collectives count as the op
#: they issue.
COLLECTIVES: dict = {}


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def collective_counts() -> dict:
    """:data:`COLLECTIVES` keyed ``"op over axis"``, for JSON."""
    return {f"{op} over {ax}": dict(v)
            for (op, ax), v in sorted(COLLECTIVES.items())}


def count_collective(op: str, names: tuple, t: torch.Tensor) -> None:
    """Add one call of ``op`` over the axes ``names``, ``t``'s bytes."""
    rec = COLLECTIVES.setdefault((op, "+".join(names)),
                                 {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh`` whose dims are named ``data``,
    ``model`` and optionally ``pod``; None for none) as the ambient mesh
    for the block, in this thread's context."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def ambient_mesh():
    """The mesh currently installed by :func:`use_mesh`, or None."""
    return _MESH.get()


def mesh_info(mesh, fsdp: bool = False) -> MeshInfo:
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    data = 1
    for a in data_axes:
        data *= sizes[a]
    return MeshInfo(data=data, model=sizes.get("model", 1),
                    data_axes=data_axes or ("data",), model_axis="model",
                    fsdp=fsdp)


def axis_names(ax) -> tuple:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _present(ax) -> tuple:
    """The names of ``ax`` on the ambient mesh (none without one)."""
    mesh = ambient_mesh()
    if mesh is None:
        return ()
    names = axis_names(ax)
    missing = [n for n in names if n not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"axes {missing} are not on the ambient mesh "
                         f"{mesh.mesh_dim_names}")
    return names


def axis_size(ax) -> int:
    """How many shards ``ax`` cuts a dim into: 1 without an ambient mesh."""
    mesh = ambient_mesh()
    return math.prod(mesh.size(mesh.mesh_dim_names.index(n))
                     for n in _present(ax))


def axis_index(ax) -> int:
    """This rank's shard along ``ax`` (row-major over a tuple of axes, as
    JAX numbers them): 0 without an ambient mesh."""
    mesh = ambient_mesh()
    idx = 0
    for n in _present(ax):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(n)) \
            + mesh.get_local_rank(n)
    return idx


def group(ax):
    """The process group over the named axes of the ambient mesh (a tuple
    of axes is flattened once, in the mesh's order, and kept on the
    mesh)."""
    mesh = ambient_mesh()
    names = _present(ax)
    if len(names) == 1:
        return mesh.get_group(names[0])
    order = tuple(n for n in mesh.mesh_dim_names if n in names)
    cache = mesh.__dict__.setdefault("_repro_torch_groups", {})
    if order not in cache:
        cache[order] = mesh[order]._flatten().get_group()
    return cache[order]


def communicates(ax) -> bool:
    """Whether a wrapper over ``ax`` issues a collective: an ambient mesh
    and an axis (a size-1 axis included)."""
    return bool(_present(ax))


# ---------------------------------------------------------------------------
# Raw collectives (counted, no autograd)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Comm:
    """The axes a collective runs over, resolved on the ambient mesh: a
    Function keeps it from its forward for its backward, which may run
    after the ``use_mesh`` block has closed."""
    names: tuple
    group: object
    size: int
    index: int


def comm(ax) -> Comm | None:
    """``ax`` resolved on the ambient mesh, None when nothing is issued
    (no mesh, or no axis)."""
    names = _present(ax)
    if not names:
        return None
    return Comm(names, group(names), axis_size(names), axis_index(names))


def _all_reduce(t: torch.Tensor, c: Comm, op: str = "sum") -> torch.Tensor:
    count_collective("all_reduce", c.names, t)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=c.group)
    return t


def all_reduce_(t: torch.Tensor, ax, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``ax`` (``op``: sum, max); ``t``
    as it is when nothing is issued."""
    c = comm(ax)
    return t if c is None else _all_reduce(t, c, op)


def _gather(t: torch.Tensor, c: Comm, dim: int) -> torch.Tensor:
    count_collective("all_gather", c.names, t)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(c.size)]
    dist.all_gather(parts, t, group=c.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: torch.Tensor, c: Comm, dim: int) -> torch.Tensor:
    count_collective("reduce_scatter", c.names, t)
    parts = [p.contiguous() for p in t.chunk(c.size, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=c.group)
    return out


def _slice(t: torch.Tensor, c: Comm, dim: int) -> torch.Tensor:
    return t.chunk(c.size, dim=dim)[c.index].contiguous()


def _all_to_all(t: torch.Tensor, c: Comm) -> torch.Tensor:
    count_collective("all_to_all", c.names, t)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=c.group)
    return out


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        return _all_reduce(x.clone(), c)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.c), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, dim):
        ctx.c, ctx.dim = c, dim
        return _gather(x, c, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.c, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, dim):
        ctx.c, ctx.dim = c, dim
        return _gather(x, c, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.c, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, dim):
        ctx.c, ctx.dim = c, dim
        return _slice(x, c, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.c, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return _all_to_all(x, c)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.c), None


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        return _all_reduce(x.clone(), c) / c.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def _apply(fn, x, ax, *args):
    c = comm(ax)
    return x if c is None else fn.apply(x, c, *args)


def all_reduce(x, ax):
    """Sum over ``ax``; the backward passes the gradient through."""
    return _apply(_AllReduce, x, ax)


def copy_to(x, ax):
    """Identity; the backward sums the gradient over ``ax``."""
    return _apply(_CopyTo, x, ax)


def all_gather(x, ax, dim: int):
    """Concatenate the shards of ``ax`` along ``dim``; the backward
    reduce-scatters the gradient (FSDP)."""
    return _apply(_AllGather, x, ax, dim)


def gather_from(x, ax, dim: int):
    """Concatenate the shards of ``ax`` along ``dim`` into a tensor every
    rank consumes alike; the backward keeps this rank's slice."""
    return _apply(_GatherFrom, x, ax, dim)


def scatter_to(x, ax, dim: int):
    """This rank's slice of ``x`` along ``dim``; the backward gathers the
    slices' gradients."""
    return _apply(_ScatterTo, x, ax, dim)


def all_to_all(x, ax):
    """Chunk ``i`` of dim 0 goes to rank ``i`` of ``ax``; chunk ``j`` of
    the result came from rank ``j``.  The backward is the same exchange."""
    return _apply(_AllToAll, x, ax)


def data_mean(x, ax):
    """Mean over the data axes ``ax``; the backward passes the gradient
    through, because the train step averages every data rank's gradient
    afterwards (a mean whose backward also divided would count it twice)."""
    return _apply(_DataMean, x, ax)


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------


def is_spec(x) -> bool:
    return isinstance(x, tuple)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names, in order."""
    return tuple(n for ax in spec for n in axis_names(ax))


def shardings_for(mesh, spec_tree):
    """Spec tree -> a tree of per-leaf DTensor placements over ``mesh``
    (same structure): per mesh dim, ``Shard(i)`` where the spec names that
    axis at tensor dim ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    def one(spec):
        where = {n: i for i, ax in enumerate(spec) for n in axis_names(ax)}
        return tuple(Shard(where[n]) if n in where else Replicate()
                     for n in mesh.mesh_dim_names)
    return tree_map(one, spec_tree, is_leaf=is_spec)


def shard_tensor(x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``spec`` on the
    ambient mesh (a contiguous copy; ``x`` itself without a mesh)."""
    if ambient_mesh() is None:
        return x
    out = x
    for dim, ax in enumerate(spec):
        if ax is not None:
            out = out.chunk(axis_size(ax), dim=dim)[axis_index(ax)]
    return torch.empty_like(out, memory_format=torch.contiguous_format
                            ).copy_(out)


def gather_tensor(x: torch.Tensor, spec) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the full tensor on every rank
    (no autograd)."""
    for dim, ax in reversed(list(enumerate(spec))):
        c = comm(ax)
        if c is not None:
            x = _gather(x, c, dim)
    return x


def shard_tree(tree, specs):
    return tree_zip(shard_tensor, tree, specs)


def gather_tree(tree, specs):
    return tree_zip(gather_tensor, tree, specs)


def gather_fsdp(tree, specs, data_axes):
    """Every leaf that ``specs`` shards over the data axes, all-gathered
    along that dim (differentiable: the gradient is reduce-scattered);
    other leaves as they are.  A no-op without an ambient mesh."""
    if ambient_mesh() is None:
        return tree
    dp = set(data_axes)

    def one(x, spec):
        for dim, ax in enumerate(spec):
            if ax is not None and set(axis_names(ax)) <= dp:
                return all_gather(x, ax, dim)
        return x
    return tree_zip(one, tree, specs)


# ---------------------------------------------------------------------------
# Batch specs and defaults
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, minfo: MeshInfo):
    """Specs for the input batch of one cell.

    The batch dim shards over the DP axes when divisible; ``long_500k``'s
    batch of 1 replicates (its parallelism lives in the seq-sharded KV
    cache instead — SP)."""
    dp = minfo.dp() if shape.global_batch % minfo.data == 0 else None
    if shape.kind == "train":
        if cfg.frontend == "audio_stub":
            return {"frames": (dp, None, None), "labels": (dp, None)}
        if cfg.frontend == "vision_stub":
            return {"patches": (dp, None, None), "tokens": (dp, None),
                    "labels": (dp, None)}
        return {"tokens": (dp, None), "labels": (dp, None)}
    if shape.kind == "prefill":
        if cfg.frontend == "audio_stub":
            return {"frames": (dp, None, None)}
        if cfg.frontend == "vision_stub":
            return {"patches": (dp, None, None), "tokens": (dp, None)}
        return {"tokens": (dp, None)}
    # decode
    if cfg.frontend == "audio_stub":
        return {"token": (dp, None, None), "pos": ()}
    return {"token": (dp, None), "pos": ()}


def default_parallel(arch: str) -> ParallelConfig:
    """Per-arch parallelism defaults.

    FSDP (param + optimizer sharding over the data axes) for the archs whose
    training state exceeds a model-sharded chip's HBM."""
    fsdp = arch in ("qwen2.5-32b", "kimi-k2-1t-a32b", "stablelm-12b")
    return ParallelConfig(fsdp=fsdp, remat="block")
