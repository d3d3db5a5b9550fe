"""Mesh construction on ``torch.distributed``.

The counterpart of ``repro.launch.mesh``.  Functions, not module-level
constants: importing this module creates no process group and touches no
device.  Both build a ``DeviceMesh`` over the default process group, which
the caller initialises first (``torch.distributed.init_process_group``
with its own address, world size and rank: nothing on a card's machine
announces a cluster).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks) of
    cards; ``device_type="cpu"`` for the dry run's fake group
    (``launch/dryrun.py``), which touches no card."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small ``(data, model)`` mesh over the initialised ranks (tests,
    one card, a few cards of one host)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
