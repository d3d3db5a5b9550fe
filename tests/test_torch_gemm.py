"""Planning parity between the port (``repro_torch.gemm``) and ``repro.gemm``.

The port's ``analytic-tpu`` planner is a copy of the JAX package's NumPy
planner; the same problems on the same machine must give the same
selections and the same costs, on the TPU zoo entry and on the port's
``h100`` manifest (read into the JAX package through
``MachineSpec.from_manifest``).  The ``cuda`` backend plans on the Hopper
tile model instead (``tests/test_torch_hopper_model.py``); here it takes
the reference's tiles pinned.  The plan-cache manifest and the machine
manifests interchange between the packages.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro import gemm as jgemm
from repro.configs import get_config as jget_config
from repro.core.autotune import model_gemm_shapes as jmodel_gemm_shapes
from repro.core.mobilenet import TABLE2 as JTABLE2
from repro.gemm import planner as jplanner
from repro.gemm.cache import PlanCache as JPlanCache
from repro.machines import MachineSpec as JMachineSpec
from repro_torch import gemm as tgemm
from repro_torch import machines as tmachines
from repro_torch.configs import get_config
from repro_torch.core.autotune import _feasible_mask, model_gemm_shapes
from repro_torch.core.mobilenet import TABLE2
from repro_torch.core.tpu_model import GemmShape, TileConfig
from repro_torch.gemm import planner as tplanner
from repro_torch.gemm.cache import PlanCache
from repro_torch.kernels import gemm as K
from repro_torch.machines import MachineSpec

H100_JSON = os.path.join(os.path.dirname(tmachines.__file__), "zoo",
                         "h100.json")


def _machines(name):
    """(JAX-side machine, port-side machine) for one zoo name."""
    if name == "h100":
        return JMachineSpec.from_manifest(H100_JSON), "h100"
    return name, name


def _problems(which):
    if which == "table2":
        return ([r.problem for r in JTABLE2], [r.problem for r in TABLE2])
    return (jmodel_gemm_shapes(jget_config("qwen2-1.5b"), tokens=4096),
            model_gemm_shapes(get_config("qwen2-1.5b"), tokens=4096))


@pytest.mark.parametrize("machine", ["tpu-v5e", "h100"])
@pytest.mark.parametrize("backends", [("pallas", "analytic-tpu"),
                                      ("analytic-tpu", "analytic-tpu")])
@pytest.mark.parametrize("which", ["table2", "qwen2-1.5b"])
def test_tile_planning_matches_reference(machine, backends, which):
    jm, tm = _machines(machine)
    jprobs, tprobs = _problems(which)
    jplans = jgemm.plan_many(jprobs, backend=backends[0], machine=jm,
                             cache=False)
    tplans = tgemm.plan_many(tprobs, backend=backends[1], machine=tm,
                             cache=False)
    assert len(jplans) == len(tplans) > 0
    for jp, tp in zip(jplans, tplans):
        assert str(jp.selection) == str(tp.selection)
        assert dataclasses.astuple(jp.cost) == dataclasses.astuple(tp.cost)
        assert jp.predicted_seconds == tp.predicted_seconds
        if machine == "h100":
            # the cuda backend takes the reference's tile when pinned to it
            pinned = tgemm.plan(tp.problem, backend="cuda", machine="h100",
                                tile=tp.selection, cache=False)
            assert str(pinned.selection) == str(jp.selection)
            assert pinned.predicted_seconds > 0


def test_gap8_simulator_planning_matches_reference():
    jplans = jgemm.plan_many([r.problem for r in JTABLE2],
                             backend="analytic-gap8", cache=False)
    tplans = tgemm.plan_many([r.problem for r in TABLE2],
                             backend="analytic-gap8", cache=False)
    for jp, tp in zip(jplans, tplans):
        assert str(jp.selection) == str(tp.selection)
        assert jp.cost.total == tp.cost.total


def test_h100_plans_pick_cta_sized_k_inner_tiles():
    """The cuda backend's search on the Hopper tile model picks CTA tiles
    for the slice's shapes, all k-inner: one per dtype for the five
    Qwen2-1.5B GEMMs (int8 at half bf16's bytes affords the wider N), and
    Table-2's own (the analytic-tpu picks on h100 stay the reference's,
    test_tile_planning_matches_reference)."""
    qwen = {}
    for dt in ("int8", "bf16", "f32"):
        plans = tgemm.plan_model_gemms(get_config("qwen2-1.5b"), tokens=4096,
                                       backend="cuda", machine="h100",
                                       dtype=dt)
        qwen[dt] = {str(p.selection) for p in plans}
    assert qwen == {"bf16": {"128x128x128:k_inner"},
                    "int8": {"128x256x128:k_inner"},
                    "f32": {"128x128x128:k_inner"}}
    picks = {}
    for dt in ("int8", "bf16", "f32"):
        plans = tgemm.plan_many([GemmShape(r.m, r.n, r.k, dtype=dt)
                                 for r in TABLE2],
                                backend="cuda", machine="h100")
        picks[dt] = {str(p.selection) for p in plans}
        assert all(s.endswith(":k_inner") for s in picks[dt])
    assert picks["bf16"] == {
        "128x128x128:k_inner", "32x64x128:k_inner", "64x1024x128:k_inner",
        "64x512x128:k_inner", "64x64x128:k_inner", "64x64x256:k_inner"}
    assert picks["int8"] == {
        "128x128x128:k_inner", "128x64x256:k_inner", "32x128x512:k_inner",
        "64x128x256:k_inner", "64x256x128:k_inner", "64x64x512:k_inner"}
    assert "2048x8x128:k_inner" in picks["f32"]


@pytest.mark.parametrize("direction", ["repro->repro_torch",
                                       "repro_torch->repro"])
def test_plan_cache_manifest_interchanges(tmp_path, monkeypatch, direction):
    monkeypatch.setattr(jplanner, "_CACHE", JPlanCache())
    monkeypatch.setattr(tplanner, "_CACHE", PlanCache())
    path = str(tmp_path / "tiles.json")
    shapes = [(1024, 512, 2048), (4096, 2048, 1536), (300, 200, 100)]
    writer, reader = (jgemm, tgemm) if direction.startswith("repro->") \
        else (tgemm, jgemm)
    wb, rb = ("pallas", "analytic-tpu") if writer is jgemm \
        else ("analytic-tpu", "pallas")
    fresh = [writer.plan(s, backend=wb, machine="tpu-v5e") for s in shapes]
    assert writer.save_cache(path) == len(shapes)
    assert reader.warm_cache(path) == len(shapes)
    warmed = [reader.plan(s, backend=rb, machine="tpu-v5e") for s in shapes]
    for f, w in zip(fresh, warmed):
        assert w.provenance["source"] == "manifest"
        assert str(w.selection) == str(f.selection)
        assert w.predicted_seconds == f.predicted_seconds
    assert reader.plan_cache_stats()["manifest_hits"] == len(shapes)
    # the port's cuda backend executes the warmed tile when pinned to it
    import torch
    w = warmed[-1]
    p = w.problem
    a = torch.randn(p.m, p.k, dtype=torch.bfloat16)
    b = torch.randn(p.k, p.n, dtype=torch.bfloat16)
    pinned = tgemm.plan((p.m, p.n, p.k), backend="cuda", machine="h100",
                        tile=w.selection, cache=False)
    assert str(pinned.selection) == str(w.selection)
    torch.testing.assert_close(pinned.execute(a, b).float(),
                               a.float() @ b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("shape", [(1 << 20, 1 << 20, 1 << 20),
                                   (100, 100, 100), (8, 8, 8)])
def test_every_feasible_h100_tile_fits_the_kernels(dtype, shape):
    """Every tile the TPU model's lattice admits on h100 fits a Hopper
    block's shared memory and the compiled register tiles, so the kernels
    take any analytic-tpu plan pinned on the cuda backend; and every tile
    the cuda backend's own search can return is one its route takes."""
    h100 = tmachines.get("h100")
    m, n, k = (np.array([[x]]) for x in shape)
    s = np.array([[{"int8": 1, "bf16": 2, "f32": 4}[dtype]]])
    mask = _feasible_mask(m, n, k, s, h100.capacity("L1"))[0]
    from repro_torch.core.autotune import _lattice
    bm, bn, bk, _ = _lattice()
    tiles = {(int(bm[i]), int(bn[i]), int(bk[i]))
             for i in np.flatnonzero(mask)}
    assert tiles
    for t in tiles:
        tile = TileConfig(*t)
        assert K.smem_bytes(tile, dtype) <= 232448
        K.launch_config(tile, dtype)          # raises if not taken
    # and every tile the cuda backend's own search can return, in both
    # loop orders, is one its route takes
    from repro_torch.core import hopper_model
    lattice = hopper_model.lattice(dtype)
    for t in lattice:
        k_outer = t.order.value == "k_outer"
        cfg = K.check_tile(t, dtype, k_outer=k_outer)
        if dtype == "f32":
            cfg = K.launch_config(t, dtype, k_outer=k_outer)
        assert cfg.smem_bytes <= 232448
    pick = tgemm.plan(GemmShape(*shape, dtype=dtype), backend="cuda",
                      machine="h100", cache=False).selection
    assert pick in lattice


def test_h100_manifest_validates_and_is_marked_uncalibrated():
    spec = MachineSpec.from_manifest(H100_JSON)
    spec.validate()
    assert spec.provenance["uncalibrated"] is True
    assert "uncalibrated" in spec.provenance["status"]
    assert "H100" in spec.provenance["source"]
    assert spec.capacity("L1") == 232448
    assert spec.capacity("L2") == 50 * 1024 * 1024
    assert spec.call_costs["launch"] > 0
    again = MachineSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert again.fingerprint() == spec.fingerprint()
    assert again.geometry_fingerprint() == spec.geometry_fingerprint()
    # the JAX package reads the same geometry and rates (it ignores the
    # per-call costs, which only the port's Hopper model charges)
    jspec = JMachineSpec.from_manifest(H100_JSON)
    assert jspec.geometry_fingerprint() == spec.geometry_fingerprint()
    assert dict(jspec.transfer_rates) == dict(spec.transfer_rates)
    assert dict(jspec.arith_rate) == dict(spec.arith_rate)
    assert jspec.fingerprint() == dataclasses.replace(
        spec, call_costs={}).fingerprint()


@pytest.mark.parametrize("name", ["tpu-v5e", "gap8-fc", "host-cpu"])
def test_zoo_copies_keep_their_fingerprints(name):
    from repro import machines as jmachines
    assert tmachines.get(name).fingerprint() == \
        jmachines.get(name).fingerprint()
    assert tmachines.get(name).cache_token == jmachines.get(name).cache_token


def test_default_execute_backend_is_cuda():
    assert tgemm.default_execute_backend() == "cuda"
    assert tgemm.backends() == ["analytic-gap8", "analytic-tpu", "cuda",
                                "reference"]
