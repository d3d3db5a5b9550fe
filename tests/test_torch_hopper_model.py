"""The Hopper tile cost model (``repro_torch.core.hopper_model``) the
``cuda`` backend plans on, and its fit (``Calibrator(model="hopper")``).

The JAX package has no counterpart: its executable backend plans on the
TPU model, which the port keeps as ``analytic-tpu`` (parity in
``tests/test_torch_gemm.py``).  These tests hold the new model to the
kernels' own configuration functions and to itself: the batched engine
bit for bit against the scalar one, hand-worked padding and waves, and a
simulated closed loop that recovers every rate and per-call cost.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro_torch import gemm, machines, measure
from repro_torch.configs import get_config
from repro_torch.core import hopper_model as H
from repro_torch.core.autotune import _CAND_K, _CAND_MN, model_gemm_shapes
from repro_torch.core.mobilenet import TABLE2
from repro_torch.core.tpu_model import GemmShape, GridOrder, TileConfig
from repro_torch.kernels import gemm as K
from repro_torch.machines.calibrate import Calibrator

#: shapes that reach every term: Qwen2-1.5B's widths, Table-2 rows TMA
#: cannot read in place (K = 27, 1; N = 49, 196), decode (M = 1, 4), a
#: ragged k-outer pass and a C too large for L2
SHAPES = [(4096, 2048, 1536), (512, 196, 4608), (32, 12544, 27),
          (1024, 1000, 1), (1024, 49, 9216), (4, 151936, 1536),
          (1, 49408, 1536), (300, 520, 390), (8192, 8192, 1024)]


@pytest.fixture(autouse=True)
def _clean_registry():
    before = set(machines.list_machines())
    yield
    for name in set(machines.list_machines()) - before:
        machines.unregister(name)
    machines.load_zoo()


def _truth():
    """A scaled h100 with per-call costs of its own: the closed loop's
    ground truth."""
    h100 = machines.get("h100")
    return dataclasses.replace(
        h100.scaled(arith=0.35, bw=0.55, name="h100-hopper-truth"),
        call_costs={"bf16": 4.1e-5, "int8": 7.3e-5, "f32": 2.9e-5,
                    "launch": 6.2e-6})


@pytest.mark.parametrize("dtype", H.DTYPES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_estimate_batch_is_bit_identical_to_estimate(dtype, accumulate):
    h100 = machines.get("h100")
    tiles = H.lattice(dtype)
    shapes = [GemmShape(*s, dtype=dtype, accumulate=accumulate)
              for s in SHAPES]
    lat = H.estimate_batch(shapes, H.lattice_arrays(dtype), h100,
                           lattice=True)
    assert lat.total.shape == (len(shapes), len(tiles))
    for i, sh in enumerate(shapes):
        for j in range(0, len(tiles), 7):
            c = H.estimate(sh, tiles[j], h100)
            assert c.total == lat.total[i, j]
            assert (c.flops, c.hbm_bytes, c.l2_bytes, c.launches,
                    c.waves) == (lat.flops[i, j], lat.hbm_bytes[i, j],
                                 lat.l2_bytes[i, j], lat.launches[i, j],
                                 lat.waves[i, j])
    # the elementwise form (one tile per shape) agrees too
    picks = [tiles[(5 * i) % len(tiles)] for i in range(len(shapes))]
    one = H.estimate_batch(shapes, H.TileArrays.of(picks, [dtype] *
                                                   len(picks)), h100)
    assert list(one.total) == [H.estimate(sh, t, h100).total
                               for sh, t in zip(shapes, picks)]


@pytest.mark.parametrize("dtype", H.DTYPES)
@pytest.mark.parametrize("order", list(GridOrder))
def test_lattice_is_the_tiles_check_tile_takes(dtype, order):
    taken = set()
    for bm, bn, bk in itertools.product(_CAND_MN, _CAND_MN, _CAND_K):
        tile = TileConfig(bm, bn, bk, order)
        try:
            K.check_tile(tile, dtype, k_outer=order is GridOrder.K_OUTER)
        except ValueError:
            continue
        taken.add(tile)
    mine = {t for t in H.lattice(dtype) if t.order is order}
    assert mine == taken and len(mine) > 100


def test_padding_and_waves_at_hand_worked_shapes():
    h100 = machines.get("h100")
    # bf16 64x128x128: one consumer warpgroup (one m64n128 unit); two
    # 49,152-byte stages and the 16 KB C tile (114,728 B) leave room for
    # two blocks an SM: 264 slots, 1,024 blocks, 4 waves
    c = H.estimate(GemmShape(4096, 2048, 1536), TileConfig(64, 128, 128),
                   h100)
    assert (c.blocks, c.waves, c.route) == (1024, 4, "wgmma")
    assert c.flops == 2.0 * 4 * 264 * 64 * 128 * 1536
    assert c.launches == 1 and c.calls == 1
    # decode: 4 rows issue m64, K = 1536 is 12 slabs: 16x the useful ops
    c = H.estimate(GemmShape(4, 1024, 1536), TileConfig(8, 128, 128), h100)
    g = H.tile_geometry(TileConfig(8, 128, 128), "bf16")
    assert g.work == 64 * 128
    assert c.blocks == 8 and c.waves == 1
    assert c.flops == 2.0 * 132 * g.resident * 64 * 128 * 1536
    # f32 32x64: 64 threads' 4x8 register tiles cover the block exactly;
    # five 38,400-byte blocks fit an SM's shared memory, but 255 registers
    # a thread leave room for four; K = 27 pads to the 32-deep sub-slab
    g = H.tile_geometry(TileConfig(32, 64, 128), "f32")
    cfg = K.launch_config(TileConfig(32, 64, 128), "f32")
    assert (cfg.threads, cfg.rm, cfg.rn, cfg.blocks_per_sm) == (64, 4, 8, 5)
    assert (g.route, g.work, g.ks, g.resident) == \
        ("cuda_cores", 32 * 64, 32, 4)
    c = H.estimate(GemmShape(100, 64, 27, dtype="f32"),
                   TileConfig(32, 64, 128), h100)
    assert c.blocks == 4 and c.waves == 1
    assert c.flops == 2.0 * 132 * 4 * 32 * 64 * 32
    assert c.hbm_bytes == (100 * 27 + 27 * 64 + 100 * 64) * 4.0
    # bf16 128x256: N = 256 runs one warpgroup in two rounds (two would
    # spill), each round staging its slabs again
    g = H.tile_geometry(TileConfig(128, 256, 128), "bf16")
    cfg = K.wgmma_config(TileConfig(128, 256, 128))
    assert (cfg.nw, cfg.consumers, cfg.rounds) == (256, 1, 2)
    assert (g.work, g.piece_bytes) == (2 * 64 * 256, 2 * cfg.stage_bytes)


def test_per_call_terms_count_what_the_wrapper_enqueues():
    h100 = machines.get("h100")
    inner, outer = TileConfig(64, 128, 128), \
        TileConfig(64, 128, 128, GridOrder.K_OUTER)

    def cost(m, n, k, dtype, tile, **kw):
        return H.estimate(GemmShape(m, n, k, dtype=dtype, **kw), tile, h100)
    assert cost(512, 512, 512, "bf16", inner).launches == 1
    # int8: B written transposed first (its bytes on HBM)
    c8, c16 = cost(512, 512, 512, "int8", inner), \
        cost(512, 512, 512, "bf16", inner)
    assert c8.launches == 2
    assert c8.hbm_bytes - (512 * 512 * 2 + 512 * 512 * 4) == 2 * 512 * 512
    assert c16.hbm_bytes == 512 * 512 * 2 * 3.0
    # rows TMA cannot read in place are copied once: A at K = 27, B at
    # N = 196 (bf16; int8's B is the transposed copy, f32 takes no TMA)
    assert cost(32, 12544, 27, "bf16", inner).launches == 2
    assert cost(512, 196, 256, "bf16", inner).launches == 2
    assert cost(512, 196, 256, "int8", inner).launches == 2
    assert cost(32, 12544, 27, "f32", inner).launches == 1
    # k-outer: the zeroed C, its clone and one launch per k block (392 is
    # three full passes and a ragged one); with a C to update, no zeros;
    # K = 390 also copies A (780-byte rows)
    assert cost(300, 520, 392, "bf16", outer).launches == 2 + 4
    assert cost(300, 520, 392, "bf16", outer, accumulate=True).launches \
        == 1 + 4
    assert cost(300, 520, 390, "bf16", outer).launches == 2 + 4 + 1
    assert cost(300, 520, 390, "f32", inner, accumulate=True).launches == 2
    # k-outer's C stream: L2 while C fits there, HBM once it does not
    small, big = cost(300, 520, 390, "bf16", outer), \
        cost(8192, 8192, 1024, "bf16", outer)
    c_small = 300 * 520 * 2
    assert small.l2_bytes >= 2 * 4 * c_small
    assert big.hbm_bytes >= 2 * 8 * 8192 * 8192 * 2


def test_machines_without_the_models_constants_raise():
    for name in ("tpu-v5e", "gap8-fc"):
        with pytest.raises(ValueError, match="Hopper tile model needs"):
            gemm.plan((256, 256, 256), backend="cuda", machine=name,
                      dtype="bf16", cache=False)
    h100 = machines.get("h100")
    bare = dataclasses.replace(h100, name="h100-no-calls", call_costs={})
    with pytest.raises(ValueError, match="call_costs"):
        gemm.plan((256, 256, 256), backend="cuda", machine=bare,
                  dtype="bf16", cache=False)
    with pytest.raises(ValueError, match="compute"):
        H.estimate(GemmShape(64, 64, 64, dtype="int4"),
                   TileConfig(64, 64, 128), h100)


def test_cuda_plans_are_the_cheapest_lattice_tile_the_kernels_take():
    h100 = machines.get("h100")
    shapes = [GemmShape(s.m, s.n, s.k, dtype=dt) for dt in H.DTYPES
              for s in model_gemm_shapes(get_config("qwen2-1.5b"),
                                         tokens=4096)]
    shapes += [GemmShape(r.m, r.n, r.k, dtype=dt) for dt in H.DTYPES
               for r in TABLE2]
    shapes += [GemmShape(m, 49408, 1536, dtype=dt) for dt in H.DTYPES
               for m in (1, 4, 32)]
    plans = gemm.plan_many(shapes, backend="cuda", machine="h100",
                           cache=False)
    for sh, p in zip(shapes, plans):
        t = p.selection
        K.check_tile(t, sh.dtype, k_outer=t.order is GridOrder.K_OUTER)
        assert isinstance(p.cost, H.HopperCost)
        assert p.predicted_seconds == p.cost.total
        best = min(H.estimate(sh, c, h100).total for c in H.lattice(sh.dtype))
        assert p.predicted_seconds == best
        ex = p.explain()
        assert ex["composition"] == "sum"
        assert sum(term["seconds"] for term in ex["terms"]) == \
            pytest.approx(p.predicted_seconds, rel=1e-12)
    # an explicit tile is priced as given; one the kernels refuse raises
    p = gemm.plan((512, 512, 512), backend="cuda", dtype="f32",
                  tile=TileConfig(64, 128, 128, GridOrder.K_OUTER),
                  cache=False)
    assert str(p.selection) == "64x128x128:k_outer"
    with pytest.raises(ValueError, match="register tiles"):
        gemm.plan((512, 512, 512), backend="cuda", dtype="f32",
                  tile=TileConfig(256, 128, 128), cache=False)


def test_hopper_design_matrix_matches_scalar_and_the_model():
    h100 = machines.get("h100")
    probs = [GemmShape(*s, dtype=dt) for s in SHAPES[:6] for dt in H.DTYPES]
    cal = Calibrator(h100, model="hopper")
    A, cols = cal.design_matrix(probs)
    sA, scols = cal.design_matrix_scalar(probs)
    assert cols == scols == ["rate:M->L2", "rate:L2->L1", "arith:bf16",
                             "arith:f32", "arith:int8", "call:bf16",
                             "call:f32", "call:int8", "call:launch"]
    np.testing.assert_array_equal(A, sA)
    # the fitted function is the predicted one: A @ x is each plan's time
    x = np.array([1 / h100.rate("M", "L2"), 1 / h100.rate("L2", "L1"),
                  1 / h100.arith_rate["bf16"], 1 / h100.arith_rate["f32"],
                  1 / h100.arith_rate["int8"], h100.call_costs["bf16"],
                  h100.call_costs["f32"], h100.call_costs["int8"],
                  h100.call_costs["launch"]])
    plans = gemm.plan_many(probs, backend="cuda", machine=h100, cache=False)
    np.testing.assert_allclose(A @ x, [p.predicted_seconds for p in plans],
                               rtol=1e-12)


def test_simulated_closed_loop_recovers_every_rate_and_call_cost(tmp_path):
    """A scaled h100 truth "measures" cuda plans over varied tiles in both
    loop orders and all three dtypes; fitting the store with the Hopper
    model recovers its rates and per-call costs, and validation replays
    the cuda backend's plans at a MAPE of zero."""
    truth = _truth()
    harness = measure.get_harness("simulated", truth=truth)
    h100 = machines.get("h100")
    store = measure.SampleStore(str(tmp_path / "hopper.jsonl"))
    shapes = SHAPES[:8] + [(2048, 6144, 4096)]
    tiles = [TileConfig(64, 128, 128), TileConfig(128, 128, 256),
             TileConfig(32, 64, 128, GridOrder.K_OUTER),
             TileConfig(128, 64, 512, GridOrder.K_OUTER),
             TileConfig(8, 128, 128)]
    for dt in H.DTYPES:
        for s, t in itertools.product(shapes, tiles):
            plan = gemm.plan(s, backend="cuda", machine="h100", dtype=dt,
                             tile=t, cache=False)
            store.append(measure.Sample.from_measurement(
                plan, harness.measure(plan), "simulated", h100))
    # the searched campaign lands in the same store
    measure.run_campaign("table2", machine="h100", harness=harness,
                         backend="cuda", dtype="bf16", store=store)
    spec, rep = measure.fit_from_store(store, "h100", name="h100-recovered",
                                       date=None, on_nonpositive="raise")
    assert not rep.dropped
    assert spec.provenance["fit"]["cost_model"] == {"model": "hopper"}
    for key in (("M", "L2"), ("L2", "L1")):
        assert spec.transfer_rates[key] == pytest.approx(
            truth.transfer_rates[key], rel=1e-9)
    for dt in H.DTYPES:
        assert spec.arith_rate[dt] == pytest.approx(truth.arith_rate[dt],
                                                    rel=1e-9)
    for key, cost in truth.call_costs.items():
        assert spec.call_costs[key] == pytest.approx(cost, rel=1e-9)
    report = measure.validate_spec(spec, store)
    assert report.mape < 1e-6
    # the fitted manifest round-trips, per-call costs included
    path = spec.to_manifest(str(tmp_path / "h100-recovered.json"))
    assert machines.MachineSpec.from_manifest(path) == spec


def test_a_store_mixing_cuda_and_tpu_tile_samples_is_refused(tmp_path):
    """cuda samples fit on the Hopper model, analytic-tpu ones on the TPU
    model: one store holding both is not one fit."""
    truth = _truth()
    store = str(tmp_path / "mixed.jsonl")
    for backend in ("cuda", "analytic-tpu"):
        measure.run_campaign("smoke", machine="h100", harness="simulated",
                             truth=truth, backend=backend, dtype="bf16",
                             store=store)
    with pytest.raises(ValueError, match="mixes cuda and other tile-model"):
        measure.fit_from_store(store, "h100", date=None)


def test_a_manifest_tile_the_kernels_refuse_is_searched_again(
        tmp_path, monkeypatch):
    """A warmed TileTuner manifest may hold a tile the cuda kernels do not
    take (the TPU model's, on another machine): the cuda plan searches
    instead of raising; one they take is used as persisted."""
    from repro_torch.gemm import planner
    from repro_torch.gemm.cache import PlanCache
    monkeypatch.setattr(planner, "_CACHE", PlanCache())
    path = tmp_path / "tiles.json"
    path.write_text(
        '{"512x512x512:f32": {"bm": 256, "bn": 256, "bk": 128, '
        '"order": "k_inner"}, "256x256x256:f32": {"bm": 64, "bn": 64, '
        '"bk": 128, "order": "k_outer"}}')
    assert gemm.warm_cache(str(path)) == 2
    refused = gemm.plan((512, 512, 512), backend="cuda", dtype="f32")
    assert refused.provenance["source"] == "search"
    K.check_tile(refused.selection, "f32")
    taken = gemm.plan((256, 256, 256), backend="cuda", dtype="f32")
    assert taken.provenance["source"] == "manifest"
    assert str(taken.selection) == "64x64x128:k_outer"
