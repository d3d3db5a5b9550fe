"""The port's roofline (``core/roofline.py``) and its probes
(``launch/roofline_probe.py``).

* each term of ``RooflineReport`` is the reference's arithmetic: priced
  at the V5E rates ``src/repro/core/roofline.py`` divides by, the port's
  report gives the JAX package's ``row()`` on the same counts; on the
  card's rates it divides by the ``h100`` manifest's bf16 and HBM rates
  and the InfiniBand NDR link rate;
* ``collective_bytes`` sums a ``COLLECTIVES`` snapshot by XLA's op names
  (a send as a collective-permute, its receive not again) with the
  reference's keys;
* the probe's 1- and 2-period extrapolation equals a direct dry run of
  the full-depth config (the port counts every layer, so it can check
  what XLA's scan accounting could not): flops, bytes and collective
  bytes, at smoke widths on a (2, 2) mesh, in spawned processes (the dry
  run opens a fake default group).
"""
import dataclasses

import numpy as np
import pytest

import _torch_dist as W
from repro.core import roofline as jroofline
from repro.core.hardware import V5E_HBM_BW, V5E_ICI_BW, V5E_PEAK_BF16
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import roofline
from repro_torch.launch import roofline_probe

V5E = roofline.Rates(peak_flops=V5E_PEAK_BF16, hbm_bw=V5E_HBM_BW,
                     link_bw=V5E_ICI_BW)


def test_h100_rates_are_the_manifests_and_the_ndr_link():
    r = roofline.card_rates()
    assert (r.peak_flops, r.hbm_bw, r.link_bw) == (989e12, 3.35e12, 50e9)
    assert roofline.IB_NDR_BW == 400e9 / 8 and roofline.NVLINK4_BW == 450e9


@pytest.mark.parametrize("seed", range(4))
def test_terms_are_the_reference_arithmetic_at_its_rates(seed):
    rng = np.random.default_rng(seed)
    flops, nbytes, coll, mf = (float(x) for x in
                               10.0 ** rng.uniform(6, 15, size=4))
    chips = int(rng.choice([1, 4, 256, 512]))
    fields = dict(arch="a", shape_name="s", mesh="16x16", chips=chips,
                  hlo_flops=flops, hlo_bytes=nbytes, coll_bytes=coll,
                  model_flops=mf, coll_detail={"_total": coll})
    got = roofline.RooflineReport(**fields, rates=V5E)
    want = jroofline.RooflineReport(**fields)
    assert got.row() == want.row()
    assert got.step_time == want.step_time
    card = roofline.RooflineReport(**fields)
    assert card.t_compute == flops / 989e12
    assert card.t_memory == nbytes / 3.35e12
    assert card.t_collective == coll / 50e9


def test_collective_bytes_sums_a_snapshot_by_xla_op():
    snap = {("all_gather", "data"): {"calls": 3, "bytes": 300},
            ("all_reduce", "model"): {"calls": 2, "bytes": 40},
            ("all_reduce", "pod+data"): {"calls": 1, "bytes": 8},
            ("reduce_scatter", "data"): {"calls": 3, "bytes": 1200},
            ("all_to_all", "model"): {"calls": 2, "bytes": 64},
            ("send", "pod"): {"calls": 5, "bytes": 50},
            ("recv", "pod"): {"calls": 5, "bytes": 50}}
    got = roofline.collective_bytes(snap)
    assert got == {"all-gather": 300.0, "all-reduce": 48.0,
                   "reduce-scatter": 1200.0, "all-to-all": 64.0,
                   "collective-permute": 50.0, "_total": 1662.0,
                   "_count": 16.0}
    assert set(got) == set(jroofline.collective_bytes(""))
    rec = {"arch": "a", "shape": "s", "mesh": "2x2", "chips": 4,
           "flops": 1e9, "bytes_accessed": 2e9,
           "collectives": {f"{op} over {ax}": v
                           for (op, ax), v in snap.items()}}
    rep = roofline.from_record(rec, model_flops=3e9)
    assert (rep.coll_bytes, rep.hlo_flops, rep.hlo_bytes) == (1662.0, 1e9,
                                                             2e9)


def _zamba_three_periods():
    cfg = get_config("zamba2-1.2b", smoke=True)
    pattern = ("mamba2", "mamba2", "shared_attn") * 3 + ("mamba2",)
    return dataclasses.replace(cfg, n_layers=len(pattern),
                               block_pattern=pattern)


PROBES = {
    "qwen2-1.5b train": ("qwen2-1.5b", get_config("qwen2-1.5b", smoke=True),
                         ShapeConfig("train_4k", "train", 16, 4)),
    "kimi-k2 prefill": ("kimi-k2-1t-a32b",
                        get_config("kimi-k2-1t-a32b", smoke=True),
                        ShapeConfig("prefill_32k", "prefill", 32, 4)),
    "zamba2 long decode": ("zamba2-1.2b", _zamba_three_periods(),
                           ShapeConfig("long_500k", "decode", 64, 1)),
}


@pytest.mark.parametrize("case", sorted(PROBES))
def test_the_probe_extrapolates_to_a_direct_full_depth_run(case):
    arch, cfg, shape = PROBES[case]
    probe, direct = W.run_alone(W.probe_vs_direct, arch, shape.name, cfg,
                                shape, (2, 2))
    assert probe["n_periods"] == 3
    assert (probe["hlo_flops"], probe["hlo_bytes"],
            probe["collective_bytes"]) == (direct["flops"],
                                           direct["bytes_accessed"],
                                           direct["collective_bytes"])
    assert probe["per_period_flops"] > 0
    assert probe["model_flops"] == roofline_probe.model_flops(cfg, shape)
    # the probe's terms are the report's on the same counts
    rep = roofline.RooflineReport(
        arch=arch, shape_name=shape.name, mesh="2x2", chips=4,
        hlo_flops=probe["hlo_flops"], hlo_bytes=probe["hlo_bytes"],
        coll_bytes=probe["collective_bytes"],
        model_flops=probe["model_flops"], coll_detail={})
    for key in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "useful_flop_ratio", "roofline_fraction"):
        assert probe[key] == rep.row()[key], key
    assert probe["step_time_bound_s"] == rep.step_time
