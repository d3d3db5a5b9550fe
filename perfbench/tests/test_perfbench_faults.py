"""Each cell's run, driven on the CPU at a size a test can hold (the
harness's look for a card skipped): sound, it comes out correct; with each
fault the cell can have planted underneath the timed path, it comes out
not correct; and the control, in the program's place, fails the cell's
limits."""
import dataclasses
import time

import pytest
import torch

from perfbench import harness

CPU = torch.device("cpu")


def shrink(cell: harness.Cell) -> harness.Cell:
    """The cell at a test's size: narrow products, two layers, few
    tokens."""
    cfg = dict(cell.config)
    traffic = dict(cell.traffic)
    if traffic["driver"] == "gemm_pass":
        cfg["products"] = [dict(p, n=max(16, p["n"] // 64) + p["n"] % 7,
                                k=max(16, p["k"] // 64),
                                count=min(p["count"], 2))
                           for p in cfg["products"]]
        traffic.update(tokens=48, warmup_seconds=0.0)
    else:
        # wide enough that the float8 control's loss parts from float32
        # as it does at the cell's size, and that the matrices, not the
        # few-element biases, set the median leaf's change
        cfg.update(hidden_size=512, intermediate_size=1024,
                   num_attention_heads=4, num_key_value_heads=2,
                   num_hidden_layers=2, vocab_size=2000)
        cfg["derived"] = dict(cfg["derived"], head_dim=128)
        traffic.update(batch=2, seq_len=64, window_batches=2)
        return dataclasses.replace(cell, config=cfg, traffic=traffic,
                                   limits=SMALL_TRAIN_LIMITS)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


#: the training cell's limits at the size above.  Its readings there are
#: not the card's (the program's CPU path; leaves of a few hundred
#: elements, whose norms average out little rounding), so the cell's own
#: limits do not separate them.  Over two seeds and warm-ups of 12 to 100
#: steps sound runs read up to 9.3e-5 (loss), 1.7e-3 (grad_norm) and
#: 5.0e-3 (change_norm), where the float8 control reads at least 2.3e-4
#: and 7.5e-3, and its change_norm no more than a sound run's.
#: Each planted fault and the control fail one of these limits, as on the
#: card they fail the cell's own.
SMALL_TRAIN_LIMITS = {"checks": {"loss": {"limit": 1.5e-4},
                                 "grad_norm": {"limit": 4e-3},
                                 "change_norm": {"limit": 2e-2}}}


def cells():
    return [w["name"] for w in harness.manifest()["workloads"]]


def run(cell, seed=2**31 + 11):
    return harness.run_cell(cell, seed, 0.05, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", cells())
def test_sound_run_is_correct(name):
    line = run(shrink(harness.load_cell(name)))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", cells())
def test_every_fault_comes_out_not_correct(name):
    cell = shrink(harness.load_cell(name))
    drv = harness.driver(cell.traffic["driver"])
    for fault in drv.FAULTS:
        with drv.fault(fault):
            line = run(cell)
        assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("name", cells())
def test_control_fails_the_limits(name):
    cell = shrink(harness.load_cell(name))
    drv = harness.driver(cell.traffic["driver"])
    ctx = harness.Context(cell, 2**31 + 11, 0.05, False, CPU,
                          time.perf_counter())
    got = drv.control_checks(ctx)
    correct, checks = harness.judge(got, cell.limits)
    assert not correct, checks


def test_worst_counts_a_nan_as_the_worst_anywhere():
    assert harness.worst([0.1, float("nan"), 0.2]) == float("inf")
    assert harness.worst([0.1, 0.3, 0.2]) == 0.3
    assert harness.worst([]) == 0.0


@pytest.mark.parametrize("where", [0, 1, 2])
def test_a_nan_in_any_gemm_output_reads_inf(where):
    from perfbench.drivers import gemm_pass
    gen = torch.Generator().manual_seed(5)
    products = [{"name": f"p{i}", "m": 8, "n": 12, "k": 16, "count": 1}
                for i in range(3)]
    inputs = [torch.randn(8, 16, generator=gen).bfloat16() for _ in range(3)]
    weights = [[torch.randn(16, 12, generator=gen).bfloat16()]
               for _ in range(3)]
    seq = gemm_pass.order(products)
    outs = [(inputs[j].float() @ weights[j][i].float()).bfloat16()
            for j, i in seq]
    outs[where][3, 4] = float("nan")
    got = gemm_pass.compare_outputs(seq, inputs, weights, outs, "bf16")
    assert got == {"rel_l2": float("inf"), "max_err": float("inf")}
    correct, checks = harness.judge(got, {"checks": {
        "rel_l2": {"limit": 0.005}, "max_err": {"limit": 0.05}}})
    assert not correct and checks["rel_l2"]["value"] == "inf"


@pytest.mark.parametrize("key", ["loss", "grad_norm", "change_norm"])
def test_a_nan_in_any_training_reading_reads_inf(key):
    from perfbench.drivers import train
    names = [f"w{i}" for i in range(5)]
    want = {"loss": [2.0, 1.9, 1.8],
            "grad_norm": {n: 1.0 + i for i, n in enumerate(names)},
            "change_norm": {n: 0.1 + i for i, n in enumerate(names)}}
    got = {"loss": list(want["loss"]), "grad_norm": dict(want["grad_norm"]),
           "change_norm": dict(want["change_norm"])}
    assert train.gaps(got, want, 1e-3) == {"loss": 0.0, "grad_norm": 0.0,
                                           "change_norm": 0.0}
    if key == "loss":
        got["loss"][2] = float("nan")
    else:
        got[key][names[3]] = float("nan")
    assert train.gaps(got, want, 1e-3)[key] == float("inf")
