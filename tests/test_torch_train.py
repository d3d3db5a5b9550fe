"""The port's training path against the JAX package, on the CPU.

``runtime.train_lib.make_train_step`` takes three steps on the JAX
package's initial weights (``interop.load_jax_params``) and on the JAX
package's batches, beside the JAX package's jitted step, in f32: the
per-step losses agree at rtol 1e-5 and every parameter leaf within 1e-4
relative L2 after each step (AdamW's first moves are near sign(g) · lr, so
a gradient element near zero can flip its step; per leaf the L2 bound
holds).  Then twins of ``tests/test_runtime.py``'s training tests (the
loop improves the loss, a resumed run equals an uninterrupted one, exactly
on the CPU; microbatched gradients equal the full batch's; int8
error-feedback training converges; the watchdog) and the CLI
``python -m repro_torch.launch.train --device cpu``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import make_batch as jmake_batch
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.model import LM as JLM
from repro.runtime import train_lib as jtrain_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import DataIterator, make_batch
from repro_torch.interop import _flatten, _unstack, load_jax_params
from repro_torch.launch import train as train_mod
from repro_torch.models.common import HOST_MESH, tree_leaves
from repro_torch.models.model import LM
from repro_torch.runtime.fault import StepWatchdog
from repro_torch.runtime.train_lib import (
    abstract_train_state,
    init_train_state,
    make_train_step,
)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               kv_cache_dtype="float32")


def _to_torch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _param_rel_l2(values, jvalues):
    want = _unstack(jax.tree.map(np.array, jvalues))
    return {path: float(np.linalg.norm(p.detach().numpy() - want[path])
                        / max(np.linalg.norm(want[path]), 1e-30))
            for path, p in _flatten(values).items()}


def _both(arch, compression="none"):
    """(JAX step, its params and opt state; the port's step, its params
    and opt state), f32, the JAX package's initial weights in both."""
    jcfg, cfg = (_f32(jget_config(arch, smoke=True)),
                 _f32(get_config(arch, smoke=True)))
    tcfg = dict(lr=2e-3, warmup_steps=1, total_steps=10)
    jlm = JLM(jcfg, JHOST_MESH)
    jpcfg = JParallelConfig(grad_compression=compression)
    jp, _, jo, _ = jtrain_lib.init_train_state(jlm, JTrainConfig(**tcfg),
                                               jax.random.key(0), jpcfg)
    jstep = jax.jit(jtrain_lib.make_train_step(jlm, JTrainConfig(**tcfg),
                                               jpcfg))
    lm = LM(cfg, HOST_MESH, device="cpu")
    pcfg = ParallelConfig(grad_compression=compression)
    params, _, opt, _ = init_train_state(lm, TrainConfig(**tcfg),
                                         torch.Generator().manual_seed(0),
                                         pcfg)
    params = load_jax_params(lm, jax.tree.map(np.array, jp))
    step = make_train_step(lm, TrainConfig(**tcfg), pcfg)
    return jstep, jp, jo, step, params, opt


def _jbatch(arch, i):
    return jmake_batch(_f32(jget_config(arch, smoke=True)),
                       JShapeConfig("t", "train", 16, 4), i, seed=5)


@pytest.mark.parametrize("arch,compression", [
    ("qwen2-1.5b", "none"), ("granite-moe-3b-a800m", "none"),
    ("qwen2-1.5b", "int8_ef"), ("musicgen-medium", "none")])
def test_three_steps_match_the_reference(arch, compression):
    jstep, jp, jo, step, params, opt = _both(arch, compression)
    for i in range(3):
        batch = _jbatch(arch, i)
        jp, jo, jm = jstep(jp, jo, batch)
        params, opt, m = step(params, opt, _to_torch(batch))
        for key in ("loss", "lr", "grad_norm", "ce_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-9, err_msg=key)
        np.testing.assert_allclose(float(m["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=1e-5,
                                   atol=1e-7)
        rel = _param_rel_l2(params, jp)
        worst = max(rel, key=rel.get)
        assert rel[worst] <= 1e-4, (i, worst, rel[worst])
    assert int(opt["step"]) == int(jo["step"]) == 3


def test_int8_error_feedback_step_matches_the_reference():
    """One step with ``grad_compression="int8_ef"`` (its learning rate is
    0): the same loss, and the error buffer within one int8 quantum of the
    reference's per element, at most four elements a whole quantum apart (a
    gradient element within the two packages' f32 difference of a rounding
    boundary may round either way)."""
    jstep, jp, jo, step, params, opt = _both("qwen2-1.5b", "int8_ef")
    batch = _jbatch("qwen2-1.5b", 0)
    jp, jo, jm = jstep(jp, jo, batch)
    params, opt, m = step(params, opt, _to_torch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = _unstack(jax.tree.map(np.array, jo["err"]))
    flips = 0
    for path, e in _flatten(opt["err"]).items():
        quantum = 2 * float(np.abs(want[path]).max()) + 1e-30
        d = np.abs(e.numpy() - want[path])
        assert d.max() <= quantum, path
        flips += int((d > quantum / 2).sum())
    assert flips <= 4
    assert float(m["lr"]) == 0.0


def test_train_loop_improves_loss():
    out = train_mod.train("qwen2-1.5b", steps=30, batch=8, seq=64, lr=3e-3,
                          device="cpu")
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) * 0.7
    h = out["history"]
    assert len(h) == 30 and h[0]["lr"] == 0.0 and h[1]["lr"] > 0
    assert all(np.isfinite(r["grad_norm"]) and r["tokens_per_s"] > 0
               for r in h)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Train 6 steps; vs train 3, 'crash', resume 3 — identical params."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeConfig("t", "train", 32, 4)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    pcfg = ParallelConfig()

    def run(n_steps, params, opt, lm, start=0):
        step_fn = make_train_step(lm, tcfg, pcfg)
        data = DataIterator(cfg, shape, seed=3)
        data.load_state_dict({"step": start, "seed": 3})
        for _ in range(n_steps):
            params, opt, _ = step_fn(params, opt, next(data))
        return params, opt

    def fresh():
        lm = LM(cfg, HOST_MESH, device="cpu")
        params, _, opt, _ = init_train_state(lm, tcfg,
                                             torch.Generator().manual_seed(0))
        return lm, params, opt

    lm_a, p0, o0 = fresh()
    pa, oa = run(6, p0, o0, lm_a)

    lm_b, p1, o1 = fresh()
    pb, ob = run(3, p1, o1, lm_b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": pb, "opt": ob},
             extra={"data": {"step": 3, "seed": 3}})
    lm_c = LM(cfg, HOST_MESH, device="cpu")
    av, _, ao, _ = abstract_train_state(lm_c, tcfg)
    like = {"params": av, "opt": ao}
    _, state, extra = mgr.restore_latest(like)
    pc, oc = run(3, state["params"], state["opt"], lm_c,
                 start=extra["data"]["step"])
    for va, vc in zip(tree_leaves(pa), tree_leaves(pc), strict=True):
        assert torch.equal(va, vc)
    for va, vc in zip(tree_leaves(oa), tree_leaves(oc), strict=True):
        assert torch.equal(va, vc)


def test_microbatched_grads_match_full_batch():
    """Gradient accumulation must equal the full-batch gradient (mean CE
    over equal-sized microbatches is exact)."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeConfig("t", "train", 32, 8)
    tcfg = TrainConfig(lr=0.0, warmup_steps=1, total_steps=2, grad_clip=0.0)
    batch = make_batch(cfg, shape, 0, seed=5)

    def one(k):
        lm = LM(cfg, HOST_MESH, device="cpu")
        p, _, o, _ = init_train_state(lm, tcfg,
                                      torch.Generator().manual_seed(1))
        _, o, m = make_train_step(lm, tcfg, ParallelConfig(
            microbatches=k))(p, o, batch)
        return o, m

    o1, m1 = one(1)
    o4, m4 = one(4)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-3)
    assert float(m1["grad_norm"]) == pytest.approx(float(m4["grad_norm"]),
                                                   rel=1e-3)
    assert float(m1["ce_loss"]) == pytest.approx(float(m4["ce_loss"]),
                                                 rel=1e-3)
    # bf16 forward/backward: accumulation order differs between the two
    # paths; agreement is to bf16 resolution, not f32
    worst = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(o1["m"]), tree_leaves(o4["m"])))
    assert worst < 8e-3


def test_train_with_int8_ef_compression_converges():
    """End-to-end training with int8 error-feedback gradient compression in
    the loop still reduces loss at a comparable rate."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeConfig("t", "train", 32, 8)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=20)

    def run(pcfg):
        lm = LM(cfg, HOST_MESH, device="cpu")
        p, _, o, _ = init_train_state(lm, tcfg,
                                      torch.Generator().manual_seed(0), pcfg)
        step = make_train_step(lm, tcfg, pcfg)
        it = DataIterator(cfg, shape, seed=11)
        losses = []
        for _ in range(15):
            p, o, m = step(p, o, next(it))
            losses.append(float(m["loss"]))
        return losses

    plain = run(ParallelConfig())
    comp = run(ParallelConfig(grad_compression="int8_ef"))
    assert comp[-1] < comp[0] * 0.8          # still learns
    assert abs(comp[-1] - plain[-1]) / plain[-1] < 0.5


def test_watchdog_flags_stragglers():
    import time
    wd = StepWatchdog(threshold=3.0)
    for _ in range(5):
        wd.start()
        time.sleep(0.01)
        wd.stop()
    wd.start()
    time.sleep(0.2)
    assert wd.stop() and wd.straggler_steps == 1
    assert wd.summary()["steps"] == 6


def test_abstract_train_state_is_meta_and_matches_the_real_one():
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    tcfg = TrainConfig()
    pcfg = ParallelConfig(grad_compression="int8_ef")
    lm = LM(cfg, HOST_MESH, device="cpu")
    av, _, ao, _ = abstract_train_state(lm, tcfg, pcfg)
    v, _, o, _ = init_train_state(lm, tcfg, torch.Generator().manual_seed(0),
                                  pcfg)
    assert all(t.device.type == "meta" for t in tree_leaves([av, ao]))
    for a, b in zip(tree_leaves([av, ao]), tree_leaves([v, o]), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_train_cli_runs_resumes_and_logs_like_the_reference(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    args = ["--device", "cpu", "--arch", "qwen2-1.5b", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    saves = []
    real_save = CheckpointManager.save
    monkeypatch.setattr(CheckpointManager, "save", lambda self, step, *a, **k:
                        saves.append(step) or real_save(self, step, *a, **k))
    assert train_mod.main(args) == 0
    assert saves == [2, 4]          # the last step is written once
    out = capsys.readouterr().out
    assert "step     4 loss" in out and "watchdog:" in out
    assert "loss: first5=" in out and "last5=" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    assert train_mod.main(args[:5] + ["7"] + args[6:]) == 0
    assert saves == [2, 4, 6, 7]
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     7 loss" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 6, 7]


def test_preemption_makes_an_emergency_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(CheckpointManager, "install_preemption_handler",
                        CheckpointManager.simulate_preemption)
    out = train_mod.train("qwen2-1.5b", steps=5, batch=2, seq=16,
                          ckpt_dir=str(tmp_path), device="cpu")
    assert out["preempted"] and out["step"] == 1
    assert CheckpointManager(str(tmp_path)).all_steps() == [1]


def test_train_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.train("qwen2-1.5b", steps=1)
    assert train_mod.main(["--steps", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
