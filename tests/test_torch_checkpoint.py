"""The port's checkpoint manager, on the CPU: twins of
``tests/test_runtime.py``'s checkpoint tests (round trip, keep-N, no
partial checkpoint listed, restore into another placement, the preemption
flag), the JAX package's layout (``/``-joined path keys, ``meta.json`` with
``"treedef": null``, ``.complete``), and interchange with the JAX package:
a checkpoint its trainer wrote (stacked layer periods) restores into the
port's trainer, whose next step equals the JAX package's next step (f32:
loss rtol 1e-5, parameters 1e-4 relative L2 per leaf, as
``test_torch_train.py`` holds a step), and ``launch/serve.py --ckpt-dir``
serves it and one of the port's own.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import DataIterator as JDataIterator
from repro.models.common import HOST_MESH as JHOST_MESH
from repro.models.model import LM as JLM
from repro.runtime import train_lib as jtrain_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.interop import _flatten, _unstack, checkpoint_source
from repro_torch.launch import serve, train as train_mod
from repro_torch.models.common import HOST_MESH, tree_leaves
from repro_torch.models.model import LM
from repro_torch.runtime.train_lib import (
    abstract_train_state,
    init_train_state,
    make_train_step,
)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.normal(size=(4, 4)), dtype=torch.float32),
            "b": {"c": torch.tensor(rng.normal(size=3), dtype=torch.float32),
                  "l": [torch.tensor(rng.normal(size=2)).bfloat16(),
                        torch.tensor(7, dtype=torch.int32)]}}


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(0)
    mgr.save(10, t, extra={"data": {"step": 10, "seed": 0}})
    step, restored, extra = mgr.restore_latest(_meta(t))
    assert step == 10 and extra["data"]["step"] == 10
    for a, b in zip(tree_leaves(restored), tree_leaves(t), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_layout_is_the_reference_layout(tmp_path):
    CheckpointManager(str(tmp_path)).save(3, _tree(1), extra={"x": 1})
    d = tmp_path / "step_00000003"
    assert sorted(os.listdir(d)) == [".complete", "arrays.npz", "meta.json"]
    with np.load(d / "arrays.npz") as npz:
        assert sorted(npz.files) == ["a", "b/c", "b/l/0", "b/l/1"]
        assert npz["b/l/0"].dtype == np.float32      # bf16 stored as f32
    assert json.loads((d / "meta.json").read_text()) == {
        "step": 3, "extra": {"x": 1}, "treedef": None}
    # the JAX package's manager reads it
    step, tree, _ = JCheckpointManager(str(tmp_path)).restore_latest(
        {"a": np.zeros((4, 4), np.float32), "b": {"c": np.zeros(3)}})
    assert step == 3
    np.testing.assert_array_equal(tree["a"], _tree(1)["a"].numpy())


def test_checkpoint_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_atomic_no_partial(tmp_path):
    """A directory without the commit marker is never listed."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree(1))
    os.makedirs(tmp_path / "step_00000002")   # crash-simulated partial
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert mgr.all_steps() == [1]
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        _tree(1)) == (None, None, None)


def test_restore_places_leaves_where_asked(tmp_path):
    """The port's counterpart of the elastic restore: leaves land on the
    ``like`` leaf's device, or on ``device``, in the ``like`` leaf's
    dtype; a shape or a key that does not match raises."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(3)
    mgr.save(5, t)
    like = {"a": torch.zeros(4, 4, dtype=torch.float64)}
    _, restored, _ = mgr.restore_latest(like)
    assert restored["a"].dtype == torch.float64
    np.testing.assert_array_equal(restored["a"].numpy(), t["a"].numpy())
    _, restored, _ = mgr.restore_latest({"a": torch.zeros(4, 4,
                                                          device="meta")},
                                        device="cpu")
    assert restored["a"].device.type == "cpu"
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(5, {"a": torch.zeros(2, 2)})
    with pytest.raises(KeyError, match="nope"):
        mgr.restore(5, {"nope": torch.zeros(2, 2)})


def test_preemption_flag(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert not mgr.preempted
    mgr.simulate_preemption()
    assert mgr.preempted


def test_checkpoint_source_finds_periods_of_stacked_leaves():
    files = {"params/stack/b0_attn/w", "opt/m/stack/b0_attn/w", "opt/step",
             "params/stack/1/b1_attn/w"}
    src = checkpoint_source
    assert src("params/stack/2/b0_attn/w", files) == (
        "params/stack/b0_attn/w", 2)
    assert src("opt/m/stack/0/b0_attn/w", files) == (
        "opt/m/stack/b0_attn/w", 0)
    assert src("opt/step", files) == ("opt/step", None)
    assert src("params/stack/1/b1_attn/w", files) == (
        "params/stack/1/b1_attn/w", None)
    assert src("opt/v/stack/0/b0_attn/w", files) == (None, None)


def test_restore_reads_a_period_of_a_stacked_leaf(tmp_path):
    d = tmp_path / "step_00000001"
    d.mkdir()
    np.savez(d / "arrays.npz", **{"p/stack/w": np.arange(12.).reshape(3, 4),
                                  "p/x": np.ones(2)})
    (d / "meta.json").write_text('{"step": 1, "extra": {}, "treedef": null}')
    (d / ".complete").write_text("")
    like = {"p": {"x": torch.zeros(2), "stack": [{"w": torch.zeros(4)}
                                                 for _ in range(3)]}}
    _, tree, _ = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert tree["p"]["stack"][2]["w"].tolist() == [8, 9, 10, 11]
    like["p"]["stack"].append({"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="3 periods"):
        CheckpointManager(str(tmp_path)).restore(1, like)


# ---------------------------------------------------------------------------
# Interchange with the JAX package
# ---------------------------------------------------------------------------


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               kv_cache_dtype="float32")


TCFG = dict(lr=2e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two steps of the JAX package's f32 trainer on qwen2-1.5b (smoke),
    checkpointed by its manager; then its third step."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    cfg = _f32(jget_config("qwen2-1.5b", smoke=True))
    jlm = JLM(cfg, JHOST_MESH)
    tcfg = JTrainConfig(**TCFG)
    p, _, o, _ = jtrain_lib.init_train_state(jlm, tcfg, jax.random.key(0))
    step = jax.jit(jtrain_lib.make_train_step(jlm, tcfg, JParallelConfig()))
    data = JDataIterator(cfg, JShapeConfig("t", "train", 16, 4), seed=2)
    for _ in range(2):
        p, o, _ = step(p, o, next(data))
    JCheckpointManager(d).save(2, {"params": p, "opt": o},
                               extra={"data": data.state_dict()})
    batch = next(data)
    p, o, m = step(p, o, batch)
    return d, batch, p, m


def test_a_jax_checkpoint_resumes_in_the_port_and_steps_like_the_reference(
        jax_run):
    d, batch, jp, jm = jax_run
    lm = LM(_f32(get_config("qwen2-1.5b", smoke=True)), HOST_MESH,
            device="cpu")
    tcfg = TrainConfig(**TCFG)
    av, _, ao, _ = abstract_train_state(lm, tcfg)
    like = {"params": av, "opt": ao}
    step, state, extra = CheckpointManager(d).restore_latest(like)
    assert step == 2 and extra["data"] == {"step": 2, "seed": 2}
    assert int(state["opt"]["step"]) == 2
    params, _, opt, _ = init_train_state(lm, tcfg,
                                         torch.Generator().manual_seed(9))
    with torch.no_grad():
        for dst, src in zip(tree_leaves([params, opt]),
                            tree_leaves([state["params"], state["opt"]]),
                            strict=True):
            dst.copy_(src)
    params, opt, m = make_train_step(lm, tcfg, ParallelConfig())(
        params, opt, {k: torch.tensor(np.asarray(v))
                      for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    want = _unstack(jax.tree.map(np.array, jp))
    for path, v in _flatten(params).items():
        rel = np.linalg.norm(v.detach().numpy() - want[path]) / \
            np.linalg.norm(want[path])
        assert rel <= 1e-4, (path, rel)


def test_the_port_trainer_resumes_a_jax_run(tmp_path, capsys):
    """The JAX package's CLI trainer writes two steps (bf16 compute); the
    port's picks them up and takes the third."""
    from repro.launch.train import train as jtrain
    d = str(tmp_path)
    jtrain("qwen2-1.5b", steps=2, batch=2, seq=16, ckpt_dir=d, ckpt_every=2)
    out = train_mod.train("qwen2-1.5b", steps=3, batch=2, seq=16,
                          ckpt_dir=d, ckpt_every=2, device="cpu")
    assert "resumed from step 2" in capsys.readouterr().out
    assert out["step"] == 3 and len(out["losses"]) == 1
    assert np.isfinite(out["losses"][0])
    assert CheckpointManager(d).latest_step() == 3


def _served_values(monkeypatch):
    seen = {}

    class Recording(serve.ServingEngine):
        def __init__(self, lm, values, **kw):
            seen["values"] = {k: v.detach().clone()
                              for k, v in _flatten(values).items()}
            super().__init__(lm, values, **kw)

    monkeypatch.setattr(serve, "ServingEngine", Recording)
    return seen


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_cli_serves_a_checkpoint(writer, jax_run, tmp_path,
                                       monkeypatch, capsys):
    if writer == "jax":
        d, step = jax_run[0], 2
    else:
        d, step = str(tmp_path), 3
        train_mod.train("qwen2-1.5b", steps=3, batch=2, seq=16, ckpt_dir=d,
                        ckpt_every=3, device="cpu")
    seen = _served_values(monkeypatch)
    assert serve.main(["--device", "cpu", "--arch", "qwen2-1.5b",
                       "--requests", "2", "--max-new", "3", "--ckpt-dir",
                       d]) == 0
    out = capsys.readouterr().out
    assert f"serving checkpoint step {step}" in out and "served 2" in out
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as npz:
        for path, v in seen["values"].items():
            src, i = checkpoint_source(
                "params/" + "/".join(map(str, path)), npz.files)
            want = npz[src] if i is None else npz[src][i]
            np.testing.assert_array_equal(v.float().numpy(), want)
