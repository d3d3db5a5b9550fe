"""The port's dry run (``python -m repro_torch.launch.dryrun``).

The JAX package compiles each cell on 512 placeholder devices and reads
XLA's analyses; the port runs its own step on fake tensors under a fake
process group and counts it.  Held here:

* the counts are the real step's: at smoke widths on a (2, 2) mesh the
  fake run's collectives (calls and bytes by op and axis), flops and
  argument and output bytes equal those of the same step run for real on
  four gloo ranks (with ``FlopCounterMode``) — a train step (qwen2 with
  FSDP and int8_ef; granite, whose MoE block takes the expert-parallel
  branch), a prefill and zamba2's sequence-sharded decode;
* the record has the reference's keys, and its config-only fields
  (``model_params``, ``active_params``, ``n_layers``, ``fsdp``,
  ``unrolled``) and the probe's ``model_flops`` equal the JAX package's
  for every arch and shape;
* both CLIs name the same cells with the same tags and skip the same
  ones (``--all --mesh both`` over an output directory that holds every
  cell already, so neither compiles nor runs anything).

Each dry run opens a fake default group, so it runs in a spawned process
(``_torch_dist.run_alone``); the real steps run on spawned gloo ranks.
"""
import dataclasses
import importlib
import os
import sys

import pytest

import _torch_dist as W
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import shape_cells as jshape_cells
from repro.configs.base import SHAPES as JSHAPES
from repro.runtime.sharding import default_parallel as jdefault_parallel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ParallelConfig, ShapeConfig
from repro_torch.launch import dryrun, roofline_probe
from repro_torch.runtime.sharding import default_parallel

#: the reference record's keys; its memory-analysis keys (temp, argument,
#: output and generated-code sizes) come only where XLA gives them
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "ok", "compile_seconds", "flops",
    "bytes_accessed", "collective_bytes", "collective_count",
    "collective_detail", "model_params", "active_params", "n_layers",
    "unrolled", "fsdp"}


def _smoke(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


CASES = {
    "qwen2 train, FSDP + int8_ef": dict(
        cfg=_smoke("qwen2-1.5b"), shape=ShapeConfig("t", "train", 16, 4),
        pcfg=ParallelConfig(fsdp=True, grad_compression="int8_ef")),
    "granite train, expert parallel": dict(
        cfg=_smoke("granite-moe-3b-a800m"),
        shape=ShapeConfig("t", "train", 16, 4), pcfg=ParallelConfig()),
    "qwen2 prefill": dict(
        cfg=_smoke("qwen2-1.5b"), shape=ShapeConfig("p", "prefill", 32, 4),
        pcfg=ParallelConfig()),
    "zamba2 long decode, sequence-sharded": dict(
        cfg=_smoke("zamba2-1.2b"), shape=ShapeConfig("l", "decode", 64, 1),
        pcfg=ParallelConfig()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_fake_run_counts_what_the_real_step_does(case, tmp_path):
    kwargs = dict(CASES[case], mesh_shape=(2, 2))
    arch = {"qwen2": "qwen2-1.5b", "granite": "granite-moe-3b-a800m",
            "zamba2": "zamba2-1.2b"}[case.split()[0]]
    rec = W.run_alone(W.dry_cell, dict(kwargs, arch=arch,
                                       shape_name=kwargs["shape"].name,
                                       multi_pod=False))
    assert REFERENCE_KEYS <= set(rec), REFERENCE_KEYS - set(rec)
    assert (rec["mesh"], rec["chips"], rec["ok"]) == ("2x2", 4, True)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collective_count"] == sum(
        v["calls"] for v in rec["collectives"].values())
    if case.startswith("granite"):
        assert rec["collectives"]["all_to_all over model"]["calls"] > 0
    if "decode" in case:     # the cache's sequence axis over data
        assert rec["collectives"]["all_reduce over data"]["calls"] > 0
    W.run_group(W.real_cell, 4, tmp_path, kwargs, rec)


def _jax_launch_module(name):
    """``repro.launch.<name>``, which sets ``XLA_FLAGS`` for 512 host
    devices as it is imported; the variable is restored at once, so this
    process's JAX keeps its own device count (neither CLI below touches a
    device)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def test_config_fields_and_model_flops_equal_the_jax_packages():
    assert ARCH_IDS == JARCH_IDS
    jprobe = _jax_launch_module("roofline_probe")
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        pcfg, jpcfg = default_parallel(arch), jdefault_parallel(arch)
        for unroll in (False, True):
            assert dryrun.config_fields(cfg, pcfg, unroll) == {
                "model_params": jcfg.param_count(),
                "active_params": jcfg.active_param_count(),
                "n_layers": jcfg.n_layers, "unrolled": unroll,
                "fsdp": jpcfg.fsdp}
        for name in SHAPES:
            assert roofline_probe.model_flops(cfg, SHAPES[name]) == \
                jprobe.model_flops(jcfg, JSHAPES[name])
            assert dataclasses.asdict(roofline_probe.probe_config(
                cfg, 2, SHAPES[name].seq_len)) == dataclasses.asdict(
                    jprobe.probe_config(jcfg, 2, JSHAPES[name].seq_len))


def _cli(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", argv)
    main()
    return capsys.readouterr().out


def test_both_clis_name_and_skip_the_same_cells(tmp_path, monkeypatch,
                                                capsys):
    dirs = {}
    for what in ("dryrun", "roofline"):
        d = dirs[what] = tmp_path / what
        d.mkdir()
        for arch in JARCH_IDS:
            for s in jshape_cells(arch):
                meshes = ("pod", "multipod") if what == "dryrun" else ("",)
                for m in meshes:
                    tag = f"{arch}__{s.name}" + (f"__{m}" if m else "")
                    (d / f"{tag}.json").write_text("{}")
    jdry = _jax_launch_module("dryrun")
    jprobe = _jax_launch_module("roofline_probe")
    for main, jmain, what, extra in (
            (dryrun.main, jdry.main, "dryrun", ["--mesh", "both"]),
            (roofline_probe.main, jprobe.main, "roofline", [])):
        for cells in (["--all"], ["--arch", "qwen2-7b", "--shape",
                                  "long_500k"]):
            argv = ["prog", *cells, "--out", str(dirs[what]), *extra]
            got = _cli(main, argv, monkeypatch, capsys)
            assert got == _cli(jmain, argv, monkeypatch, capsys), argv
            assert "RUN" not in got and "PROBE" not in got
            if cells == ["--all"]:
                assert got.count("CACHED") == len(list(dirs[what]
                                                       .iterdir()))
            elif what == "dryrun":
                assert got.startswith("SKIP qwen2-7b x long_500k")
