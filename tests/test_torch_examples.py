"""The port's example drivers (``examples/*_torch.py``) on the CPU.

Each driver's ``main`` runs with ``--device cpu`` at a small size, loaded
from its file as the README runs it.  quickstart's sections 1-2 print the
lines the same ``repro.gemm`` calls give in the JAX package (made here;
the JAX quickstart's training is not run); autotune_explore's GAP8,
machine-zoo and TPU sections print the JAX example's lines, and its
chosen ``cuda`` plan runs against its plain version; serve_batch serves
a dense and a MoE arch; train_e2e, stopped by SIGTERM (its emergency
checkpoint) and run again, gives the uninterrupted run's losses and
parameters bit for bit.
"""
import importlib.util
import io
import os
import signal
import sys
from contextlib import redirect_stdout

import pytest
import torch

from repro_torch.models.common import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _load(name, where="examples"):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(ROOT, where, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def _jax_quickstart_lines():
    """Sections 1-2 of ``examples/quickstart.py``, from the JAX package."""
    from repro import gemm
    from repro.core import Variant

    lines = ["=== 1. Paper simulator: MobileNetV1 layer #10 GEMM on GAP8 ===",
             f"  backends: {gemm.backends()}"]
    for v in Variant:
        cb = gemm.plan((256, 784, 2304), backend="analytic-gap8",
                       variant=v).estimate()
        lines.append(f"  {v.value}: best micro-kernel {cb.micro_kernel}, "
                     f"estimated {cb.total:.3f}s "
                     f"(arith {cb.arith:.3f}s, transfers {cb.transfer:.3f}s)")
    d = gemm.plan((4096, 18944, 3584), backend="analytic-tpu")
    lines += ["", "=== 2. TileTuner: a transformer MLP GEMM on TPU v5e ===",
              f"  tile {d.selection} -> predicted "
              f"{d.predicted_seconds*1e6:.0f}us, "
              f"{d.cost.roofline_fraction():.1%} of roofline "
              f"(paper-mode/no-overlap would be "
              f"{d.cost.total_no_overlap*1e6:.0f}us)"]
    return lines


def test_quickstart_on_the_cpu():
    out = _run(_load("quickstart_torch").main, ["--device", "cpu",
                                                "--steps", "2"])
    want = _jax_quickstart_lines()
    # the backends line names the port's own backends
    assert out[0] == want[0] and out[1].startswith("  backends: [")
    assert "'cuda'" in out[1] and "'analytic-gap8'" in out[1]
    assert out[2:len(want)] == want[2:]
    assert "  execute(ones, halves)[0,0] = 128.0 (expect 128.0) on cpu" in out
    assert any(line.startswith("GemmPlan[cuda@h100] 256x256x256:bf16", 2)
               for line in out)
    served = [line for line in out if line.startswith("  request ")]
    assert len(served) == 3 and out[-1] == "quickstart done."


def test_autotune_explore_on_the_cpu():
    argv = ["--m", "300", "--n", "500", "--k", "400"]
    out = _run(_load("autotune_explore_torch").main, argv + ["--device",
                                                            "cpu"])
    old = sys.argv
    sys.argv = ["autotune_explore.py"] + argv
    try:
        want = _run(lambda _: _load("autotune_explore").main(), None)
    finally:
        sys.argv = old
    # everything up to the TPU section's pick is the JAX example's
    upto = next(i for i, line in enumerate(want) if "chosen:" in line) + 1
    assert out[:upto] == want[:upto]
    hopper = out.index("--- H100: the Hopper tile model over the cuda "
                       "backend's lattice ---")
    assert len([line for line in out[hopper:] if "route=" in line]) == 5
    assert any("kernel vs plain max|err| = 0.00e+00 on 300x500x400 bf16"
               in line and line.endswith("ok)") for line in out)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_serve_batch_on_the_cpu(arch):
    out = _run(_load("serve_batch_torch").main,
               ["--device", "cpu", "--arch", arch, "--requests", "3",
                "--max-new", "4"])
    assert any(line.startswith("served 3 requests, 12 tokens in")
               and line.endswith("on cpu") for line in out), out
    assert len([line for line in out if line.startswith("  req")]) == 3


def test_train_e2e_resumes_bit_exactly(tmp_path, monkeypatch):
    """8 steps uninterrupted; against 8 steps stopped by SIGTERM after the
    5th (the emergency checkpoint) and the same command run again."""
    import repro_torch.launch.train as launch_train

    mod = _load("train_e2e_torch")
    runs = []

    def recording(*args, **kwargs):
        runs.append(launch_train.train(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(mod, "train", recording)
    argv = ["--device", "cpu", "--steps", "8"]
    previous = signal.getsignal(signal.SIGTERM)
    try:
        _run(mod.main, argv + ["--ckpt-dir", str(tmp_path / "whole")])
        make = launch_train.make_train_step

        def stopped_after_five(*args, **kwargs):
            step = make(*args, **kwargs)
            done = [0]

            def once(*a, **kw):
                out = step(*a, **kw)
                done[0] += 1
                if done[0] == 5:
                    signal.raise_signal(signal.SIGTERM)
                return out
            return once

        monkeypatch.setattr(launch_train, "make_train_step",
                            stopped_after_five)
        killed = _run(mod.main, argv + ["--ckpt-dir", str(tmp_path / "kill")])
        monkeypatch.setattr(launch_train, "make_train_step", make)
        resumed = _run(mod.main, argv + ["--ckpt-dir",
                                         str(tmp_path / "kill")])
    finally:
        signal.signal(signal.SIGTERM, previous)
    whole, first, second = runs
    assert "preempted: emergency checkpoint at step 5" in killed
    assert "resumed from step 5" in resumed
    assert first["preempted"] and first["step"] == 5
    assert second["step"] == 8 and not second["preempted"]
    assert first["losses"] + second["losses"] == whole["losses"]
    for a, b in zip(tree_leaves(whole["params"]),
                    tree_leaves(second["params"]), strict=True):
        assert torch.equal(a, b)
