"""The port's deployment planning against the JAX package's, on the CPU.

``footprint`` gives the same integers for every arch, and
``plan_deployment`` on the ``analytic-tpu`` backend writes the same JSON,
byte for byte, over the JAX package's machine zoo.  The port's own
``cuda`` backend prices every arch on ``h100``; its decode-state bytes are
exactly the bytes of the port's caches; and the CLIs print the JAX
package's text.
"""
import io
import json
import os
import re
from contextlib import redirect_stdout

import pytest
import torch

from repro import machines as jmachines
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.serving import __main__ as jcli
from repro.serving.footprint import footprint as jfootprint
from repro.serving.report import plan_deployment as jplan_deployment
from repro_torch import machines
from repro_torch.configs import get_config
from repro_torch.models.model import LM
from repro_torch.serving import __main__ as cli
from repro_torch.serving.footprint import footprint
from repro_torch.serving.report import (REJECT_WEIGHTS, CellRejection,
                                        plan_deployment)

MEASURED_JSON = os.path.join(os.path.dirname(machines.__file__), "zoo",
                             "h100-measured.json")


def _jax_zoo():
    """The JAX package's zoo: ``zoo/*`` there; the port's zoo holds these
    and the card's manifests besides."""
    names = jmachines.list_machines()
    assert set(names) <= set(machines.list_machines())
    return names


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_footprint_is_the_jax_packages_to_the_byte(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for batch in (1, 4, 16):
        for dtype in ("bf16", "int8"):
            for max_len in (512, 4096):
                got = footprint(cfg, batch=batch, max_len=max_len,
                                dtype=dtype)
                want = jfootprint(jcfg, batch=batch, max_len=max_len,
                                  dtype=dtype)
                assert got.as_dict() == want.as_dict()
                assert got.total_bytes == want.total_bytes


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-1.2b", "xlstm-125m",
                                  "kimi-k2-1t-a32b", "paligemma-3b"])
def test_plan_deployment_json_is_byte_equal_on_analytic_tpu(arch, tmp_path):
    kw = dict(dtypes=("bf16", "int8"), batches=(1, 2, 4, 8, 16),
              max_len=2048, backend="analytic-tpu",
              precisions=("int8xint8",))
    want = jplan_deployment(jget_config(arch), machines="zoo/*", **kw)
    got = plan_deployment(get_config(arch), machines=_jax_zoo(), **kw)
    jpath, path = tmp_path / "jax.json", tmp_path / "port.json"
    want.save(str(jpath))
    got.save(str(path))
    assert path.read_bytes() == jpath.read_bytes()
    assert got.table() == want.table()
    if arch == "kimi-k2-1t-a32b":
        # a trillion parameters fit no machine of the zoo
        assert not got.options and got.rejected
        assert all(isinstance(r, CellRejection) for r in got.rejected)
        assert {r.reason for r in got.rejected} == {REJECT_WEIGHTS}


def test_plan_deployment_prices_every_arch_on_the_card():
    """On ``cuda`` with ``h100``: every arch but kimi-k2-1t has a feasible
    cell; kimi-k2-1t's weights alone exceed the card's memory."""
    budget = machines.get("h100").memory_budget()
    for arch in ARCH_IDS:
        rep = plan_deployment(get_config(arch), machines="h100",
                              backend="cuda", dtypes=("bf16", "int8"),
                              batches=(1, 4, 16), max_len=4096)
        assert rep.grid["machines"] == ["h100"]
        if arch == "kimi-k2-1t-a32b":
            assert not rep.options
            assert {r.reason for r in rep.rejected} == {REJECT_WEIGHTS}
            assert all(r.budget_bytes == budget for r in rep.rejected)
            with pytest.raises(ValueError, match="weights_exceed_budget"):
                rep.best()
            continue
        assert rep.options, arch
        best = rep.select()
        assert best.machine == "h100" and best.dtype == "bf16"
        assert all(o.footprint.fits(budget) for o in rep.options)
        assert all(o.seconds_per_step > 0 for o in rep.options)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m", "paligemma-3b",
                                  "musicgen-medium", "granite-moe-3b-a800m",
                                  "qwen2-7b"])
@pytest.mark.parametrize("kv", ["bfloat16", "float32", "int8"])
def test_footprint_state_bytes_are_the_bytes_of_the_caches(arch, kv):
    """The footprint charges the cache layouts ``LM.init_cache`` makes:
    its decode-state bytes equal the caches' bytes exactly."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32" if kv == "float32"
                              else "bfloat16", kv_cache_dtype=kv)
    tag = {"bfloat16": "bf16", "float32": "f32", "int8": "bf16"}[kv]
    lm = LM(cfg, device="cpu")
    for batch, max_len in ((1, 16), (3, 40)):
        caches = lm.init_cache(batch, max_len)
        leaves = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            elif isinstance(t, list):
                for v in t:
                    walk(v)
            else:
                leaves.append(t)
        walk(caches)
        have = sum(t.numel() * t.element_size() for t in leaves)
        fp = footprint(cfg, batch=batch, max_len=max_len, dtype=tag)
        assert fp.kv_cache_bytes == have


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["plan", "--arch", "zamba2-1.2b", "--machine", "zoo/*", "--backend",
     "analytic-tpu", "--max-len", "4096", "--limit", "20"],
    ["plan", "--arch", "qwen2-1.5b", "--smoke", "--backend", "analytic-tpu",
     "--precision", "int8xint8"],
    ["plan", "--arch", "kimi-k2-1t-a32b", "--machine", "tpu-v5e",
     "--backend", "analytic-tpu"],
    ["footprint", "--arch", "xlstm-125m", "--batch", "16", "--max-len",
     "4096", "--dtype", "int8"],
    ["footprint", "--arch", "paligemma-3b"],
], ids=["plan-zoo", "plan-smoke", "plan-rejected", "footprint-int8",
        "footprint"])
def test_cli_prints_the_jax_packages_text(argv, tmp_path):
    if argv[0] == "plan":
        argv = argv + ["--json", str(tmp_path / "x.json")]
    if "zoo/*" in argv:
        # the port's zoo also holds the card's manifests
        i = argv.index("zoo/*")
        got = _run(cli.main, argv[:i] + _jax_zoo() + argv[i + 1:])
    else:
        got = _run(cli.main, argv)
    want = _run(jcli.main, argv)
    assert got == want


def test_cli_plans_on_the_card_by_default():
    rc, out = _run(cli.main, ["plan", "--arch", "zamba2-1.2b", "--batches",
                              "1", "4"])
    assert rc == 0
    assert re.search(r"^1\s+h100\s+bf16\s+4\s", out, re.M), out
    assert "selected: h100 dtype=bf16 max_batch=4" in out


def test_measured_manifest_validates_and_names_its_chip_runs():
    spec = machines.MachineSpec.from_manifest(MEASURED_JSON)
    spec.validate()
    prov = spec.provenance
    assert prov.get("uncalibrated") is not True
    assert "chip_smoke.py" in json.dumps(prov)
    assert len(prov["chip_runs"]) >= 2
    assert prov["commit"]
    # the same card: geometry of the data sheet, rates of the fit
    sheet = machines.get("h100")
    assert spec.geometry_fingerprint() == sheet.geometry_fingerprint()
    assert set(spec.arith_rate) == set(sheet.arith_rate)
    assert set(prov["spread"]) >= {"arith:bf16", "arith:int8", "arith:f32",
                                   "rate:M->L2", "call:launch"}
    assert machines.get("h100-measured").fingerprint() == spec.fingerprint()
    # it plans: zamba2 on the fitted card
    rep = plan_deployment(get_config("zamba2-1.2b"),
                          machines="h100-measured", backend="cuda",
                          batches=(4,), max_len=4096)
    assert rep.options and rep.options[0].machine == "h100-measured"
    assert torch.isfinite(torch.tensor(rep.options[0].tokens_per_second))
