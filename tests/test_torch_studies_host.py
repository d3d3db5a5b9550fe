"""The port's host campaign study and table renderer against the JAX
package's.

``experiments/host_campaign_study_torch.py`` measures on this host, so its
numbers are the host's: it must print the JAX study's structure (the
output committed in EXPERIMENTS.md with every number, path and host-
dependent list masked), with the same campaigns and sample counts, and a
fitted table whose columns and the free ones are the template's six.  The
test times one call a sample (the study's timing settings change the
numbers, not the structure).  ``render_tables_torch`` renders the same
tables as ``render_tables`` from the same records.
"""
import json
import os
import re

import pytest
from test_torch_studies import ROOT, load

NUMBER = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")


def _skeleton(lines):
    """The lines with numbers, the free columns' list, the fitted table's
    rows, the overhead refit's finding and the store's path masked."""
    out = []
    for line in lines:
        if line.startswith("| `"):
            continue                           # a fitted column's row
        line = re.sub(r"\[[^\]]*\]$", "[...]", line)
        line = re.sub(r"refit on the same samples: .*; in-sample",
                      "refit on the same samples: ...; in-sample", line)
        line = re.sub(r"under `[^`]*`", "under `...`", line)
        out.append(NUMBER.sub("#", line))
    return out


def _committed():
    with open(os.path.join(ROOT, "EXPERIMENTS.md")) as f:
        text = f.read().splitlines()
    start = next(i for i, line in enumerate(text)
                 if line.startswith("- campaigns: `table2`"))
    end = next(i for i in range(start, len(text))
               if text[i].startswith("- store + fitted manifest"))
    return text[start:end + 1]


def test_host_campaign_has_the_jax_studys_structure(tmp_path, monkeypatch):
    from repro_torch.measure import harness

    inner = harness.time_callable
    monkeypatch.setattr(harness, "time_callable", lambda fn, **kw: inner(
        fn, **{**kw, "warmup": 0, "rounds": 1, "max_rounds": 1}))
    got = load("host_campaign_study", "_torch").run(str(tmp_path))
    want = _committed()
    assert _skeleton(got) == _skeleton(want)
    assert got[0] == want[0]                     # campaigns and samples
    free = re.search(r"\[(.*)\]$", got[1])
    free = set(re.findall(r"'([^']+)'", free.group(1))) if free else set()
    fitted = {re.match(r"\| `([^`]+)`", line).group(1)
              for line in got if line.startswith("| `")}
    assert not free & fitted and free | fitted == {
        "rate:M->M", "rate:M->L2", "rate:M->L1", "rate:M->R", "rate:L2->R",
        "rate:L1->R", "arith:f32"}
    assert os.path.exists(tmp_path / "host.jsonl")


DRYRUN = [
    {"arch": "qwen2-1.5b", "shape": "train_4k", "mesh": "16x16",
     "compile_seconds": 1.9, "flops": 3.2e13, "collective_bytes": 4.1e9,
     "argument_size_in_bytes": 2.4e10},
    {"arch": "zamba2-1.2b", "shape": "long_500k", "mesh": "2x16x16",
     "compile_seconds": 2.2, "flops": 1.1e11, "collective_bytes": 3.0e6,
     "temp_size_in_bytes": 5e9, "argument_size_in_bytes": 1.3e9},
]
ROOFLINE = [
    {"arch": "qwen2-1.5b", "shape": "train_4k", "t_compute_s": 0.031,
     "t_memory_s": 1.02, "t_collective_s": 0.4, "dominant": "memory",
     "useful_flop_ratio": 0.93, "roofline_fraction": 0.0301},
    {"arch": "granite-moe-3b-a800m", "shape": "decode_32k",
     "t_compute_s": 0.0005, "t_memory_s": 0.012, "t_collective_s": 0.02,
     "dominant": "collective", "useful_flop_ratio": 0.5,
     "roofline_fraction": 0.02},
]


def _write(root, subdir, records):
    os.makedirs(root / subdir)
    for i, r in enumerate(records):
        with open(root / subdir / f"r{i}.json", "w") as f:
            json.dump(r, f)


@pytest.mark.parametrize("which", ["dryrun", "roofline"])
def test_render_tables_renders_the_jax_tables(tmp_path, which):
    jax_mod, torch_mod = load("render_tables"), load("render_tables", "_torch")
    jax_mod.HERE = torch_mod.HERE = str(tmp_path)
    if which == "dryrun":
        _write(tmp_path, "dryrun", DRYRUN)
        _write(tmp_path, "dryrun_torch", DRYRUN)
        assert torch_mod.dryrun_table() == jax_mod.dryrun_table()
    else:
        for sub, recs in (("roofline", ROOFLINE),
                          ("roofline_baseline", ROOFLINE[:1])):
            _write(tmp_path, sub, recs)
            _write(tmp_path, sub.replace("roofline", "roofline_torch"), recs)
        assert torch_mod.roofline_table() == jax_mod.roofline_table()
        assert torch_mod.roofline_table("roofline_torch_baseline") == \
            jax_mod.roofline_table("roofline_baseline")
    assert len(torch_mod.dryrun_table().splitlines()
               if which == "dryrun" else
               torch_mod.roofline_table().splitlines()) == 4
