"""A configuration, a traffic mix, a metric and a cell are added as files
and entries alone: the harness finds each by its name and runs the new
cell, with no edit to any file it already has."""
import json
import time

import torch

from perfbench import harness


def test_a_cell_added_as_files_runs(tmp_path, monkeypatch):
    root, here = tmp_path, tmp_path / "perfbench"
    for d in ("configs", "traffic", "metrics", "limits"):
        (here / d).mkdir(parents=True)
    (here / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "reduced": [], "products": [
            {"name": "up", "rows": "tokens", "n": 40, "k": 24, "count": 2},
            {"name": "head", "rows": "tokens", "n": 33, "k": 24,
             "count": 1, "layout": "tied"}]}))
    (here / "traffic" / "gemm-16.json").write_text(json.dumps({
        "driver": "gemm_pass", "dtype": "bf16", "tokens": 16,
        "warmup_seconds": 0.0, "inflight_passes": 2, "sample_passes": 2}))
    (here / "metrics" / "passes.count.py").write_text(
        "def read(rec):\n    return float(rec['passes'])\n")
    (here / "metrics" / "silent.py").write_text(
        "def read(rec):\n    return None\n")
    (here / "limits" / "tiny.gemm-16.json").write_text(json.dumps(
        {"checks": {"rel_l2": {"limit": 0.01}}}))
    bench = {
        "configs": [{"name": "tiny", "source": "test", "reduced": [],
                     "file": "perfbench/configs/tiny.json", "why": "test"}],
        "workloads": [{"name": "tiny.gemm-16", "config": "tiny",
                       "traffic": "gemm-16", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "gemm_tops", "unit": "TOP/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "passes.count", "unit": "1"},
                      {"name": "silent", "unit": "%"}]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(here))
    cell = harness.load_cell("tiny.gemm-16")
    for trace in (False, True):
        line = harness.run_cell(cell, 3, 0.05, trace, torch.device("cpu"),
                                time.perf_counter())
        assert line["correct"]
        names = set(line["metrics"])
        assert names == ({"passes.count"} if trace
                         else {"gemm_tops", "setup_s"})
