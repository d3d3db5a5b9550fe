"""On the card: each cell runs through the command's own entry for a short
window, traced and not, and comes out correct with a result line of the
result line's keys.  Skips on a host without a card."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_cell_runs_on_the_card(cuda_device, name):
    for trace in ("0", "1"):
        r = subprocess.run(
            [sys.executable, os.path.join(harness.HERE, "run.py"),
             "--workload", name, "--seed", str(2**31 + 3), "--seconds", "2",
             "--trace", trace], capture_output=True, text=True,
            cwd=harness.ROOT, timeout=1500)
        assert r.returncode == 0, r.stderr[-3000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        assert line["device"]["platform"] == "gpu"
