"""``python -m repro_torch.obs`` against ``python -m repro.obs``.

Both CLIs run in this process (``main(argv)``) over the same saved
``repro.serving/trace-v1`` JSON: one the port's engine wrote serving
qwen2-1.5b at its smoke size on the CPU, and copies of it whose
predicted step time makes the drift verdict warn or stale.  ``report``
and ``drift`` print the same text (their JSON), ``export`` writes the
same Chrome-trace JSON and prints the same line, the exit codes are the
same (``drift --strict`` exits 3 when the verdict is not ok), and a file
that is not a serving trace stops both with the same message.
"""
import json

import pytest

from repro.obs import __main__ as jobs_cli
from repro_torch.launch.serve import serve_demo
from repro_torch.obs import __main__ as obs_cli


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """{name: path}: the engine's trace and two copies with a predicted
    step time that makes the drift warn or stale."""
    root = tmp_path_factory.mktemp("obs_cli")
    path = root / "served.json"
    serve_demo("qwen2-1.5b", smoke=True, n_requests=8, max_new=8,
               trace_path=str(path), device="cpu")
    doc = json.loads(path.read_text())
    steps = sorted(e["dt"] for e in doc["events"]
                   if e.get("type") == "step" and "dt" in e)
    assert len(steps) >= 8, len(steps)
    median = steps[len(steps) // 2]
    out = {"served": path}
    for name, ratio in (("warn", 1.15), ("stale", 3.0)):
        p = root / f"{name}.json"
        p.write_text(json.dumps({**doc, "predicted_step_s": median / ratio}))
        out[name] = p
    bad = root / "not_a_trace.json"
    bad.write_text(json.dumps({"schema": "something/else"}))
    out["bad"] = bad
    return out


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("trace", ["served", "warn", "stale"])
@pytest.mark.parametrize("argv", [
    ["report"],
    ["report", "--warn-drift", "0.05", "--max-drift", "0.5",
     "--min-samples", "4"],
    ["drift"],
    ["drift", "--strict"],
    ["drift", "--strict", "--max-drift", "5.0", "--min-samples", "2"],
])
def test_report_and_drift_are_the_reference_text_and_exit_code(
        traces, trace, argv, capsys):
    args = argv[:1] + ["--trace", str(traces[trace])] + argv[1:]
    want_rc, want = _run(jobs_cli, args, capsys)
    got_rc, got = _run(obs_cli, args, capsys)
    assert got == want and got_rc == want_rc
    assert json.loads(got) == json.loads(want)
    if argv == ["drift", "--strict"]:
        status = json.loads(got)["status"]
        assert got_rc == (0 if status == "ok" else 3), status
        assert status == {"served": status, "warn": "warn",
                          "stale": "stale"}[trace]


def test_export_writes_the_reference_chrome_trace(traces, tmp_path, capsys):
    outs = {}
    for name, cli in (("jax", jobs_cli), ("torch", obs_cli)):
        out = tmp_path / f"{name}.json"
        rc, text = _run(cli, ["export", "--trace", str(traces["served"]),
                              "--out", str(out)], capsys)
        assert rc == 0
        outs[name] = (text.replace(str(out), "OUT"),
                      json.loads(out.read_text()))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1]["traceEvents"]


@pytest.mark.parametrize("cmd", ["report", "drift"])
def test_a_file_without_events_stops_both_alike(traces, cmd):
    msgs = []
    for cli in (jobs_cli, obs_cli):
        with pytest.raises(SystemExit) as err:
            cli.main([cmd, "--trace", str(traces["bad"])])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "not a serving trace" in msgs[0]
