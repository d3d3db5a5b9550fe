"""``perfbench/spans.py``, the reading of the program's spans over a cell:
``by_span`` on stand-in profiler events, the benchmark's reduction of the
same events without the spans' ranges, the host record by span, the
collections counted with no object kept, and the tool over each cell at a
test's size on the CPU.  On the card: the training step's phase spans
hold its device time, and the int8 pass's copy spans what the copy
kernels take by name."""
import gc

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import harness, spans, tracing
from perfbench.tests.test_perfbench_faults import shrink


class Ev:
    """A stand-in for one of the profiler's events (times in ns; ``thread``
    names the host thread, which the reading does not look at)."""

    def __init__(self, name, start, dur, *, dev=False, corr=0, thread=1):
        self._name, self._start, self._dur = name, start, dur
        self._dev, self._corr = dev, corr
        self.thread = thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def correlation_id(self):
        return self._corr


def events():
    """A window [0, 1100) over three phase spans on the step's thread
    (1), a copy span inside the forward, launches from the step's thread
    and from autograd's (2), one by the driver's call, one launched
    outside every span, and the spans' mirrors on the device's
    timeline."""
    return [
        Ev("perfbench.window", 0, 1100),
        Ev("train.forward", 0, 300, corr=101),
        Ev("gemm.copy", 50, 100, corr=102),
        Ev("train.backward", 300, 400, corr=103),
        Ev("train.optimizer", 700, 300, corr=104),
        # a host operation whose id is a runtime call's correlation id too
        Ev("aten::add_", 800, 20, corr=1),
        Ev("cuLaunchKernelEx", 750, 5, corr=3),
        Ev("cudaLaunchKernel", 200, 5, corr=1),
        Ev("cudaLaunchKernel", 60, 5, corr=4),
        Ev("cudaLaunchKernel", 400, 5, corr=2, thread=2),
        Ev("cudaLaunchKernel", 1050, 5, corr=5),
        Ev("k_forward", 120, 100, dev=True, corr=1),
        Ev("k_copy", 230, 50, dev=True, corr=4),
        Ev("k_backward", 420, 200, dev=True, corr=2),
        Ev("k_optimizer", 760, 140, dev=True, corr=3),
        Ev("k_outside", 1060, 20, dev=True, corr=5),
        Ev("train.forward", 120, 160, dev=True),
        Ev("gemm.copy", 230, 50, dev=True),
        Ev("perfbench.window", 120, 960, dev=True),
    ]


NAMES = {"train.forward", "train.backward", "train.optimizer", "gemm.copy"}


def test_device_and_idle_time_go_to_the_innermost_span_on_any_thread():
    got = spans.by_span(events(), ("train.",), {"gemm.copy"})
    # busy: [120, 220), [230, 280), [420, 620), [760, 900), [1060, 1080)
    want = {"train.forward": (150, 120 + 10, 2),
            "train.backward": (200, 140 + 140, 1),
            "train.optimizer": (140, 160, 1),
            spans.NO_SPAN: (20, 20, 1)}
    assert set(got) == set(want)
    for name, (dev, idle, ops) in want.items():
        assert got[name]["device_s"] == pytest.approx(dev * 1e-9)
        assert got[name]["idle_s"] == pytest.approx(idle * 1e-9)
        assert got[name]["device_ops"] == ops


def test_a_nested_span_among_the_prefixes_takes_its_own_launches():
    got = spans.by_span(events(), ("train.", "gemm."))
    assert got["gemm.copy"]["device_s"] == pytest.approx(50e-9)
    # the gap [0, 120) has its midpoint in the copy span
    assert got["gemm.copy"]["idle_s"] == pytest.approx(120e-9)
    assert got["train.forward"]["device_s"] == pytest.approx(100e-9)
    assert got["train.forward"]["idle_s"] == pytest.approx(10e-9)


class _Traced:
    """What :func:`spans.traced_record` reads of a ``Trace`` and of a
    ``Spans``."""
    events = events()
    names = NAMES


def test_the_traced_record_reduces_without_the_programs_ranges():
    got = spans.traced_record(_Traced, _Traced, "train")
    plain = tracing.reduce([e for e in events() if e.name() not in NAMES])
    assert got.pop("spans") == spans.by_span(events(), ("train.",
                                                        "python.gc"), NAMES)
    assert got == plain
    assert not set(plain["kernels"]) & NAMES
    assert plain["busy_s"] == pytest.approx((100 + 50 + 200 + 140 + 20)
                                            * 1e-9)


class S:
    """A stand-in for one of ``obs``'s spans."""

    def __init__(self, sid, name, t0, t1, parent=None, **attrs):
        self.sid, self.name, self.t0, self.t1 = sid, name, t0, t1
        self.parent, self.attrs = parent, attrs


def test_the_host_record_counts_a_collection_once_and_apart():
    got = spans.program_record([
        S(0, "gemm.matmul", 0.0, 1.0),
        S(1, "gemm.plan_many", 0.1, 0.3, 0),
        S(2, "python.gc", 0.15, 0.2, 1, generation=0),
        S(3, "gemm.copy", 0.4, 0.5, 0), S(4, "gemm.matmul", 2.0, 2.5),
        S(5, "gemm.plan_many", 2.1, 2.2, 4),
        S(6, "python.gc", 3.0, 3.25, generation=2),
        S(7, "gemm.matmul", 4.0, None)])
    mm, plan = got["spans"]["gemm.matmul"], got["spans"]["gemm.plan_many"]
    assert mm["count"] == 2 and mm["seconds"] == pytest.approx(1.5)
    # less the plan and copy spans under it
    assert mm["self_s"] == pytest.approx(1.5 - 0.3 - 0.1)
    assert mm["gc_s"] == plan["gc_s"] == pytest.approx(0.05)
    assert plan["self_s"] == pytest.approx(0.3 - 0.05)
    assert got["gc"] == {"count": {"0": 1, "2": 1},
                         "seconds": pytest.approx(0.3)}


def test_collections_are_counted_by_the_hook_and_the_stats_alike():
    hooks = list(gc.callbacks)
    with spans.Collections() as col:
        gc.collect()
    got = col.record()
    assert gc.callbacks == hooks
    assert got["stats"]["2"] >= 1 and got["count"] == got["stats"]
    assert got["seconds"] > 0
    with spans.Collections(hook=False) as col:
        gc.collect()
    assert set(col.record()) == {"stats"}


@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_the_tool_reads_each_cells_spans_on_the_cpu(name):
    from repro_torch import obs
    cell = shrink(harness.load_cell(name))
    out = spans.run(cell, 2**31 + 9, 0.05, 2, torch.device("cpu"))
    assert not obs.enabled() and not obs.recorder.spans
    assert out["workload"] == name
    plain, tail, traced = out["plain"], out["tail"], out["traced"]
    assert "spans" not in plain and set(plain["gc"]) >= {"stats", "count"}
    if cell.traffic["driver"] == "train":
        assert plain["steps"] == tail["steps"] == 2
        assert traced["steps"] == spans.TRACE_STEPS
        want = {"train.forward", "train.backward", "train.optimizer"}
    else:
        assert traced["passes"] == spans.TRACE_PASSES
        want = {"gemm.matmul", "gemm.plan_many"}
        if "granite" in name:
            want.add("gemm.grouped_matmul")
    assert want <= set(tail["spans"])
    for span in want:
        assert tail["spans"][span]["count"] >= 2
    assert tail["gc"]["count"] == tail["gc"]["stats"]
    # no device on the CPU: the traced part's window is idle, in the spans
    assert traced["busy_s"] == 0
    assert sum(r["idle_s"] for r in traced["spans"].values()) == \
        pytest.approx(traced["window_s"])


def _traced(device, name):
    out = spans.run(harness.load_cell(name), 2**31 + 5, 1.0, 2, device)
    torch.cuda.empty_cache()
    return out["traced"]


@pytest.mark.cuda
def test_the_phase_spans_hold_the_training_steps_device_time(cuda_device):
    traced = _traced(cuda_device, "qwen2-1.5b.train-6k")
    by = traced["spans"]
    phases = sum(by[n]["device_s"] for n in
                 ("train.forward", "train.backward", "train.optimizer"))
    assert phases >= 0.95 * traced["busy_s"], by


@pytest.mark.cuda
def test_the_int8_copy_spans_hold_the_copy_kernels(cuda_device):
    traced = _traced(cuda_device, "qwen2-1.5b.gemm-4k-int8")
    kernels = traced["kernels"]
    total = sum(s for s, _ in kernels.values())
    # B's transposed copies, and the tied head's row-major copy
    # (``.contiguous()``, a generic elementwise copy)
    copies = sum(s for k, (s, _) in kernels.items()
                 if "transpose_s8" in k or "direct_copy_kernel" in k)
    by = traced["spans"]
    share = 100.0 * by["gemm.copy"]["device_s"] \
        / sum(r["device_s"] for r in by.values())
    assert abs(share - 100.0 * copies / total) <= 2.0, (share, copies,
                                                        total)
