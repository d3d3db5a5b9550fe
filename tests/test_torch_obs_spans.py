"""The port's ``obs`` spans: one stack a thread, mirrored into
``torch.profiler`` on its clock, Python's collections, the shared no-op
while disabled, and the spans the training step and the GEMM wrappers
open, on the CPU."""
import gc
import threading
import time

import pytest
import torch
from torch.autograd import DeviceType

from repro_torch import gemm, obs
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.kernels import gemm as K
from repro_torch.kernels import grouped_gemm as G
from repro_torch.models.common import HOST_MESH, tree_leaves
from repro_torch.models.model import LM
from repro_torch.obs.trace import _NULL
from repro_torch.runtime.train_lib import init_train_state, make_train_step


@pytest.fixture
def spans():
    """The process recorder cleared and on; off, unhooked and cleared
    after."""
    obs.clear()
    obs.enable()
    try:
        yield obs.recorder
    finally:
        obs.disable()
        obs.clear()


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_a_span_on_another_thread_nests_under_nothing_of_the_main_one(
        spans):
    opened = threading.Event()
    release = threading.Event()

    def other():
        with obs.span("other.outer"):
            opened.set()
            release.wait(10)
            with obs.span("other.inner"):
                pass

    with obs.span("main.outer"):
        t = threading.Thread(target=other)
        t.start()
        assert opened.wait(10)
        with obs.span("main.inner"):
            release.set()
            t.join(10)
    assert not t.is_alive()
    (mo,), (mi,) = _named(spans, "main.outer"), _named(spans, "main.inner")
    (oo,), (oi,) = _named(spans, "other.outer"), _named(spans, "other.inner")
    assert mo.parent is None and mi.parent == mo.sid
    assert oo.parent is None and oi.parent == oo.sid
    assert mo.thread == mi.thread == threading.get_ident()
    assert oo.thread == oi.thread != mo.thread
    # each thread's spans go on a track of their own
    doc = obs.to_chrome_trace()
    tid = {e["name"]: e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert tid["main.outer"] == tid["main.inner"] != tid["other.inner"]
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert names[tid["main.outer"]] == "wall"
    assert names[tid["other.outer"]] == f"wall (thread {oo.thread})"


def test_spans_are_profiler_ranges_on_the_profilers_clock(spans):
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        # the profiler's first range pays its set-up
        with torch.profiler.record_function("warm.up"):
            pass
        for i in range(4):
            with obs.span(f"span.{i}", i=i):
                with obs.span("span.child"):
                    torch.ones(64) + 1
            time.sleep(0.002)
        gc.collect()
    with obs.span("after.profile"):
        pass
    offset = obs.to_chrome_trace()["metadata"]["clock_offset_ns"]
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            ranges.setdefault(e.name(), []).append(e)
    # Python's collections are spans too (the profiler makes garbage)
    assert "python.gc" in ranges
    recorded = [s for s in spans.spans
                if s.name not in ("python.gc", "after.profile")]
    assert len(recorded) == 8
    threads = set()
    for s in recorded:
        got = ranges[s.name].pop(0)
        start = s.t0 * 1e9 + offset
        assert abs(got.start_ns() - start) <= 200e3, (s.name,
                                                      got.start_ns() - start)
        # the range lies inside the span
        assert got.start_ns() + got.duration_ns() <= s.t1 * 1e9 + offset \
            + 200e3
        threads.add((s.thread, got.start_thread_id()))
    assert len(threads) == 1
    assert "after.profile" not in ranges


def test_disabled_spans_are_the_shared_no_op_and_disable_unhooks_gc():
    assert not obs.enabled()
    assert obs.span("x", a=1) is _NULL
    assert obs.recorder.span("x") is _NULL
    obs.enable()
    obs.enable()
    hooks = [cb for cb in gc.callbacks
             if getattr(cb, "__self__", None) is obs.recorder]
    obs.disable()
    obs.clear()
    assert len(hooks) == 1
    assert not [cb for cb in gc.callbacks
                if getattr(cb, "__self__", None) is obs.recorder]
    # a recorder never enabled stamps no clock offset
    assert "clock_offset_ns" not in obs.Recorder(
        enabled=True).to_chrome_trace()["metadata"]


def test_a_full_collection_is_a_python_gc_span(spans):
    with obs.span("outer"):
        gc.collect()
    (outer,) = _named(spans, "outer")
    full = [s for s in _named(spans, "python.gc")
            if s.attrs["generation"] == 2]
    assert full and all(s.parent == outer.sid for s in full)
    assert all(s.t1 >= s.t0 and s.attrs["collected"] >= 0 for s in full)


def _tiny_step(seed=0):
    cfg = get_config("qwen2-1.5b", smoke=True)
    lm = LM(cfg, HOST_MESH, device="cpu")
    tcfg = TrainConfig(lr=2e-3, warmup_steps=1, total_steps=10)
    params, _, opt, _ = init_train_state(
        lm, tcfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    ids = torch.randint(0, cfg.vocab_size, (3, 2, 17), generator=gen)
    batches = [{"tokens": x[:, :-1], "labels": x[:, 1:]} for x in ids]
    return make_train_step(lm, tcfg, ParallelConfig()), params, opt, batches


def test_the_train_step_is_three_phases_and_the_same_with_spans_on():
    step, params, opt, batches = _tiny_step()
    losses = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        losses.append(m["loss"])
    want = [p.detach().clone() for p in tree_leaves(params)]
    step, params, opt, _ = _tiny_step()
    obs.clear()
    obs.enable()
    try:
        got_losses = []
        for b in batches:
            params, opt, m = step(params, opt, b)
            got_losses.append(m["loss"])
        main = threading.get_ident()
        phases = [s for s in obs.recorder.spans
                  if s.name.startswith("train.")]
    finally:
        obs.disable()
        obs.clear()
    assert all(torch.equal(a, b) for a, b in zip(got_losses, losses))
    assert all(torch.equal(a, b.detach())
               for a, b in zip(want, tree_leaves(params)))
    assert [(s.name, s.attrs["step"]) for s in phases] == [
        (n, i) for i in range(3)
        for n in ("train.forward", "train.backward", "train.optimizer")]
    assert all(s.thread == main and s.parent is None for s in phases)
    for a, b in zip(phases, phases[1:]):
        assert a.t0 <= a.t1 <= b.t0 <= b.t1


def test_planned_calls_are_spans_with_their_shape(spans):
    a = torch.randn(2, 3, 16, dtype=torch.bfloat16)
    w = torch.randn(16, 24, dtype=torch.bfloat16)
    gemm.matmul(a, w)
    x = torch.randn(5, 4, 7, 16)
    gemm.grouped_matmul(x, torch.randn(4, 16, 8))
    (mm,) = _named(spans, "gemm.matmul")
    assert mm.attrs == {"m": 6, "n": 24, "k": 16, "dtype": "bf16"}
    (plan,) = _named(spans, "gemm.plan_many")
    assert plan.parent == mm.sid
    (gm,) = _named(spans, "gemm.grouped_matmul")
    assert gm.attrs == {"m": 35, "n": 8, "k": 16, "groups": 4,
                        "dtype": "f32", "design": None}


@pytest.mark.parametrize("lead,c,want", [((), 32, "decode"),
                                         ((), 819, "wide"),
                                         ((3,), 24, "wide"),
                                         ((2,), 32, "decode")])
def test_a_grouped_span_names_the_design_of_its_launch(spans, lead, c, want):
    """bf16: the wide design from 65 rows an expert, the leading dims
    folded into C (3 x 24 = 72 rows), as the card's launch takes it."""
    x = torch.randn(*lead, 2, c, 16, dtype=torch.bfloat16)
    gemm.grouped_matmul(x, torch.randn(2, 16, 8, dtype=torch.bfloat16))
    (gm,) = _named(spans, "gemm.grouped_matmul")
    assert gm.attrs["design"] == want
    assert gm.attrs["m"] == c * (lead[0] if lead else 1)


def test_each_operand_copy_is_a_gemm_copy_span(spans):
    a = torch.randint(-5, 5, (32, 48), dtype=torch.int8)
    bt = torch.randint(-5, 5, (40, 48), dtype=torch.int8)
    before = dict(K.COPIES)
    _, b, _ = K._as_read(a, bt.t())
    assert b.is_contiguous()
    assert K.COPIES["transposed"] == before["transposed"] + 1
    # 7 bf16 columns: rows of 14 bytes, which TMA cannot read in place
    x = torch.randn(3, 5, 7).bfloat16()
    _, _, copied = G.tma_rows(x, 7)
    assert copied
    kinds = [s.attrs["kind"] for s in _named(spans, "gemm.copy")]
    assert kinds == ["transposed", "aligned"]
    obs.disable()
    K._as_read(a, bt.t())
    assert len(_named(spans, "gemm.copy")) == 2
