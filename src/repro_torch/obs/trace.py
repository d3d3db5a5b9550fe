"""Span tracing: a process-local :class:`Recorder` + Chrome-trace export.

The subsystem has two channels with different on/off semantics:

* **Spans** — nested, named intervals (``obs.span("gemm.sweep")``) emitted
  from the hot paths (planner, sweep, serving steps, simulator, calibrator
  fits).  Spans are *disabled by default*: ``span()`` returns a shared
  no-op singleton when the recorder is off, so an instrumented hot loop
  pays one attribute load + one branch per call site (the
  ``obs_overhead`` bench workload asserts <2% on the Table-2 sweep).
* **Events** — the serving engine's ``repro.serving/trace-v1`` payloads.
  These were always-on before ``repro.obs`` existed and stay always-on:
  the engine appends them through :meth:`Recorder.add_event` and
  ``ServingEngine.trace_json()`` is now a *view* over this recorder.

Both channels export to one Chrome-trace/Perfetto JSON
(:meth:`Recorder.to_chrome_trace`): spans become complete ``"ph": "X"``
slices, events become instants, and each span's ``track`` ("wall" for
perf-counter timestamps, "sim" for simulator time) maps to its own tid
with a ``thread_name`` metadata row.  Timestamps are microseconds, per
the `Trace Event Format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_.

A live recorder (one turned on with :meth:`Recorder.enable`) also:

* keeps one span stack per thread, so that a span opened on another
  thread (autograd's device thread runs the backward) nests under nothing
  of the main thread's, and exports each thread's spans on a track of
  their own;
* mirrors every span into ``torch.profiler`` while a profiler records: a
  range of the same name opens just after the span's start and closes
  just before its end, so the span sits in the profiler's own event
  stream, on its clock, beside the kernels it launched;
* stamps one ``(time.time_ns(), perf_counter_ns())`` pair, whose
  difference its export carries as ``metadata["clock_offset_ns"]``: a
  span's ``ts`` plus that offset (in microseconds) is on the Unix-epoch
  clock of the profiler's events;
* records Python's garbage collections as ``python.gc`` spans
  (attributes ``generation`` and ``collected``), through a
  ``gc.callbacks`` hook that :meth:`Recorder.disable` removes.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import threading
import time
from typing import Any, Mapping

#: Schema tag stamped on every Chrome-trace export's ``metadata`` block.
TRACE_EXPORT_SCHEMA = "repro.obs/chrome-trace-v1"


@dataclasses.dataclass
class Span:
    """One closed (or still-open) named interval on a track."""

    sid: int
    name: str
    t0: float
    t1: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    track: str = "wall"
    parent: int | None = None
    #: the ident of the thread that opened it (None: a retrospective span)
    thread: int | None = None

    @property
    def duration_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def as_dict(self) -> dict:
        return {"sid": self.sid, "name": self.name, "t0": self.t0,
                "t1": self.t1, "track": self.track, "parent": self.parent,
                "thread": self.thread, "attrs": dict(self.attrs)}


class _NullSpan:
    """Shared no-op returned by ``span()`` when tracing is disabled.

    Implements just enough surface (context manager + ``set``) that call
    sites never branch on enablement themselves.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class _LiveSpan:
    """Context-manager handle for one recorder-backed span (and, while a
    profiler records, its profiler range)."""

    __slots__ = ("_rec", "_span", "_range")

    def __init__(self, rec: "Recorder", span: Span, rng=None):
        self._rec = rec
        self._span = span
        self._range = rng

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._rec._close(self._span, self._range)
        return False

    def set(self, **attrs):
        """Attach attributes to the span while it is open."""
        self._span.attrs.update(attrs)
        return self


class Recorder:
    """Process-local store of spans and serving events.

    One module-level instance (``repro.obs.recorder``) backs the whole
    process; tests may construct private recorders.  Spans may be opened
    on any thread: each thread nests its spans on a stack of its own, and
    appending a span is atomic under the interpreter lock.  There is no
    lock, which a disabled fast path could not afford.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.spans: list[Span] = []
        self.events: list[dict] = []
        self._local = threading.local()
        self._sids = itertools.count()
        self.clock = time.perf_counter
        #: ``(time.time_ns(), perf_counter_ns())`` taken by :meth:`enable`
        self.clock_pair: tuple[int, int] | None = None
        self._profiler = None
        self._gc_hook = self._on_gc
        self._gc_live = None

    # -- lifecycle -----------------------------------------------------------

    def enable(self) -> "Recorder":
        """Turn spans on, stamp the clock pair, mirror spans into
        ``torch.profiler`` whenever one records, and record Python's
        collections."""
        import torch.autograd.profiler as profiler
        self._profiler = profiler
        self.clock_pair = (time.time_ns(), time.perf_counter_ns())
        self.enabled = True
        if self._gc_hook not in gc.callbacks:
            gc.callbacks.append(self._gc_hook)
        return self

    def disable(self) -> "Recorder":
        self.enabled = False
        while self._gc_hook in gc.callbacks:
            gc.callbacks.remove(self._gc_hook)
        return self

    def clear(self) -> "Recorder":
        """Drop all recorded spans and events (enablement unchanged)."""
        self.spans.clear()
        self.events.clear()
        self._local = threading.local()
        self._sids = itertools.count()
        return self

    @property
    def _stack(self) -> list[Span]:
        """The calling thread's stack of open spans."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    # -- span channel (gated on ``enabled``) ---------------------------------

    def span(self, name: str, *, track: str = "wall", **attrs):
        """Open a nested span; no-op singleton when disabled."""
        if not self.enabled:
            return _NULL
        stack = self._stack
        s = Span(sid=next(self._sids), name=name, t0=self.clock(),
                 attrs=dict(attrs), track=track,
                 parent=stack[-1].sid if stack else None,
                 thread=threading.get_ident())
        self.spans.append(s)
        stack.append(s)
        return _LiveSpan(self, s, self._open_range(name))

    def _open_range(self, name: str):
        """A profiler range named ``name``, opened, while a profiler
        records (else None)."""
        prof = self._profiler
        if prof is None or not prof._is_profiler_enabled:
            return None
        rng = prof.record_function(name)
        rng.__enter__()
        return rng

    def _close(self, span: Span, rng=None) -> None:
        if rng is not None:
            rng.__exit__(None, None, None)
        span.t1 = self.clock()
        stack = self._stack
        # tolerate out-of-order exits (generators, re-raised errors)
        if span in stack:
            while stack and stack[-1] is not span:
                stack.pop()
            if stack:
                stack.pop()

    def _on_gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` hook: one ``python.gc`` span a collection."""
        if not self.enabled:
            return
        if phase == "start":
            self._gc_live = self.span("python.gc",
                                      generation=info["generation"])
            return
        live, self._gc_live = self._gc_live, None
        if live is None:
            return
        live.set(collected=info.get("collected", 0))
        live.__exit__(None, None, None)

    def add_span(self, name: str, t0: float, t1: float, *,
                 track: str = "wall", parent: int | None = None,
                 **attrs) -> Span | None:
        """Record a retrospective span from externally-taken timestamps
        (serving-step wall clocks, simulator virtual time).  Gated on
        ``enabled`` like :meth:`span`; returns the span or ``None``."""
        if not self.enabled:
            return None
        s = Span(sid=next(self._sids), name=name, t0=float(t0),
                 t1=float(t1), attrs=dict(attrs), track=track,
                 parent=parent)
        self.spans.append(s)
        return s

    # -- event channel (always on) -------------------------------------------

    def add_event(self, payload: dict, *, track: str = "wall",
                  tag: str | None = None) -> dict:
        """Append one serving trace-v1 event payload.  Always on: the
        engine's event trace predates ``repro.obs`` and stays cheap and
        unconditional.  ``tag`` names the producer (one serving engine
        among several sharing this recorder); :meth:`events_for` filters
        on it.  Returns the payload (stored by reference, so the producer
        may keep mutating it until export)."""
        payload["_track"] = track
        if tag is not None:
            payload["_tag"] = tag
        self.events.append(payload)
        return payload

    _PRIVATE_KEYS = ("_track", "_tag")

    def events_for(self, track: str | None = None,
                   tag: str | None = None) -> list[dict]:
        """Event payloads (without the private ``_track``/``_tag`` keys),
        optionally filtered by track and/or producer tag."""
        out = []
        for e in self.events:
            if track is not None and e.get("_track", "wall") != track:
                continue
            if tag is not None and e.get("_tag") != tag:
                continue
            out.append({k: v for k, v in e.items()
                        if k not in self._PRIVATE_KEYS})
        return out

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self, *, pid: int = 1) -> dict:
        """Render spans + events as a Chrome-trace JSON object."""
        tracks: dict[str, int] = {}

        def tid_of(track: str) -> int:
            if track not in tracks:
                tracks[track] = len(tracks) + 1
            return tracks[track]

        main = threading.main_thread().ident
        trace_events: list[dict] = []
        for s in self.spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            # another thread's spans go on a track of their own
            track = s.track if s.thread in (None, main) \
                else f"{s.track} (thread {s.thread})"
            trace_events.append({
                "name": s.name, "ph": "X", "cat": "repro",
                "ts": s.t0 * 1e6, "dur": max(0.0, (t1 - s.t0) * 1e6),
                "pid": pid, "tid": tid_of(track),
                "args": _jsonable(s.attrs),
            })
        for e in self.events:
            track = e.get("_track", "wall")
            args = {k: v for k, v in e.items()
                    if k not in ("_track", "_tag", "type", "t")}
            trace_events.append({
                "name": f"event.{e.get('type', '?')}", "ph": "i",
                "cat": "repro", "ts": float(e.get("t", 0.0)) * 1e6,
                "pid": pid, "tid": tid_of(track), "s": "t",
                "args": _jsonable(args),
            })
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": track},
            })
        meta = {"schema": TRACE_EXPORT_SCHEMA, "spans": len(self.spans),
                "events": len(self.events)}
        if self.clock_pair is not None:
            epoch_ns, counter_ns = self.clock_pair
            meta["clock_offset_ns"] = epoch_ns - counter_ns
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "metadata": meta,
        }

    def save_chrome_trace(self, path) -> dict:
        doc = self.to_chrome_trace()
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return doc


def _jsonable(attrs: Mapping[str, Any]) -> dict:
    """Chrome-trace args must be JSON — stringify anything exotic."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool)) else str(x)
                      for x in v]
        else:
            out[k] = str(v)
    return out


def chrome_trace_from_serving(trace: Mapping[str, Any]) -> dict:
    """Convert a saved ``repro.serving/trace-v1`` document into a
    Chrome-trace JSON — the file-based path (the JAX package's
    ``python -m repro.obs export``) when no live recorder exists.

    Mapping (documented in docs/OBSERVABILITY.md):

    * every ``step`` event (which carries ``t`` + ``dt``) becomes a
      ``serve.step`` slice on the "wall" track;
    * every request's ``submit -> finish|shed`` pair becomes a
      ``request.<id>`` slice on the "requests" track (TTFT and cause in
      ``args``);
    * all other events become instants.
    """
    rec = Recorder(enabled=True)
    events = trace.get("events", [])
    submits: dict[Any, dict] = {}
    firsts: dict[Any, float] = {}

    def rid_of(e: Mapping[str, Any]):
        return e.get("rid", e.get("id"))

    for e in events:
        typ = e.get("type")
        if typ == "step":
            t0 = float(e["t"])
            rec.add_span("serve.step", t0, t0 + float(e.get("dt", 0.0)),
                         track="wall", admitted=len(e.get("admitted", [])),
                         active=e.get("active"),
                         queue_depth=e.get("queue_depth"))
        elif typ == "submit":
            submits[rid_of(e)] = e
        elif typ == "first_token":
            firsts[rid_of(e)] = float(e["t"])
        elif typ in ("finish", "shed"):
            sub = submits.pop(rid_of(e), None)
            if sub is not None:
                attrs = {"outcome": typ}
                if typ == "shed" and "cause" in e:
                    attrs["cause"] = e["cause"]
                ttft = firsts.pop(rid_of(e), None)
                if ttft is not None:
                    attrs["ttft_s"] = ttft - float(sub["t"])
                rec.add_span(f"request.{rid_of(e)}", float(sub["t"]),
                             float(e["t"]), track="requests", **attrs)
            else:
                rec.add_event(dict(e))
        else:
            rec.add_event(dict(e))
    # unfinished requests: open slices to the last event timestamp
    horizon = max((float(e.get("t", 0.0)) for e in events), default=0.0)
    for rid, sub in submits.items():
        rec.add_span(f"request.{rid}", float(sub["t"]), horizon,
                     track="requests", outcome="unfinished")
    doc = rec.to_chrome_trace()
    doc["metadata"]["source_schema"] = trace.get("schema")
    return doc
