"""Slot-based continuous-batching serving engine.

The counterpart of ``repro.serving.engine``.  A fixed pool of
``max_batch`` decode slots, each holding one sequence's KV caches at its
own position (the decode step takes a (B,) position vector).  New requests
prefill individually at bucketed lengths and are *inserted* into a free
slot's cache region; finished slots free immediately — no batch-wide
barrier, the defining property of continuous batching.

Where the JAX engine jits each piece, the port runs eagerly on the model's
device: the compute copy of the weights is made once per engine
(``LM.compute_params``), decode updates the slot caches in place, and a
prefill's caches are copied into the slot's region in place.  The
per-step tokens come back to the host in one transfer, which synchronises
with the card, so a step's wall time includes its device work.

The frozen decode GEMM plans behind ``perf_report()`` and the shedding
decisions are planned on the ``cuda`` backend, so they are priced on the
``h100`` manifest, whose rates are data-sheet placeholders until a
calibration campaign on the card replaces them; ``perf_report()["machine"]``
says so.  ``autoconfigure`` picks the operating point from a deployment
report instead (``repro_torch.serving.report.plan_deployment``, and with an
SLO the serving simulator, ``repro_torch.simulate``) and freezes the picked
cell's plans; like the JAX package it plans on ``analytic-tpu`` unless the
caller names a backend (``backend="cuda"`` prices the card).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch

from repro_torch import gemm as gemm_api
from repro_torch import obs
from repro_torch.models.model import LM
from repro_torch.obs import DriftMonitor
from repro_torch.runtime.serve_lib import make_decode_step, make_prefill_step
from repro_torch.serving.buckets import bucket_len as _bucket
from repro_torch.serving.resilience import (SHED_DEADLINE_EXPIRED,
                                            SHED_DEADLINE_UNMEETABLE,
                                            DegradationRung, QueueFullError,
                                            coerce_ladder)

#: the event-trace format ``repro_torch.simulate.replay`` consumes
TRACE_SCHEMA = "repro.serving/trace-v1"


class DrainTruncatedError(RuntimeError):
    """``run_until_drained`` hit ``max_steps`` with work still in flight.

    Raised instead of silently returning a partial result: a truncated
    drain would otherwise masquerade as a complete trace and poison any
    sim-vs-real replay comparison.  ``finished`` / ``queued`` / ``active``
    carry the state at truncation.
    """

    def __init__(self, *, finished: int, queued: int, active: int,
                 max_steps: int):
        self.finished = finished
        self.queued = queued
        self.active = active
        self.max_steps = max_steps
        super().__init__(
            f"run_until_drained truncated after {max_steps} steps: "
            f"{queued} request(s) still queued, {active} still decoding "
            f"({finished} finished) — raise max_steps or submit less work")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list            # token ids
    max_new_tokens: int = 16
    eos_id: int | None = None
    # end-to-end latency budget in seconds from submission; None defers to
    # the engine's default deadline (which may also be None: no deadline)
    deadline_s: float | None = None
    generated: list = dataclasses.field(default_factory=list)
    # lifecycle timestamps (time.perf_counter seconds), stamped by the
    # engine: submission, slot admission, first decoded token, last token
    t_submit: float | None = None
    t_admit: float | None = None
    t_first_token: float | None = None
    t_finish: float | None = None
    # load shedding: when and why the engine rejected this request at
    # admission time instead of serving it
    t_shed: float | None = None
    shed_cause: str | None = None

    @property
    def shed(self) -> bool:
        return self.shed_cause is not None

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.generated \
                and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens

    @property
    def wait_s(self) -> float | None:
        """Queue time: submit -> admission."""
        if self.t_submit is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def service_s(self) -> float | None:
        """Admission -> last token."""
        if self.t_admit is None or self.t_finish is None:
            return None
        return self.t_finish - self.t_admit

    @property
    def latency_s(self) -> float | None:
        """End to end: submit -> last token."""
        if self.t_submit is None or self.t_finish is None:
            return None
        return self.t_finish - self.t_submit

    @property
    def ttft_s(self) -> float | None:
        """Submit -> first decoded token."""
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit


class ServingEngine:
    """See the module docstring for the serving model.

    Resilience knobs (all off by default — a default-constructed engine
    behaves bit-identically to one without them):

    * ``deadline_s``: default end-to-end budget for requests that carry
      none; enables deadline-aware admission — a queued request whose
      deadline already passed (``deadline_expired``) or whose modeled
      decode time no longer fits (``deadline_unmeetable``, using the
      frozen-plan step estimate at the current slot cap) is *shed* at
      admission instead of wasting a slot.
    * ``queue_limit``: bounded queue; ``submit`` raises
      :class:`~repro_torch.serving.resilience.QueueFullError` (backpressure —
      pair with :func:`~repro_torch.serving.resilience.retry_with_backoff`).
    * ``ladder`` / ``overload_patience``: graceful degradation — after
      ``overload_patience`` consecutive steps with every allowed slot
      busy *and* work still queued, the engine steps down one
      :class:`~repro_torch.serving.resilience.DegradationRung` (fewer decode
      slots, then a modeled int8 KV cache); it steps back up after the
      same number of calm (empty-queue) steps.  ``ladder=None`` with a
      deadline or queue limit set installs the stock
      :func:`~repro_torch.serving.resilience.default_ladder`; ``ladder=()``
      disables degradation outright.
    """

    def __init__(self, lm: LM, params, *, max_batch: int = 4,
                 max_len: int = 512,
                 deadline_s: float | None = None,
                 queue_limit: int | None = None,
                 ladder=None, overload_patience: int = 8):
        self.lm = lm
        self.max_batch = max_batch
        self.max_len = max_len
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue limit must be >= 1, got {queue_limit}")
        if overload_patience < 1:
            raise ValueError(f"overload patience must be >= 1, "
                             f"got {overload_patience}")
        self.deadline_s = deadline_s
        self.queue_limit = queue_limit
        resilient = deadline_s is not None or queue_limit is not None \
            or ladder is not None
        self.ladder: tuple[DegradationRung, ...] = \
            coerce_ladder(ladder, max_batch) if resilient else ()
        self.overload_patience = int(overload_patience)
        self._rung = -1                  # -1 = nominal, else ladder index
        self._overload_streak = 0
        self._calm_streak = 0
        self.degradations: list[dict] = []
        self.shed_requests: list[Request] = []
        self.rejected_submits = 0
        self.truncated: dict | None = None
        self._step_s_cache: dict[int, float] = {}
        # the compute copy, once per engine (not once per call)
        self.params = lm.compute_params(params)
        self.caches = lm.init_cache(max_batch, max_len)
        self.slot_pos = [0] * max_batch          # next write position
        self.slot_req: list[Request | None] = [None] * max_batch
        # deque: admission pops from the front per free slot, so the queue
        # must not pay O(n) per admission like list.pop(0) did.
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self._decode = make_decode_step(lm)
        self._prefill = make_prefill_step(lm)
        # Frozen GEMM plans for this engine's decode workload (M = the slot
        # pool size): the paper's predict-before-run loop applied to serving,
        # surfaced through perf_report().  Planned lazily on first access;
        # plan_model_gemms is a bulk operation (one batched lattice
        # evaluation over the deduped decode shapes).  autoconfigure()
        # installs its chosen cell's plans instead.
        self._gemm_plans: list | None = None
        # populated by autoconfigure(): the chosen operating point and the
        # full ranked DeploymentReport it was selected from.
        self.autoconfig: dict | None = None
        self.deployment_report = None
        # event trace (repro.serving/trace-v1): submits, admissions, steps
        # with wall durations, first tokens, finishes — what
        # repro_torch.simulate.replay re-enacts.  Cheap (a dict append per
        # event), so always on.  The events live in the process
        # ``repro_torch.obs`` recorder tagged with this engine's identity;
        # ``trace_events`` / ``trace_json()`` are views over it.
        self._obs_tag = f"serving-engine-{id(self):x}"
        # online prediction drift: measured step wall time vs the frozen
        # plans' decode-step estimate, keyed by the deployment machine's
        # geometry fingerprint.
        self.drift = DriftMonitor()
        self._drift_key: str | None = None

    def _trace(self, payload: dict) -> None:
        obs.recorder.add_event(payload, track="wall", tag=self._obs_tag)

    @property
    def trace_events(self) -> list[dict]:
        """This engine's trace-v1 event payloads, in emission order — a
        view over the process ``repro_torch.obs`` recorder."""
        return obs.recorder.events_for(tag=self._obs_tag)

    @property
    def gemm_plans(self) -> list:
        if self._gemm_plans is None:
            self._gemm_plans = gemm_api.plan_model_gemms(
                self.lm.cfg, tokens=self.max_batch, backend="cuda")
        return self._gemm_plans

    @gemm_plans.setter
    def gemm_plans(self, plans) -> None:
        self._gemm_plans = list(plans)

    @classmethod
    def autoconfigure(cls, lm: LM, params, *, machine=None,
                      dtypes=("bf16",), batches=(1, 2, 4, 8, 16),
                      max_len: int = 512,
                      backend: str = "analytic-tpu",
                      memory: bool = True,
                      kv_dtype: str | None = None,
                      precisions=(),
                      slo=None, traffic=None,
                      robust: bool = False, faults=None,
                      deadline_s: float | None = None,
                      queue_limit: int | None = None,
                      ladder=None,
                      sim_policies=("greedy",),
                      sim_requests: int = 200,
                      sim_seed: int = 0) -> "ServingEngine":
        """Pick ``max_batch``, the deployment machine and the frozen decode
        plans by ranking the whole (machine x dtype x batch) serving grid.

        Wraps :func:`repro_torch.serving.report.plan_deployment`: every
        cell's memory footprint (weights + KV/recurrent state + activation
        workspace, ``repro_torch.serving.footprint``) is checked against the
        machine's deployment-level budget and infeasible cells are pruned
        *before* the ``repro_torch.gemm.sweep`` plans them; among the
        surviving cells, the one maximising predicted decode tokens/second
        wins — ``max_batch`` is therefore the largest batch that both fits
        memory and pays off in throughput, not the fastest-GEMM batch.

        The dtype axis is an analytic what-if over the machine's rate
        table; since the engine really computes in the model's configured
        dtype, the operating point is chosen among that native dtype's
        feasible cells — what-if dtypes inform the ranking only.  If no
        native-dtype cell survives, the overall best feasible cell wins (an
        explicit choice to configure against a foreign dtype).

        Args:
            lm / params: the model the engine will serve (on ``lm.device``).
            machine: machines axis — a name, spec, glob (``"zoo/*"`` ranks
                the whole registry), a list of any of those, or None for
                the backend's default machine.
            dtypes: serving-dtype what-if axis.
            batches: candidate ``max_batch`` values.
            max_len: per-slot cache length (bounds the KV footprint).
            backend: planning backend for the decode-GEMM sweep
                (``analytic-tpu``, the JAX package's default; ``cuda``
                prices the card with the Hopper tile model).
            memory: enforce the deployment-memory budget (default True);
                False restores the throughput-only grid.
            kv_dtype: KV-cache dtype override for the footprint model.
            precisions: extra mixed-precision what-if cells
                (:class:`~repro_torch.core.precision.PrecisionConfig` or key
                strings like ``"int4xint8->int32"``), forwarded to
                :func:`~repro_torch.serving.report.plan_deployment`.  Like
                what-if dtypes they inform the ranking only — the frozen
                operating point always comes from a plain-dtype cell.
            slo: optional service-level objective (a
                :class:`repro_torch.simulate.SLO`, kwargs dict, or bare p99
                latency bound).  When given, the memory-feasible cells are
                additionally run through the discrete-event simulator
                (``repro_torch.simulate``) under ``traffic`` and the engine
                is configured from the cell with the best *simulated*
                goodput among those attaining the SLO.  SLO-failing cells
                join ``deployment_report.rejected`` with machine-readable
                ``slo_*`` reasons.
            traffic: traffic scenario for SLO mode (a
                ``repro_torch.simulate.Traffic``); None derives a Poisson
                scenario from the report
                (:func:`repro_torch.simulate.default_traffic`).
            robust: perturbation-robust SLO mode (requires ``slo``): the
                cells are simulated *under a fault scenario* — by default
                the ``"throttle20"`` duty-cycled thermal throttle.  Cells
                that only fail under the faults are rejected with
                ``fault_``-prefixed reasons.
            faults: the fault scenario for robust mode (a
                ``repro_torch.simulate.FaultScenario``, registry name, or
                dict); implies ``robust=True`` when given.
            deadline_s / queue_limit / ladder: resilience knobs for the
                *configured* engine; deadline and queue limit also apply
                to the SLO-mode simulations so the pick accounts for
                shedding.
            sim_policies / sim_requests / sim_seed: SLO-mode simulation
                knobs — admission policies to consider, stream length per
                cell, and the default-traffic seed.

        Returns:
            A configured engine.  ``engine.deployment_report`` holds the
            ranked :class:`~repro_torch.serving.report.DeploymentReport`;
            ``engine.autoconfig`` keeps the flat JSON-friendly grid (one
            entry per feasible cell, plus ``rejected`` cells with
            machine-readable reasons) consumed by ``perf_report``.

        Raises:
            ValueError: when every (machine, dtype, batch) cell is memory-
                infeasible (the error lists the per-cell rejection
                reasons), or in SLO mode when no cell attains the SLO.
        """
        from repro_torch.serving.report import plan_deployment

        report = plan_deployment(
            lm.cfg, machines=machine, dtypes=dtypes, batches=batches,
            max_len=max_len, backend=backend, memory=memory,
            kv_dtype=kv_dtype, precisions=precisions)
        if faults is not None:
            robust = True
        if robust and slo is None:
            raise ValueError("autoconfigure(robust=True) needs an slo: "
                             "robustness is defined as SLO attainment "
                             "under perturbation")
        selection = None
        if slo is not None:
            from repro_torch.machines import MachineSpec, expand_many
            from repro_torch.simulate import evaluate_deployment

            if robust and faults is None:
                faults = "throttle20"
            overrides = {e.name: e for e in expand_many(machine)
                         if isinstance(e, MachineSpec)}
            selection = evaluate_deployment(
                lm.cfg, report, slo=slo, traffic=traffic,
                policies=sim_policies, requests=sim_requests,
                seed=sim_seed, machines=overrides, faults=faults,
                deadline_s=deadline_s, queue_limit=queue_limit)
            best = selection.option
        else:
            best = report.select()
        eng = cls(lm, params, max_batch=best.batch, max_len=max_len,
                  deadline_s=deadline_s, queue_limit=queue_limit,
                  ladder=ladder)
        eng.gemm_plans = [r.plan for r in best.rows]
        eng.deployment_report = report
        grid = [{
            "max_batch": o.batch, "machine": o.machine, "dtype": o.dtype,
            "predicted_gemm_seconds_per_step": o.seconds_per_step,
            "predicted_tokens_per_second": o.tokens_per_second,
            "footprint_bytes": o.footprint.total_bytes,
            "memory_budget_bytes": o.budget_bytes,
            "memory_headroom_bytes": o.headroom_bytes,
        } for o in report.options]
        eng.autoconfig = {
            "max_batch": best.batch, "machine": best.machine,
            "dtype": best.dtype, "native_dtype": report.native_dtype,
            "backend": backend,
            "predicted_tokens_per_second": best.tokens_per_second,
            "footprint_bytes": best.footprint.total_bytes,
            "memory_budget_bytes": best.budget_bytes,
            "memory_headroom_bytes": best.headroom_bytes,
            "grid": grid,
            "rejected": [r.as_dict() for r in report.rejected],
        }
        if selection is not None:
            eng.autoconfig["slo"] = {
                "slo": selection.slo.as_dict(),
                "policy": selection.policy,
                "traffic": selection.traffic_name,
                "faults": selection.faults,
                "sim": selection.sim.summary(),
                "rejected": [r.as_dict() for r in selection.rejections],
            }
        return eng

    def perf_report(self) -> dict:
        """Predicted per-decode-step GEMM cost from the frozen plans, plus
        measured per-request wait/service/latency stats once requests have
        finished (the timestamps the event trace records) — the real-side
        half of a sim-vs-real comparison."""
        total = sum(p.predicted_seconds for p in self.gemm_plans)
        report = {
            "predicted_gemm_seconds_per_step": total,
            "predicted_tokens_per_second":
                (self.max_batch / total) if total else float("inf"),
            "plans": [p.describe() for p in self.gemm_plans],
        }
        timed = [r for r in self.finished if r.latency_s is not None]
        if timed:
            def stats(vals):
                vals = sorted(vals)
                return {"mean": sum(vals) / len(vals), "max": vals[-1],
                        "p95": vals[min(len(vals) - 1,
                                        int(0.95 * (len(vals) - 1) + 0.5))]}
            report["measured_requests"] = {
                "finished": len(timed),
                "wait_s": stats([r.wait_s for r in timed]),
                "service_s": stats([r.service_s for r in timed]),
                "latency_s": stats([r.latency_s for r in timed]),
                "ttft_s": stats([r.ttft_s for r in timed
                                 if r.ttft_s is not None] or [0.0]),
            }
        resilience = self._resilience_report()
        if resilience is not None:
            report["resilience"] = resilience
        if self.autoconfig is not None:
            report["autoconfig"] = self.autoconfig
        report["machine"] = self._machine_report()
        # online prediction-drift verdict (repro_torch.obs): every step
        # feeds measured wall time vs the frozen-plan estimate; ok/warn/stale
        # uses the offline CalibrationDriftError threshold.  Against the
        # uncalibrated h100 manifest (and on a host running the plain
        # versions) "stale" is the honest verdict.
        drift = self.drift.report()
        report["drift"] = drift
        report["drift_status"] = drift["status"]
        return report

    def _resilience_report(self) -> dict | None:
        """Shed/expired/degraded accounting for ``perf_report()``; None
        when no resilience feature is configured or ever fired (keeping
        the default report shape unchanged)."""
        engaged = (self.deadline_s is not None
                   or self.queue_limit is not None or bool(self.ladder)
                   or self.shed_requests or self.rejected_submits
                   or self.truncated is not None)
        if not engaged:
            return None
        causes: dict[str, int] = {}
        for r in self.shed_requests:
            causes[r.shed_cause] = causes.get(r.shed_cause, 0) + 1
        out = {
            "deadline_s": self.deadline_s,
            "queue_limit": self.queue_limit,
            "shed": {"count": len(self.shed_requests), "causes": causes},
            "expired": causes.get(SHED_DEADLINE_EXPIRED, 0),
            "rejected_submits": self.rejected_submits,
            "degraded": {
                "ladder": [r.as_dict() for r in self.ladder],
                "rung": self.rung.name if self.rung else None,
                "events": list(self.degradations),
            },
        }
        if self.truncated is not None:
            out["truncated"] = dict(self.truncated)
        return out

    def _machine_report(self) -> dict:
        """The machine the frozen plans price against, and whether its
        rates were ever calibrated on a card."""
        from repro_torch.machines import resolve

        name = self.gemm_plans[0].machine if self.gemm_plans else "unknown"
        prov = resolve(name, name).provenance
        return {"name": name,
                "uncalibrated": bool(prov.get("uncalibrated", False)),
                "status": prov.get("status")}

    # -- model pieces ---------------------------------------------------------
    def _insert(self, caches, pref, slot: int) -> None:
        """Copy a single-sequence prefill cache into slot ``slot``, in place.

        Every cache leaf has its batch axis first; the slot's region is
        zeroed beyond the prefill's (shorter) sequence axis, as the JAX
        engine's zero padding does."""
        if isinstance(caches, dict):
            if set(caches) != set(pref):
                raise ValueError(f"prefill cache keys {sorted(pref)} do not "
                                 f"match the slot cache's {sorted(caches)}")
            for key in caches:
                self._insert(caches[key], pref[key], slot)
            return
        if isinstance(caches, list):
            for c, p in zip(caches, pref, strict=True):
                self._insert(c, p, slot)
            return
        region = caches[slot]
        region.zero_()
        region[tuple(slice(0, n) for n in pref.shape[1:])] = \
            pref[0].to(caches.dtype)

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue one request.

        Raises:
            QueueFullError: the bounded queue (``queue_limit``) is full —
                backpressure, not shedding: the request was never
                accepted, the caller owns the retry (see
                :func:`repro_torch.serving.resilience.retry_with_backoff`).
        """
        req.t_submit = time.perf_counter()
        if self.queue_limit is not None \
                and len(self.queue) >= self.queue_limit:
            self.rejected_submits += 1
            obs.metrics.counter("serving.rejected_submits")
            self._trace({
                "type": "reject", "rid": req.rid, "t": req.t_submit,
                "queue_depth": len(self.queue), "limit": self.queue_limit})
            raise QueueFullError(limit=self.queue_limit,
                                 depth=len(self.queue))
        self.queue.append(req)
        obs.metrics.counter("serving.submitted")
        event = {
            "type": "submit", "rid": req.rid, "t": req.t_submit,
            "prompt_len": len(req.prompt),
            "max_new_tokens": req.max_new_tokens}
        dl = self._deadline_for(req)
        if dl is not None:
            event["deadline_s"] = dl
        self._trace(event)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    # -- resilience ---------------------------------------------------------
    def _deadline_for(self, req: Request) -> float | None:
        return req.deadline_s if req.deadline_s is not None \
            else self.deadline_s

    @property
    def rung(self) -> DegradationRung | None:
        """The active degradation rung (``None`` at nominal service)."""
        return self.ladder[self._rung] if self._rung >= 0 else None

    @property
    def slot_cap(self) -> int:
        """How many decode slots admission may fill right now."""
        r = self.rung
        return self.max_batch if r is None else r.decode_slots

    def decision_step_s(self, cap: int | None = None) -> float:
        """The modeled decode-step seconds the shedding decision prices
        with: the frozen plans' prediction at the current slot cap
        (re-planned per cap — a degraded engine admits against its own,
        smaller, modeled step).  The full-batch value is exactly
        ``perf_report()``'s ``predicted_gemm_seconds_per_step``."""
        cap = self.slot_cap if cap is None else cap
        if cap not in self._step_s_cache:
            if cap == self.max_batch:
                plans = self.gemm_plans
            else:
                plans = gemm_api.plan_model_gemms(
                    self.lm.cfg, tokens=cap, backend="cuda")
            self._step_s_cache[cap] = \
                sum(p.predicted_seconds for p in plans)
        return self._step_s_cache[cap]

    def _shed_cause(self, req: Request, now: float) -> str | None:
        """Why this queued request should be shed rather than admitted:
        deadline already passed, or the modeled decode time alone
        (``decision_step_s * max_new_tokens``; prefill excluded — the
        simulator excludes it identically) no longer fits the budget."""
        dl = self._deadline_for(req)
        if dl is None:
            return None
        waited = now - req.t_submit
        if waited >= dl:
            return SHED_DEADLINE_EXPIRED
        if waited + self.decision_step_s() * req.max_new_tokens > dl:
            return SHED_DEADLINE_UNMEETABLE
        return None

    def _shed(self, req: Request, cause: str, now: float) -> None:
        req.t_shed = now
        req.shed_cause = cause
        self.shed_requests.append(req)
        obs.metrics.counter("serving.shed")
        obs.metrics.counter(f"serving.shed.{cause}")
        self._trace({
            "type": "shed", "rid": req.rid, "t": now, "cause": cause,
            "waited_s": now - req.t_submit})

    def _next_admissible(self) -> Request | None:
        """Pop the queue until an admissible request surfaces, shedding
        hopeless ones along the way (a shed never consumes the slot, so
        an expired backlog drains in one step)."""
        while self.queue:
            req = self.queue.popleft()
            now = time.perf_counter()
            cause = self._shed_cause(req, now)
            if cause is None:
                return req
            self._shed(req, cause, now)
        return None

    def _update_ladder(self, active: int) -> None:
        """Degradation bookkeeping, once per step: sustained overload
        (every allowed slot busy, work still queued) steps down a rung;
        the same patience of calm steps back up."""
        if not self.ladder:
            return
        overloaded = bool(self.queue) and active >= self.slot_cap
        self._overload_streak = self._overload_streak + 1 if overloaded \
            else 0
        self._calm_streak = self._calm_streak + 1 if not self.queue else 0
        if self._overload_streak >= self.overload_patience \
                and self._rung < len(self.ladder) - 1:
            self._rung += 1
            self._overload_streak = 0
            obs.metrics.counter("serving.degraded")
            event = {"type": "degrade", "t": time.perf_counter(),
                     "rung": self.rung.name,
                     "decode_slots": self.rung.decode_slots,
                     "kv_dtype": self.rung.kv_dtype}
            self._trace(event)
            self.degradations.append(dict(event))
        elif self._calm_streak >= self.overload_patience and self._rung >= 0:
            self._rung -= 1
            self._calm_streak = 0
            obs.metrics.counter("serving.restored")
            name = self.rung.name if self.rung else "nominal"
            event = {"type": "restore", "t": time.perf_counter(),
                     "rung": name, "decode_slots": self.slot_cap}
            self._trace(event)
            self.degradations.append(dict(event))

    def _admit(self) -> list[Request]:
        admitted = []
        for slot in self._free_slots():
            if self.max_batch - len(self._free_slots()) >= self.slot_cap:
                break
            req = self._next_admissible()
            if req is None:
                break
            ptoks = req.prompt[-self.max_len + req.max_new_tokens:]
            # prefill all but the last prompt token; the first decode step
            # feeds prompt[-1] at position len-1 (cache then logits in one).
            prefix = ptoks[:-1]
            bucket = 0
            if prefix:
                # recurrent blocks fold every token into their state, so pad
                # tokens would corrupt it: exact-length prefill for those.
                recurrent = any(k in ("mamba2", "mlstm", "slstm")
                                for k in self.lm.cfg.block_pattern)
                bucket = (len(prefix) if recurrent
                          else min(_bucket(len(prefix)), self.max_len))
                with obs.span("serve.prefill", rid=req.rid, bucket=bucket,
                              slot=slot):
                    toks = torch.zeros((1, bucket), dtype=torch.long)
                    toks[0, :len(prefix)] = torch.tensor(prefix)
                    _, pref = self._prefill(
                        self.params, {"tokens": toks.to(self.lm.device)})
                    self._insert(self.caches, pref, slot)
            self.slot_pos[slot] = len(ptoks) - 1
            self.slot_req[slot] = req
            req.t_admit = time.perf_counter()
            obs.metrics.counter("serving.admitted")
            self._trace({
                "type": "admit", "rid": req.rid, "t": req.t_admit,
                "slot": slot, "prefix_len": len(prefix), "bucket": bucket})
            admitted.append(req)
        return admitted

    def step(self) -> list[Request]:
        """Admit + one decode step for all active slots; returns newly
        finished requests."""
        t_start = time.perf_counter()
        admitted = self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        self._update_ladder(len(active))
        if not active:
            return []
        tokens = torch.zeros((self.max_batch, 1), dtype=torch.long)
        for i in active:
            r = self.slot_req[i]
            tokens[i, 0] = r.generated[-1] if r.generated else r.prompt[-1]
        # inactive slots decode harmlessly at position 0 (outputs ignored;
        # admission overwrites their cache region)
        pos_vec = torch.tensor([min(p, self.max_len - 1)
                                for p in self.slot_pos])
        dev = self.lm.device
        nxt, _, self.caches = self._decode(self.params, self.caches,
                                           tokens.to(dev), pos_vec.to(dev))
        # one device-to-host transfer, which waits for the step's kernels
        nxt = nxt[:, 0].tolist()
        out, firsts = [], []
        for i in active:
            r = self.slot_req[i]
            r.generated.append(nxt[i])
            if len(r.generated) == 1:
                firsts.append(r)
            self.slot_pos[i] += 1
            if r.done or self.slot_pos[i] >= self.max_len - 1:
                self.finished.append(r)
                out.append(r)
                self.slot_req[i] = None
                self.slot_pos[i] = 0
        # one stamp for the whole step: tokens materialise at the step
        # boundary (the simulator's model of it), not per slot
        t_end = time.perf_counter()
        for r in firsts:
            r.t_first_token = t_end
            self._trace(
                {"type": "first_token", "rid": r.rid, "t": t_end})
        for r in out:
            r.t_finish = t_end
            obs.metrics.counter("serving.finished")
            self._trace(
                {"type": "finish", "rid": r.rid, "t": t_end,
                 "tokens": len(r.generated)})
        self._trace({
            "type": "step", "t": t_start, "dt": t_end - t_start,
            "admitted": [r.rid for r in admitted], "active": len(active),
            "queue_depth": len(self.queue)})
        obs.metrics.counter("serving.steps")
        obs.metrics.observe("serving.step_dt_s", t_end - t_start)
        obs.add_span("serve.step", t_start, t_end,
                     admitted=len(admitted), active=len(active),
                     queue_depth=len(self.queue))
        self.drift.observe(self.decision_step_s(), t_end - t_start,
                           key=self._drift_machine_key())
        return out

    def _drift_machine_key(self) -> str:
        """``name@geometry_fingerprint`` of the machine the frozen plans
        price against — the identity drift windows are keyed by (the same
        key ``repro_torch.measure.SampleStore`` uses for samples)."""
        if self._drift_key is None:
            name = (self.gemm_plans[0].machine if self.gemm_plans
                    else "unknown")
            try:
                from repro_torch.machines import resolve
                self._drift_key = f"{name}@" \
                    f"{resolve(name, name).geometry_fingerprint()}"
            except Exception:
                self._drift_key = name
        return self._drift_key

    def drain(self, max_steps: int = 10_000, *,
              on_truncate: str = "raise") -> list[Request]:
        """Step until queue and slots are empty.

        Args:
            max_steps: give up after this many steps.
            on_truncate: ``"raise"`` (default) raises
                :class:`DrainTruncatedError` on a partial drain;
                ``"report"`` records the truncation (``self.truncated``,
                surfaced by ``perf_report()``) and returns what *did*
                finish — for CLI/benchmark paths that would otherwise
                lose every measurement to the exception.

        Raises:
            DrainTruncatedError: truncated and ``on_truncate="raise"`` —
                a partial drain must not pass for a complete trace (see
                ``repro_torch.simulate.replay``).
        """
        if on_truncate not in ("raise", "report"):
            raise ValueError(f"on_truncate must be 'raise' or 'report', "
                             f"got {on_truncate!r}")
        for _ in range(max_steps):
            self.step()
            if not self.queue and all(r is None for r in self.slot_req):
                return self.finished
        state = dict(finished=len(self.finished), queued=len(self.queue),
                     active=sum(r is not None for r in self.slot_req),
                     max_steps=max_steps)
        if on_truncate == "raise":
            raise DrainTruncatedError(**state)
        self.truncated = state
        self._trace({
            "type": "truncated", "t": time.perf_counter(), **state})
        return self.finished

    def run_until_drained(self, max_steps: int = 10_000, *,
                          on_truncate: str = "raise") -> list[Request]:
        """Alias of :meth:`drain` (the historical name)."""
        return self.drain(max_steps, on_truncate=on_truncate)

    def trace_json(self) -> dict:
        """The engine's event trace (``repro.serving/trace-v1``) — feed it
        to :func:`repro_torch.simulate.replay.replay` for sim-vs-real
        validation, or persist it next to a measurement campaign.
        ``predicted_step_s`` is the frozen-plan decode-step estimate the
        engine's shedding decisions price with; replay hands it to the
        simulator so both sides decide on identical inputs."""
        return {"schema": TRACE_SCHEMA, "max_batch": self.max_batch,
                "max_len": self.max_len,
                "predicted_step_s": self.decision_step_s(self.max_batch),
                "events": list(self.trace_events)}
