"""Slot-server simulation: ``ServingEngine`` semantics on the event queue.

:class:`SlotServer` mirrors the real engine step for step — a fixed pool
of ``max_batch`` decode slots, FIFO admission from an unbounded queue,
per-admission bucketed prefill, then one batched decode step for every
active slot (inactive slots decode harmlessly in the real engine, so the
decode step costs the same regardless of occupancy — the simulator charges
the same constant).  What the real engine gets from its kernels,
the simulator gets from a :class:`ServiceModel`: calibrated
``GemmPlan.estimate()`` costs for the decode-step and prefill-bucket
workloads, so a simulated deployment is priced by exactly the analytic
models the planner ranks with.

Admission policies (the ``policy`` axis of the SLO sweep):

* ``greedy`` — fill every free slot each step (the real engine's rule).
* ``one-per-step`` — admit at most one request per step, bounding the
  prefill work (and hence the stall) any single step can add.
* ``drain-first`` — admit only when the whole pool is idle (batch-
  synchronous serving, the anti-pattern continuous batching replaced;
  kept as the baseline it is).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Iterable, Iterator, Mapping

from repro_torch import obs
from repro_torch.obs import DriftMonitor
from repro_torch.serving.buckets import PREFILL_BUCKETS, bucket_cover, bucket_len
from repro_torch.serving.resilience import (SHED_DEADLINE_EXPIRED,
                                      SHED_DEADLINE_UNMEETABLE,
                                      SHED_QUEUE_FULL)
from repro_torch.simulate.engine import Simulator
from repro_torch.simulate.faults import FaultScenario
from repro_torch.simulate.metrics import Metrics, SimReport, StepSample
from repro_torch.simulate.traffic import SimRequest, Traffic

POLICIES = ("greedy", "one-per-step", "drain-first")


def _workload_seconds(plans) -> float:
    return sum(p.predicted_seconds for p in plans)


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Analytic service times for one ``(machine, dtype, batch)`` cell.

    ``decode_step_s`` prices one decode step of the full slot pool;
    ``prefill_s`` maps each prefill bucket to the seconds a single-sequence
    prefill of that length costs.  Both come from the same calibrated
    plans the deployment report ranks with (:meth:`from_plans`), or from
    any explicit numbers (tests, what-ifs).
    """

    decode_step_s: float
    prefill_s: Mapping[int, float]
    buckets: tuple = PREFILL_BUCKETS

    def prefill_seconds(self, prefix_len: int) -> float:
        """Cost of prefilling ``prefix_len`` prompt tokens (0 tokens cost
        nothing — the engine skips the prefill call entirely)."""
        if prefix_len <= 0 or not self.prefill_s:
            return 0.0
        b = bucket_len(prefix_len, self.buckets)
        if b in self.prefill_s:
            return self.prefill_s[b]
        # beyond the priced ladder: charge pro rata against the largest
        # priced bucket (prefill cost is ~linear in tokens at these sizes)
        top = max(self.prefill_s)
        return self.prefill_s[top] * (b / top)

    @classmethod
    def from_plans(cls, cfg, *, batch: int, machine=None, dtype: str = "bf16",
                   backend: str = "analytic-tpu", max_len: int = 512,
                   buckets=PREFILL_BUCKETS,
                   decode_step_s: float | None = None,
                   precision=None) -> "ServiceModel":
        """Price the cell from the analytic planner.

        Decode: the ``model_gemm_shapes(cfg, tokens=batch)`` workload (the
        exact plans ``ServingEngine`` freezes).  Prefill: the same workload
        at ``tokens=bucket`` for every bucket a ``max_len`` prompt can
        land in.  ``decode_step_s`` overrides the decode price when the
        caller already planned it (e.g. a ``DeploymentOption``'s
        ``seconds_per_step``), skipping the duplicate sweep.  ``precision``
        (a ``PrecisionConfig`` or its key) prices a mixed-precision cell —
        ``dtype`` must then be a plannable operand dtype (the config's
        compute dtype), not the cell's ``AxB->ACC`` label.  ``backend``
        defaults to the JAX package's ``analytic-tpu``; ``"cuda"`` prices
        the card with the Hopper tile model (``h100``, ``h100-measured``).
        """
        from repro_torch import gemm
        from repro_torch.core.autotune import model_gemm_shapes

        if decode_step_s is None:
            decode_step_s = _workload_seconds(gemm.plan_many(
                model_gemm_shapes(cfg, tokens=batch), backend=backend,
                machine=machine, dtype=dtype, precision=precision))
        prefill: dict[int, float] = {}
        for b in bucket_cover(max_len, buckets):
            prefill[b] = _workload_seconds(gemm.plan_many(
                model_gemm_shapes(cfg, tokens=b), backend=backend,
                machine=machine, dtype=dtype, precision=precision))
        return cls(decode_step_s=float(decode_step_s), prefill_s=prefill,
                   buckets=tuple(buckets))


@dataclasses.dataclass
class _Live:
    """A request occupying a slot (or waiting in the queue)."""

    req: SimRequest
    tokens: int = 0


class SlotServer:
    """The simulated engine: schedule with :meth:`offer`, step on events.

    Args:
        sim: the event loop this server schedules on.
        service: per-step / per-prefill costs.
        max_batch: decode-slot pool size.
        max_len: per-slot cache length — long prompts are trimmed exactly
            as the real engine trims them (``prompt[-max_len + new:]``).
        policy: admission policy, one of :data:`POLICIES`.
        metrics: collector (a fresh one by default).
        start_at: hold the first step until this sim time (replay aligns
            this with the real engine's drain-loop start).
        step_times: optional iterable of *measured* step durations; when
            given, step ``k`` costs the ``k``-th entry instead of the
            analytic price (measured-service replay).  Falls back to the
            model if the iterator runs dry.
        deadline_s: default end-to-end latency budget applied to requests
            that carry none; ``None`` disables deadline shedding.
        queue_limit: bounded-queue depth; an arrival that finds the queue
            full is *dropped* and recorded as a ``queue_full`` shed (open
            loop: arrivals cannot be asked to wait, unlike the real
            engine's ``QueueFullError`` backpressure).
        decision_step_s: the per-step cost the *shedding decision* uses
            when modeling whether a deadline is meetable (defaults to the
            service model's decode step).  Replay passes the real
            engine's recorded planning estimate so both sides decide on
            identical inputs.
        faults: a :class:`~repro_torch.simulate.faults.FaultScenario` (or name /
            dict) perturbing this run: throttle windows scale step costs,
            slot failures evict and re-queue a victim at step boundaries,
            surges are extra arrivals the *caller* drives (see
            :func:`simulate_serving`).
    """

    def __init__(self, sim: Simulator, service: ServiceModel, *,
                 max_batch: int, max_len: int = 512,
                 policy: str = "greedy", metrics: Metrics | None = None,
                 start_at: float | None = None,
                 step_times: Iterable[float] | None = None,
                 deadline_s: float | None = None,
                 queue_limit: int | None = None,
                 decision_step_s: float | None = None,
                 faults: FaultScenario | str | dict | None = None,
                 drift: DriftMonitor | None = None,
                 drift_key: str = "sim"):
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"have {POLICIES}")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue limit must be >= 1, got {queue_limit}")
        self.sim = sim
        self.service = service
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.policy = policy
        self.metrics = metrics if metrics is not None else Metrics()
        self.queue: collections.deque[_Live] = collections.deque()
        self.slots: list[_Live | None] = [None] * self.max_batch
        self.steps_run = 0
        self.deadline_s = deadline_s
        self.queue_limit = queue_limit
        self.decision_step_s = float(
            service.decode_step_s if decision_step_s is None
            else decision_step_s)
        self.faults = FaultScenario.coerce(faults) if faults is not None \
            else None
        self.slot_failures = 0
        self.throttled_steps = 0
        # online drift: the un-perturbed model price vs what the step
        # actually cost (measured replay times, fault-scaled costs) — the
        # simulated analogue of the real engine's step-time monitoring.
        self.drift = drift if drift is not None else DriftMonitor()
        self.drift_key = drift_key
        self._stepping = False
        self._started = start_at is None
        self._step_times: Iterator[float] | None = \
            iter(step_times) if step_times is not None else None
        # slot failures materialise at step boundaries: track the next
        # scheduled failure and process every one that fell inside a step
        # when the step completes (the victim loses that step's work)
        self._failures = self.faults.failures() if self.faults else iter(())
        nxt = next(self._failures, None)
        self._next_fail: tuple[float, float] | None = \
            (nxt[0], nxt[1]) if nxt else None
        if start_at is not None:
            sim.schedule_at(start_at, self._start)

    # -- driving ------------------------------------------------------------
    def _deadline_for(self, req: SimRequest) -> float | None:
        return req.deadline_s if req.deadline_s is not None \
            else self.deadline_s

    def offer(self, req: SimRequest) -> None:
        """Accept one request (call at its arrival time)."""
        self.metrics.on_arrival(req.rid, self.sim.now, req.prompt_len,
                                req.decode_len,
                                deadline_s=self._deadline_for(req))
        if self.queue_limit is not None \
                and len(self.queue) >= self.queue_limit:
            self.metrics.on_shed(req.rid, self.sim.now, SHED_QUEUE_FULL)
            obs.metrics.counter("sim.shed")
            return
        self.queue.append(_Live(req=req))
        self._kick()

    def drive(self, requests: Iterable[SimRequest]) -> None:
        """Schedule a whole traffic stream's arrivals."""
        for req in requests:
            self.sim.schedule_at(req.arrival_s,
                                 functools.partial(self.offer, req))

    def _start(self) -> None:
        self._started = True
        self._kick()

    def _kick(self) -> None:
        if self._started and not self._stepping and (
                self.queue or any(self.slots)):
            self._stepping = True
            self.sim.schedule(0.0, self._step)

    # -- one engine step ----------------------------------------------------
    def _free(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _shed_cause(self, req: SimRequest) -> str | None:
        """Why this queued request should be shed instead of admitted
        right now; ``None`` when it is admissible.  The decision uses the
        same two inputs the real engine uses: time already waited and the
        modeled decode time at ``decision_step_s`` (prefill excluded —
        both sides must exclude it identically)."""
        dl = self._deadline_for(req)
        if dl is None:
            return None
        waited = self.sim.now - req.arrival_s
        if waited >= dl:
            return SHED_DEADLINE_EXPIRED
        if waited + self.decision_step_s * req.decode_len > dl:
            return SHED_DEADLINE_UNMEETABLE
        return None

    def _next_admissible(self) -> _Live | None:
        """Pop the queue until an admissible request surfaces, shedding
        the hopeless ones along the way (a shed never consumes a slot)."""
        while self.queue:
            live = self.queue.popleft()
            cause = self._shed_cause(live.req)
            if cause is None:
                return live
            self.metrics.on_shed(live.req.rid, self.sim.now, cause)
            obs.metrics.counter("sim.shed")
        return None

    def _admit(self) -> list[_Live]:
        free = self._free()
        if self.policy == "one-per-step":
            free = free[:1]
        elif self.policy == "drain-first" and len(free) < self.max_batch:
            free = []
        admitted = []
        for slot in free:
            live = self._next_admissible()
            if live is None:
                break
            self.slots[slot] = live
            self.metrics.on_admit(live.req.rid, self.sim.now)
            admitted.append(live)
        return admitted

    def _prefix_len(self, req: SimRequest) -> int:
        # mirror the engine: prompt trimmed to the cache window, last
        # prompt token fed to the first decode step rather than prefilled
        kept = min(req.prompt_len, max(1, self.max_len - req.decode_len))
        return max(kept - 1, 0)

    def _step(self) -> None:
        t0 = self.sim.now
        admitted = self._admit()
        active = [s for s in self.slots if s is not None]
        if not active:
            self._stepping = False
            return
        nominal = self.service.decode_step_s + sum(
            self.service.prefill_seconds(self._prefix_len(a.req))
            for a in admitted)
        cost = None
        if self._step_times is not None:
            cost = next(self._step_times, None)
        if cost is None:
            cost = nominal
        # thermal-throttle windows scale whatever this step costs,
        # sampled at step start (DVFS changes between steps, not within)
        if self.faults is not None:
            scale = self.faults.service_scale(t0)
            if scale != 1.0:
                cost *= scale
                self.throttled_steps += 1
                obs.metrics.counter("sim.faults.throttled_steps")
        # what the calibration predicted vs what the step will really
        # cost in sim time — throttles and measured replays drift, the
        # un-faulted analytic path stays at ratio 1.0 exactly
        self.drift.observe(nominal, cost, key=self.drift_key)
        sample = StepSample(t=t0, dt=cost, active=len(active),
                            admitted=len(admitted),
                            queue_depth=len(self.queue))
        self.sim.schedule(cost, functools.partial(self._finish_step, sample))

    def _process_failures(self, now: float) -> None:
        """Evict the victim of every slot failure that fell inside the
        step that just completed.  The victim loses the step's work
        entirely — tokens reset (its KV cache is gone, re-admission pays
        prefill again) — and re-queues at the *front*, keeping its
        original arrival time so the latency hit lands in the tail."""
        while self._next_fail is not None and self._next_fail[0] <= now:
            u = self._next_fail[1]
            occupied = [i for i, s in enumerate(self.slots) if s is not None]
            if occupied:
                victim_slot = occupied[min(int(u * len(occupied)),
                                           len(occupied) - 1)]
                live = self.slots[victim_slot]
                self.slots[victim_slot] = None
                live.tokens = 0
                self.queue.appendleft(live)
                self.metrics.on_requeue(live.req.rid, now)
                self.slot_failures += 1
                obs.metrics.counter("sim.faults.slot_failures")
            # advance to the next scheduled failure (an idle-slot failure
            # is a no-op but still consumes its schedule entry)
            nxt = next(self._failures, None)
            self._next_fail = (self._next_fail[0] + nxt[0], nxt[1]) \
                if nxt else None

    def _finish_step(self, sample: StepSample) -> None:
        now = self.sim.now
        self._process_failures(now)
        for i, live in enumerate(self.slots):
            if live is None:
                continue
            live.tokens += 1
            self.metrics.on_token(live.req.rid, now)
            if live.tokens >= live.req.decode_len:
                self.metrics.on_finish(live.req.rid, now)
                self.slots[i] = None
        self.steps_run += 1
        self.metrics.on_step(sample)
        self._stepping = False
        self._kick()


def simulate_serving(service: ServiceModel, traffic: Traffic, *,
                     max_batch: int, max_len: int = 512,
                     policy: str = "greedy", requests: int = 100,
                     seed: int | None = None, horizon: float | None = None,
                     deadline_s: float | None = None,
                     queue_limit: int | None = None,
                     decision_step_s: float | None = None,
                     faults: FaultScenario | str | dict | None = None,
                     config: Mapping[str, Any] | None = None) -> SimReport:
    """One full run: traffic -> slot server -> metrics report.

    Args:
        service / traffic: who prices the work and who sends it.
        max_batch / max_len / policy: the serving configuration under test.
        requests: stream length drawn from ``traffic``.
        seed: simulator RNG seed (defaults to the traffic's own seed; the
            generators pre-draw their randomness, so this only matters for
            future stochastic modules).
        horizon: optional sim-time cutoff — requests still in flight are
            reported as ``unfinished``.
        deadline_s / queue_limit / decision_step_s: resilience knobs, see
            :class:`SlotServer`.
        faults: a :class:`~repro_torch.simulate.faults.FaultScenario` (or
            registry name / dict) perturbing the run; its surges are
            driven on top of the nominal traffic and the report's
            ``faults`` block records what fired.
        config: extra identity keys merged into the report's ``config``.

    Returns:
        A :class:`~repro_torch.simulate.metrics.SimReport` for the run.
    """
    scenario = FaultScenario.coerce(faults) if faults is not None else None
    sim = Simulator(seed=traffic.seed if seed is None else seed,
                    horizon=horizon)
    drift_key = str((config or {}).get("machine", "sim"))
    server = SlotServer(sim, service, max_batch=max_batch, max_len=max_len,
                        policy=policy, deadline_s=deadline_s,
                        queue_limit=queue_limit,
                        decision_step_s=decision_step_s, faults=scenario,
                        drift_key=drift_key)
    server.drive(traffic.requests(requests))
    surge = scenario.surge_requests() if scenario is not None else []
    if surge:
        server.drive(surge)
    sim.run()
    full = {"traffic": traffic.name, "batch": max_batch, "policy": policy,
            "max_len": max_len, "requests": requests,
            "seed": traffic.seed if seed is None else seed,
            **({"deadline_s": deadline_s} if deadline_s is not None else {}),
            **({"queue_limit": queue_limit} if queue_limit is not None
               else {}),
            **({"faults": scenario.name} if scenario is not None else {}),
            **dict(config or {})}
    fault_info = {}
    if scenario is not None:
        fault_info = {"scenario": scenario.name,
                      "slot_failures": server.slot_failures,
                      "throttled_steps": server.throttled_steps,
                      "surge_requests": len(surge)}
    report = server.metrics.report(config=full, max_batch=max_batch,
                                   faults=fault_info,
                                   drift=server.drift.report())
    return report
