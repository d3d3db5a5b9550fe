"""Online prediction-drift monitoring: is the calibration still true?

The paper's premise is that a calibrated analytic model *predicts* GEMM
wall time; ``repro.measure.fit_from_store`` already gates offline refits
on the median measured/predicted ratio (raising
:class:`~repro.measure.campaign.CalibrationDriftError` beyond
``max_drift``).  :class:`DriftMonitor` brings the same statistic online:
every serving/simulation step feeds one ``(predicted_s, measured_s)``
pair, keyed by the machine's ``geometry_fingerprint()`` (the identity
``repro.measure.SampleStore`` keys samples on), and the monitor keeps a
rolling window of ratios per key.

Status vocabulary (surfaced in ``perf_report()["drift"]``,
``SimReport.drift`` and the JAX package's ``python -m repro.obs drift``):

* ``ok``    — too few samples, or |median ratio − 1| ≤ ``warn_drift``;
* ``warn``  — drift above ``warn_drift`` but within ``max_drift``:
  predictions are sliding, watch the machine;
* ``stale`` — drift beyond ``max_drift``, the exact boundary the offline
  gate refuses to fit at (0.2 by repo convention): the calibration no
  longer describes the hardware, re-measure and refit.
"""
from __future__ import annotations

import statistics
from collections import deque
from typing import Any

DRIFT_SCHEMA = "repro.obs/drift-v1"

STATUS_OK = "ok"
STATUS_WARN = "warn"
STATUS_STALE = "stale"

#: The offline refit gate's conventional threshold (see
#: ``fit_from_store(..., max_drift=0.2)`` in docs/RESILIENCE.md) — reused
#: here as the online ok/warn → stale boundary.
DEFAULT_MAX_DRIFT = 0.2
DEFAULT_WARN_DRIFT = 0.1


class DriftMonitor:
    """Rolling measured/predicted ratio windows, one per machine key.

    Args:
        window: samples retained per key (older ratios age out, so the
            monitor tracks *current* drift and recovers after transient
            faults clear).
        warn_drift / max_drift: the ok→warn and warn→stale boundaries on
            ``|median(measured/predicted) − 1|``.
        min_samples: stay ``ok`` (verdict withheld) until a key has this
            many ratios — a single noisy step should not page anyone.
    """

    def __init__(self, *, window: int = 64,
                 warn_drift: float = DEFAULT_WARN_DRIFT,
                 max_drift: float = DEFAULT_MAX_DRIFT,
                 min_samples: int = 8):
        if not 0 < warn_drift <= max_drift:
            raise ValueError(
                f"need 0 < warn_drift <= max_drift, got "
                f"warn_drift={warn_drift} max_drift={max_drift}")
        self.window = int(window)
        self.warn_drift = float(warn_drift)
        self.max_drift = float(max_drift)
        self.min_samples = int(min_samples)
        self._ratios: dict[str, deque[float]] = {}
        self._observed: dict[str, int] = {}

    # -- producers -----------------------------------------------------------

    def observe(self, predicted_s: float, measured_s: float,
                *, key: str = "default") -> float | None:
        """Feed one prediction/measurement pair; returns the ratio
        recorded (or ``None`` for degenerate inputs, which are ignored —
        a zero-cost predicted step carries no drift information)."""
        if predicted_s <= 0 or measured_s <= 0:
            return None
        ratio = measured_s / predicted_s
        self._ratios.setdefault(
            key, deque(maxlen=self.window)).append(ratio)
        self._observed[key] = self._observed.get(key, 0) + 1
        return ratio

    # -- consumers -----------------------------------------------------------

    def keys(self) -> list[str]:
        return sorted(self._ratios)

    def median_ratio(self, key: str = "default") -> float | None:
        win = self._ratios.get(key)
        return statistics.median(win) if win else None

    def drift(self, key: str = "default") -> float | None:
        """``|median(measured/predicted) − 1|`` over the current window."""
        med = self.median_ratio(key)
        return None if med is None else abs(med - 1.0)

    def status(self, key: str = "default") -> str:
        win = self._ratios.get(key)
        if not win or len(win) < self.min_samples:
            return STATUS_OK
        d = abs(statistics.median(win) - 1.0)
        if d > self.max_drift:
            return STATUS_STALE
        if d > self.warn_drift:
            return STATUS_WARN
        return STATUS_OK

    def report(self, key: str | None = None) -> dict:
        """Machine-readable drift report (``repro.obs/drift-v1``).

        Per key: sample counts, current median ratio, drift, status, and
        the thresholds, so a dashboard can re-derive the verdict."""
        keys = [key] if key is not None else self.keys()
        per_key: dict[str, Any] = {}
        worst = STATUS_OK
        order = {STATUS_OK: 0, STATUS_WARN: 1, STATUS_STALE: 2}
        for k in keys:
            med = self.median_ratio(k)
            st = self.status(k)
            per_key[k] = {
                "samples": len(self._ratios.get(k, ())),
                "observed": self._observed.get(k, 0),
                "median_ratio": med,
                "drift": None if med is None else abs(med - 1.0),
                "status": st,
            }
            if order[st] > order[worst]:
                worst = st
        return {
            "schema": DRIFT_SCHEMA,
            "status": worst,
            "warn_drift": self.warn_drift,
            "max_drift": self.max_drift,
            "min_samples": self.min_samples,
            "window": self.window,
            "keys": per_key,
        }

    def check(self, key: str = "default", *,
              baseline: str = "online", store: str = "obs.DriftMonitor"):
        """Raise the *offline* gate's error type when a key is stale —
        so online monitoring and refit gating share one exception/dict
        shape (``CalibrationDriftError.as_dict()``)."""
        if self.status(key) != STATUS_STALE:
            return None
        from repro_torch.measure.campaign import CalibrationDriftError
        med = self.median_ratio(key)
        raise CalibrationDriftError(
            baseline=baseline, store=store,
            samples=len(self._ratios.get(key, ())),
            median_ratio=med, drift=abs(med - 1.0),
            max_drift=self.max_drift)

    def reset(self) -> "DriftMonitor":
        self._ratios.clear()
        self._observed.clear()
        return self
