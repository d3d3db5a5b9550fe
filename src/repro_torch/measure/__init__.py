"""``repro.measure`` — measurement, sample storage and model validation.

The fourth subsystem next to ``core`` / ``gemm`` / ``machines``: it closes
the paper's measure→fit→validate loop that the analytic side only predicts.

    >>> from repro_torch import measure
    >>> store = measure.SampleStore("measurements/h100.jsonl")
    >>> measure.run_campaign("table2", machine="h100", dtype="bf16",
    ...                      harness="cuda", store=store)
    >>> spec, fit = measure.fit_from_store(store, "h100", name="h100-fit",
    ...                                    date=None, on_nonpositive="drop")
    >>> report = measure.validate_spec(spec, store)
    >>> print(report.table())           # per-cell errors + MAPE

Layers: ``harness`` (timing backends behind one protocol — host loop-nest
replay, ``plan.execute`` on the card to a ``torch.cuda.synchronize``, the
simulated closed-loop oracle), ``store`` (append-only JSONL samples keyed by the machine's
geometry fingerprint), ``campaign`` (sweep-driven measurement grids feeding
``Calibrator.fit``), ``validate`` (predicted-vs-measured accuracy reports).

``python -m repro_torch.measure run|fit|validate|report`` drives the same
loop from the shell.
"""
from repro_torch.measure.harness import (
    Harness,
    TimingResult,
    blocked_loop_nest,
    clock_overhead,
    get_harness,
    harness_names,
    plan_loop_order,
    time_callable,
)
from repro_torch.measure.store import (
    SAMPLE_SCHEMA,
    Sample,
    SampleStore,
    StaleSampleError,
)
from repro_torch.measure.campaign import (
    CalibrationDriftError,
    CampaignResult,
    DEFAULT_FIT_MKS,
    fit_from_store,
    grid_names,
    grid_problems,
    run_campaign,
)
from repro_torch.measure.validate import (
    REPORT_SCHEMA,
    ValidationReport,
    ValidationRow,
    predict_plan,
    predict_sample,
    predict_samples,
    validate_spec,
)

__all__ = [
    "CalibrationDriftError", "CampaignResult", "DEFAULT_FIT_MKS",
    "Harness", "REPORT_SCHEMA",
    "SAMPLE_SCHEMA", "Sample", "SampleStore", "StaleSampleError",
    "TimingResult", "ValidationReport", "ValidationRow",
    "blocked_loop_nest", "clock_overhead", "fit_from_store", "get_harness",
    "grid_names", "grid_problems", "harness_names", "plan_loop_order",
    "predict_plan", "predict_sample", "predict_samples", "run_campaign",
    "time_callable", "validate_spec",
]
