"""Calibration micro-experiments (paper §3.2).

The paper calibrates its simulator with a handful of micro-experiments:
packing rates at a reference chunk size (r = 4), straight panel-copy rates,
micro-kernel streaming rates, and one arithmetic-rate measurement.  The GAP8
numbers are published (Table 1) and live in the machine-zoo manifest
``repro_torch/machines/zoo/gap8-fc.json``; this module provides the raw
*measurements* for re-running the methodology on the host we are on.  They
run on the host CPU with numpy, as the JAX package's do; the card is
calibrated from measured GEMM campaigns instead (``repro_torch.measure``
with the ``cuda`` harness, fitted on the Hopper tile model).

The pipeline around them — assembling a :class:`MachineSpec`, least-squares
rate fitting on the batched simulators, registering the result and
persisting a manifest — is :class:`repro_torch.machines.Calibrator`;
:func:`calibrate_host` below is a thin wrapper over
``Calibrator.measure_host`` kept for compatibility.
"""
from __future__ import annotations

import numpy as np

from repro_torch.machines.spec import MachineSpec


def _time(fn, *args, reps: int = 5) -> float:
    """Timing via the shared ``repro_torch.measure.harness`` protocol:
    one warmup call (first-touch page faults of the freshly allocated
    buffers are not billed to the packing rates), then median-of-min over
    ``reps`` rounds with the clock overhead subtracted."""
    from repro_torch.measure.harness import time_callable

    return time_callable(lambda: fn(*args), warmup=1, rounds=reps).seconds


def measure_copy_rate(nbytes: int = 1 << 24) -> float:
    """Contiguous copy bandwidth (bytes/s) — the analogue of T_{M,L1}."""
    src = np.ones(nbytes, dtype=np.uint8)
    dst = np.empty_like(src)
    t = _time(lambda: np.copyto(dst, src))
    return nbytes / t


def measure_packing_rate(chunk: int, rows: int = 4096, cols: int = 4096
                         ) -> float:
    """Strided packing bandwidth (bytes/s) for a given contiguous-chunk size.

    Mirrors the paper's packing experiment: reorganise a matrix into
    micro-panels of ``chunk`` leading elements.  The paper observed the rate
    scaling linearly with the chunk size; ``tests/test_torch_calibrate.py``
    checks the same trend holds for the host.
    """
    a = np.arange(rows * cols, dtype=np.uint8).reshape(rows, cols)
    panels = cols // chunk

    def pack():
        # (rows, panels, chunk) -> (panels, rows, chunk): same data movement
        # pattern as Fig. 2 (chunks of `chunk` consecutive elements).
        return np.ascontiguousarray(
            a.reshape(rows, panels, chunk).transpose(1, 0, 2))

    t = _time(pack)
    return a.nbytes / t


def measure_arith_rate(n: int = 1024) -> float:
    """Matmul throughput (ops/s) — the analogue of the 5.64 INT8 GOPS
    micro-kernel experiment."""
    a = np.random.rand(n, n).astype(np.float32)
    b = np.random.rand(n, n).astype(np.float32)
    t = _time(lambda: a @ b)
    return 2.0 * n ** 3 / t


def calibrate_host(name: str = "host-cpu", *, date: str | None = None,
                   register: bool = False) -> MachineSpec:
    """Run the full calibration suite and assemble a MachineSpec.

    Thin wrapper over :meth:`repro_torch.machines.Calibrator.measure_host`,
    which owns the measure→register→persist pipeline; with
    ``register=True`` the spec replaces the zoo's ``host-cpu`` template in
    the registry so the planner sweeps against measured host rates.
    """
    from repro_torch.machines.calibrate import Calibrator

    return Calibrator.measure_host(name, date=date, register=register)
