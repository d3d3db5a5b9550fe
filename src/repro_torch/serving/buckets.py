"""Prefill length bucketing, shared by the real engine and the simulator.

A copy of ``repro.serving.buckets``.  The serving engine prefills prompts
at bucketed lengths (in the JAX package so the jit cache stays small; the
port keeps the same lengths so both engines run the same shapes, capacity
and routing of pad tokens included), and the discrete-event simulator
(``repro_torch.simulate``) charges prefill cost at the same bucket
lengths.
"""
from __future__ import annotations

#: the engine's jit-bucket ladder; prompts longer than the last rung round
#: up to the next multiple of it.
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024)


def bucket_len(n: int, buckets=PREFILL_BUCKETS) -> int:
    """The bucket a prefill of ``n`` tokens runs at."""
    for b in buckets:
        if n <= b:
            return b
    last = buckets[-1]
    return ((n + last - 1) // last) * last


def bucket_cover(max_len: int, buckets=PREFILL_BUCKETS) -> list[int]:
    """Every bucket a prompt of length ``<= max_len`` can land in — the
    lengths a service model must price prefill at."""
    out = [b for b in buckets if b < max_len]
    out.append(bucket_len(max_len, buckets))
    return sorted(set(out))
