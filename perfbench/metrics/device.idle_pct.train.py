"""device.idle_pct.train: the share of a training step in which no
operation runs on the card: 100 less the device's busy time a traced step
(the union of its kernel, copy and set intervals, from the profiler's
trace) over the wall time a step of the untraced window.  The untraced
window sets the pace, so the profiler's own host cost, which slows an
eager step by more than half, does not show as idle time."""


def read(rec):
    if rec.get("kind") != "train" or "trace" not in rec \
            or not rec.get("steps"):
        return None
    busy = rec["trace"]["busy_s"] / rec["traced_steps"]
    return 100.0 * (1.0 - busy / (rec["wall_s"] / rec["steps"]))
