"""device.idle_pct.pass: the share of a pass in which no operation runs
on the card: 100 less the device's busy time a traced pass (the union of
its kernel, copy and set intervals, from the profiler's trace) over the
wall time a pass of the untraced window.  The untraced window sets the
pace, so the profiler's own host cost does not show as idle time."""


def read(rec):
    if rec.get("kind") != "gemm_pass" or "trace" not in rec \
            or not rec.get("passes"):
        return None
    busy = rec["trace"]["busy_s"] / rec["traced_passes"]
    return 100.0 * (1.0 - busy / (rec["wall_s"] / rec["passes"]))
