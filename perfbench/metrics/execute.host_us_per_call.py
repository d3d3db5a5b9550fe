"""execute.host_us_per_call: host microseconds to enqueue one planned
call (plan lookup, wrapper, launch), read on the host clock over each
pass's enqueue, with no synchronise inside it, over the calls of the
window's passes."""


def read(rec):
    if rec.get("kind") != "gemm_pass" or not rec.get("passes"):
        return None
    calls = rec["passes"] * rec["calls_per_pass"]
    return 1e6 * sum(rec["enqueue_s"]) / calls
