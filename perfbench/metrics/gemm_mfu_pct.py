"""gemm_mfu_pct: the whole pass's share of the card's peak in the pass's
dtype: the operations of every pass of the untraced window over its wall
time (host clock, to the synchronise after the last pass)."""
from perfbench import roofline


def read(rec):
    if rec.get("kind") != "gemm_pass" or not rec.get("wall_s"):
        return None
    rate = rec["passes"] * rec["ops_per_pass"] / rec["wall_s"]
    return 100.0 * rate / roofline.PEAK_OPS[rec["dtype"]]
