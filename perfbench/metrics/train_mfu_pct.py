"""train_mfu_pct: the training step's model operations (three times the
forward's: every matrix the forward applies, and causal attention's
scores and weighted values; the recompute not counted) over the untraced
window's wall time per step, against 989 TFLOP/s."""
from perfbench import roofline


def read(rec):
    if rec.get("kind") != "train" or not rec.get("wall_s"):
        return None
    rate = rec["steps"] * rec["model_flops_per_step"] / rec["wall_s"]
    return 100.0 * rate / roofline.PEAK_OPS["bf16"]
