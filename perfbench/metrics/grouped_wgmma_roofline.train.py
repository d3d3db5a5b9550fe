"""grouped_wgmma_roofline.train: the grouped bf16 kernel's share of its
roofline over a training step of the MoE cell: the frozen bound of the
grouped products a step sends to it (each MoE layer's gate, up and down
over the held experts at their mean load, four times: forward, the
block's recompute, dx and dw; ``roofline_moe.grouped_products``) over the
kernel's device time over the traced steps.  The bound counts the mean
load's rows, not the rows padded to the largest load, so padding shows as
a lower share."""
from perfbench import roofline


def read(rec):
    if rec.get("kind") != "train" or "trace" not in rec \
            or not rec.get("grouped_products"):
        return None
    dev, _ = roofline.kernel_seconds(rec["trace"]["kernels"],
                                     "grouped_wgmma")
    return roofline.roofline_pct(
        rec["traced_steps"]
        * roofline.pass_bound_s(rec["grouped_products"], "bf16"), dev)
