"""grouped_wgmma_roofline.pass: the grouped bf16 kernel's share of its
roofline over a pass: the frozen bound of the pass's grouped products
(every expert's rows, weights and outputs) over the kernel's device time over
the traced passes."""
from perfbench import roofline


def read(rec):
    if rec.get("kind") != "gemm_pass" or "trace" not in rec:
        return None
    grouped = [p for p in rec["products"] if "groups" in p]
    if not grouped:
        return None
    dev, _ = roofline.kernel_seconds(rec["trace"]["kernels"],
                                     "grouped_wgmma")
    return roofline.roofline_pct(
        rec["traced_passes"] * roofline.pass_bound_s(grouped, rec["dtype"]),
        dev)
