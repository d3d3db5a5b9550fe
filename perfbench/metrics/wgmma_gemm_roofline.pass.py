"""wgmma_gemm_roofline.pass: the dense bf16 GEMM kernel's share of its
roofline over a pass: the frozen bound of the pass's dense products (the
larger of operations over 989 TFLOP/s and bytes over 3.35 TB/s, each) over
the kernel's device time over the traced passes."""
from perfbench import roofline


def read(rec):
    if rec.get("kind") != "gemm_pass" or rec.get("dtype") != "bf16" \
            or "trace" not in rec:
        return None
    dense = [p for p in rec["products"] if "groups" not in p]
    dev, _ = roofline.kernel_seconds(rec["trace"]["kernels"], "wgmma_gemm")
    return roofline.roofline_pct(
        rec["traced_passes"] * roofline.pass_bound_s(dense, "bf16"), dev)
