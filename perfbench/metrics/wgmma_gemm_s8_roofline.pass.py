"""wgmma_gemm_s8_roofline.pass: the int8 GEMM kernel's share of its
roofline over a pass: the frozen bound of the pass's products (operations
over 1,979 TOP/s or bytes over 3.35 TB/s, int32 outputs) over the kernel's
device time over the traced passes; B's transposed copies are another
kernel's."""
from perfbench import roofline


def read(rec):
    if rec.get("kind") != "gemm_pass" or rec.get("dtype") != "int8" \
            or "trace" not in rec:
        return None
    dense = [p for p in rec["products"] if "groups" not in p]
    dev, _ = roofline.kernel_seconds(rec["trace"]["kernels"],
                                     "wgmma_gemm_s8")
    return roofline.roofline_pct(
        rec["traced_passes"] * roofline.pass_bound_s(dense, "int8"), dev)
