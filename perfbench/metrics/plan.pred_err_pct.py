"""plan.pred_err_pct: how far the tile model's prediction of a pass's
planned products lies from their device time, in percent of the device
time.  The prediction is the sum over the pass's dense products of the
planned tile's predicted seconds on the fitted ``h100-measured`` machine;
the device time is the trace's time of the dense kernel over the passes
traced."""
from perfbench import roofline

KERNEL = {"bf16": "wgmma_gemm", "int8": "wgmma_gemm_s8"}


def read(rec):
    if rec.get("kind") != "gemm_pass" or not rec.get("plan"):
        return None
    dev, _ = roofline.kernel_seconds(rec["trace"]["kernels"],
                                     KERNEL[rec["dtype"]])
    if dev <= 0:
        return None
    measured = dev / rec["traced_passes"]
    pred = sum(p["count"] * p["pred_measured_s"] for p in rec["plan"])
    return 100.0 * abs(pred - measured) / measured
