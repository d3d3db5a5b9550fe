"""wgmma_gemm_roofline.train: the dense bf16 GEMM kernel's share of its
roofline over a training step: the frozen bound of the products a step
sends to it (each layer's gate, up and down four times: forward, the
block's recompute, dA and dB; the tied head three times) over the
kernel's device time over the traced steps.  Silent where the step's
launches are not those products (the counts then describe other work)."""
from perfbench import roofline


def read(rec):
    if rec.get("kind") != "train" or "trace" not in rec:
        return None
    prods = rec["gemm_products"]
    if rec["launches_per_step"] != sum(p["count"] for p in prods):
        return None
    dev, _ = roofline.kernel_seconds(rec["trace"]["kernels"], "wgmma_gemm")
    return roofline.roofline_pct(
        rec["traced_steps"] * roofline.pass_bound_s(prods, "bf16"), dev)
