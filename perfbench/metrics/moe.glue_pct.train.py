"""moe.glue_pct.train: the share of a traced step's device busy time spent
in the MoE layer's routing and data movement: the device time of the
kernels launched under the program's ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans (the router, the top-k, the balance loss, the
slots, the largest load's read, the gather into the experts' rows and the
weighted combine; not the expert or shared products), over the busy time
(the union of the device's work).  It covers the forward and the block's
recompute: the backward of the same operations runs on autograd's
thread, where no layer span is open, and is not counted."""

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(rec):
    layer = rec.get("layer_spans")
    if rec.get("kind") != "train" or not layer or "trace" not in rec \
            or not rec["trace"].get("busy_s"):
        return None
    return 100.0 * sum(layer.get(s, 0.0) for s in SPANS) \
        / rec["trace"]["busy_s"]
