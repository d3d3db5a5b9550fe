"""moe.pad_pct.train: the rows the dropless dispatch pads, over the rows
it routes to the held experts, in the traced steps: each held expert's
rows are padded to the largest load of the layer's held experts, rounded
up to 64.  From the program's counters ``moe.rows_padded`` and
``moe.rows_routed`` (one reading a MoE layer's forward; the block's
recompute pads the same rows and reads nothing)."""


def read(rec):
    counters = rec.get("counters") or {}
    routed = counters.get("moe.rows_routed")
    if rec.get("kind") != "train" or not routed:
        return None
    return 100.0 * counters["moe.rows_padded"] / routed
