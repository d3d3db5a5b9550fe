"""mla.attn_pct.train: the share of a traced step's device busy time spent
in latent attention: the device time of the kernels launched under the
program's ``attn.mla`` spans (the four projections, the latent's norm,
RoPE and the f32 blockwise attention) over the busy time.  It covers the
forward and the block's recompute: the backward runs on autograd's
thread, where no layer span is open, and is not counted."""


def read(rec):
    layer = rec.get("layer_spans")
    if rec.get("kind") != "train" or not layer or "trace" not in rec \
            or not rec["trace"].get("busy_s"):
        return None
    return 100.0 * layer.get("attn.mla", 0.0) / rec["trace"]["busy_s"]
