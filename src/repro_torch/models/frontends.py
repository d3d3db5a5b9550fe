"""Modality frontends — stubs, as in the JAX package.

The audio and vision architecture entries specify the transformer backbone
only; the inputs are *precomputed* frame / patch embeddings.  These stubs
project the provided embeddings into the backbone width (one learned
linear map), so the backbone stays end-to-end trainable while the real
EnCodec / SigLIP towers stay out of scope.  The counterpart of
``repro.models.frontends``: ``proj`` is a plain product there, so it is
``torch.matmul`` here.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import WHOLE, Cut, MeshInfo, dense_init


def frontend_specs(cfg, mesh: MeshInfo) -> dict:
    return {} if cfg.frontend == "none" else {"proj": (None, None)}


def init_frontend(gen, cfg, mesh: MeshInfo, dtype, device,
                  cut: Cut = WHOLE):
    if cfg.frontend == "none":
        return {}
    d = cfg.d_model
    return {"proj": dense_init(gen, d, (d, d), dtype, device,
                               cut.of("proj"))}


def apply_frontend(params, embeddings, cfg):
    """embeddings: (B, T, D) precomputed frame/patch features -> (B, T, D),
    in the promoted dtype of the two operands (as ``@`` promotes in JAX)."""
    proj = params["proj"]
    dt = torch.promote_types(embeddings.dtype, proj.dtype)
    return torch.matmul(embeddings.to(dt), proj.to(dt))
