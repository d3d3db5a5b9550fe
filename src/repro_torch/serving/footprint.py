"""Serving memory-footprint model: weights + decode state + workspace.

The paper's central discipline is that a blocked algorithm is only feasible
when its working set fits each level of the memory hierarchy; deployment
planning applies the same rule one level up.  A serving configuration
``(model config, batch, dtype)`` occupies the machine's *deployment* memory
level (HBM on the TPU and the H100, main memory on the edge parts — see
:meth:`repro_torch.machines.MachineSpec.memory_budget`) with three
components:

* **weights** — every parameter stored once in the serving dtype;
* **KV cache / recurrent state** — per-slot decode state for ``batch``
  concurrent sequences at ``max_len`` positions, charged per block kind of
  the config's ``block_pattern`` (attention layers hold K/V panels, Mamba-2
  and xLSTM layers hold fixed-size recurrent state);
* **activation workspace** — the transient per-step buffers of one decode
  step (double-buffered widest layer activation, logits included).

All formulas are closed-form functions of
:class:`repro_torch.configs.base.ModelConfig` fields — no model is
instantiated — mirroring how the analytic GEMM simulators predict from
shapes alone.  :func:`repro_torch.serving.report.plan_deployment` uses
:func:`footprint` to prune infeasible ``(machine, dtype, batch)`` cells
*before* the design-space sweep plans them.  The counterpart of
``repro.serving.footprint``, the same integers; the decode-state bytes
equal the bytes of the port's caches (``LM.init_cache``), which follow the
layouts charged here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tpu_model import DTYPE_BYTES

#: dtype tags accepted by the footprint model, with byte widths; the
#: cost-model tags (``repro_torch.core.tpu_model.DTYPE_BYTES``) plus the
#: configs' long-form names.
_BYTES = dict(DTYPE_BYTES, bfloat16=2, float32=4)

#: recurrent/accumulator state is carried in f32 by the model zoo
#: (``models/ssm.py``, ``models/xlstm.py``) regardless of compute dtype.
_STATE_BYTES = 4


def dtype_bytes(tag: str) -> int:
    """Bytes per element of a footprint dtype tag.

    Raises:
        KeyError: for a tag neither the cost models nor the configs use.
    """
    try:
        return _BYTES[tag]
    except KeyError:
        raise KeyError(f"unknown dtype tag {tag!r}; have "
                       f"{sorted(_BYTES)}") from None


@dataclasses.dataclass(frozen=True)
class Footprint:
    """Modelled deployment-memory occupancy of one serving configuration."""

    config: str                 # model-config name
    batch: int
    max_len: int
    dtype: str                  # serving (weights/activation) dtype tag
    kv_dtype: str               # KV-cache dtype tag
    weights_bytes: int
    kv_cache_bytes: int         # attention K/V panels + recurrent state
    activation_bytes: int       # transient per-step workspace

    @property
    def total_bytes(self) -> int:
        return self.weights_bytes + self.kv_cache_bytes \
            + self.activation_bytes

    def fits(self, budget_bytes: int) -> bool:
        """Whether this configuration fits a deployment-memory budget."""
        return self.total_bytes <= budget_bytes

    def headroom_bytes(self, budget_bytes: int) -> int:
        """Budget minus footprint; negative when the config does not fit."""
        return int(budget_bytes) - self.total_bytes

    def as_dict(self) -> dict:
        return {
            "config": self.config, "batch": self.batch,
            "max_len": self.max_len, "dtype": self.dtype,
            "kv_dtype": self.kv_dtype,
            "weights_bytes": self.weights_bytes,
            "kv_cache_bytes": self.kv_cache_bytes,
            "activation_bytes": self.activation_bytes,
            "total_bytes": self.total_bytes,
        }


def _per_slot_state_bytes(cfg: ModelConfig, max_len: int, kv_dtype: str,
                          act_bytes: int) -> int:
    """Decode-state bytes one sequence slot holds across all layers.

    Charged per block kind (``cfg.block_counts()``), matching the cache
    layouts of the model zoo:

    * ``attn`` / ``shared_attn`` / ``moe`` (whose attention half caches
      identically): K and V panels ``(n_kv_heads, max_len, head_dim)`` in
      the KV dtype; an int8 cache adds two f32 scale vectors per position
      (``models/attention.py``).
    * ``mamba2``: the f32 SSM state ``(heads, head_dim, state)`` plus the
      conv ring buffer ``(conv-1, d_inner)`` in the serving dtype
      (``models/ssm.py``).
    * ``mlstm``: the f32 matrix state ``(heads, head_dim+1, head_dim)``
      plus the conv ring buffer (``models/xlstm.py``).
    * ``slstm``: the three f32 ``d_model`` vectors ``(h, c, n)``.

    Raises:
        ValueError: on a block kind the model zoo does not define (the
        model constructor would reject it too — better than silently
        billing a cache the block does not have).
    """
    kv_bytes = dtype_bytes(kv_dtype)
    per_slot = 0
    for kind, count in cfg.block_counts().items():
        if kind in ("attn", "shared_attn", "moe"):
            panel = cfg.n_kv_heads * max_len * cfg.head_dim
            per = 2 * panel * kv_bytes
            if kv_dtype == "int8":
                per += 2 * cfg.n_kv_heads * max_len * 4   # k/v scales, f32
        elif kind == "mamba2":
            per = (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                   * _STATE_BYTES
                   + (cfg.ssm_conv - 1) * cfg.d_inner * act_bytes)
        elif kind == "mlstm":
            head = cfg.mlstm_inner // cfg.lstm_heads
            per = (cfg.lstm_heads * (head + 1) * head * _STATE_BYTES
                   + (cfg.ssm_conv - 1) * cfg.mlstm_inner * act_bytes)
        elif kind == "slstm":
            per = 3 * cfg.d_model * _STATE_BYTES
        else:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r} in "
                             f"block_pattern — cannot model its decode "
                             f"state")
        per_slot += count * per
    return per_slot


def footprint(cfg: ModelConfig, *, batch: int, max_len: int,
              dtype: str = "bf16", kv_dtype: str | None = None) -> Footprint:
    """Model the deployment-memory footprint of one serving configuration.

    Args:
        cfg: the model config (only its shape fields are read).
        batch: number of concurrent decode slots (``ServingEngine``'s
            ``max_batch``).
        max_len: per-slot cache length in tokens.
        dtype: serving dtype tag for weights and activations (the
            autoconfigure dtype axis: ``"bf16"``, ``"int8"``, ``"f32"`` or
            the configs' long-form names).
        kv_dtype: KV-cache dtype tag; defaults to the config's
            ``kv_cache_dtype`` when that is int8, else to ``dtype``.

    Returns:
        A :class:`Footprint` with the weights / KV-state / workspace split.

    Raises:
        KeyError: on an unknown dtype tag.
        ValueError: on a non-positive batch or max_len.
    """
    if batch < 1 or max_len < 1:
        raise ValueError(f"degenerate serving config batch={batch} "
                         f"max_len={max_len}")
    wbytes = dtype_bytes(dtype)
    if kv_dtype is None:
        kv_dtype = "int8" if cfg.kv_cache_dtype == "int8" else dtype
    dtype_bytes(kv_dtype)   # validate the tag up front

    weights = cfg.param_count() * wbytes
    kv_cache = batch * _per_slot_state_bytes(cfg, max_len, kv_dtype, wbytes)

    # transient decode-step workspace: the widest single-layer activation
    # (QKV / gate+up / routed-expert / logits row block), double-buffered
    # (producer + consumer live across one planned GEMM).
    widest = max(
        cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim,
        2 * cfg.d_ff,
        2 * cfg.moe_d_ff * max(1, cfg.experts_per_token),
        cfg.padded_vocab,
    )
    activations = 2 * batch * (cfg.d_model + widest) * wbytes

    return Footprint(
        config=cfg.name, batch=batch, max_len=max_len, dtype=dtype,
        kv_dtype=kv_dtype, weights_bytes=int(weights),
        kv_cache_bytes=int(kv_cache), activation_bytes=int(activations),
    )
