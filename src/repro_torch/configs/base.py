"""Config schema for architectures, parallelism, training and serving.

Every assigned architecture gets a ``ModelConfig`` with its exact published
hyper-parameters plus a ``smoke()`` reduction of the same family used by the
CPU tests.  Parallelism knobs live in ``ParallelConfig`` and are resolved
against a concrete mesh at sharding-rule construction time
(``runtime/sharding.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Sequence


def _ceil_to(x: int, mult: int) -> int:
    return mult * int(math.ceil(x / mult))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2) -------------------------------------------------------
    ssm_state: int = 0              # N
    ssm_head_dim: int = 64          # P
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- xLSTM ---------------------------------------------------------------
    lstm_heads: int = 4
    mlstm_expand: int = 2
    xlstm_chunk: int = 128

    # --- block layout --------------------------------------------------------
    # per-layer block kinds; empty -> ["attn"] * n_layers.
    # kinds: attn | moe | mamba2 | mlstm | slstm | shared_attn
    block_pattern: tuple = ()
    # zamba2: one set of tied attn+mlp weights used at every shared_attn site.
    shared_block: bool = False

    # --- modality frontend (stub per assignment) -----------------------------
    frontend: str = "none"          # none | audio_stub | vision_stub
    num_prefix_tokens: int = 0      # vision: patch count (prefix-LM mask)

    # --- numerics ------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # kimi-k2 uses bfloat16 (DESIGN.md §4)
    # int8 KV cache (per-entry scales): halves the decode cache-read traffic
    # — the dominant real decode cost (EXPERIMENTS.md §Perf iteration D2).
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8

    # --- attention scalability ----------------------------------------------
    attn_chunk: int = 1024          # KV-chunk for the blockwise reference path

    # --- designs the JAX package does not have: DeepSeekV3Config's fields,
    # plain class attributes here, so that this class's fields stay the
    # JAX package's one for one -----------------------------------------------
    attn_type = "gqa"
    router = "softmax"
    kv_lora_rank = qk_nope_head_dim = qk_rope_head_dim = v_head_dim = 0
    n_shared_experts = 0
    routed_scale = 1.0
    bias_rate = bias_init_std = 0.0
    experts_held = ()
    first_k_dense = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if not self.block_pattern:
            kind = "moe" if self.n_experts else "attn"
            pattern = ["attn"] * self.first_k_dense + [kind] * (
                self.n_layers - self.first_k_dense)
            object.__setattr__(self, "block_pattern", tuple(pattern))
        assert len(self.block_pattern) == self.n_layers, (
            f"{self.name}: pattern len {len(self.block_pattern)} != {self.n_layers}")

    # vocab padded for TP-divisibility (granite's 49155 is not 16-divisible).
    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def mlstm_inner(self) -> int:
        return self.mlstm_expand * self.d_model

    @property
    def n_experts_held(self) -> int:
        """Routed experts whose weights this device holds."""
        return len(self.experts_held) or self.n_experts

    @property
    def qk_head_dim(self) -> int:   # MLA: the width q.k runs over
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def block_counts(self) -> dict[str, int]:
        """Occurrences of each block kind in ``block_pattern`` — the layer
        census ``param_count`` sums over and the serving footprint model
        (``repro.serving.footprint``) charges per-kind decode state
        against."""
        return dict(collections.Counter(self.block_pattern))

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6 N D)."""
        d, hd = self.d_model, self.head_dim
        n = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        shared = 0
        if self.attn_type == "mla":
            r, h = self.kv_lora_rank, self.n_heads
            attn = (d * h * self.qk_head_dim
                    + d * (r + self.qk_rope_head_dim) + r
                    + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                    + h * self.v_head_dim * d)
        else:
            attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d)
        for kind, cnt in self.block_counts().items():
            if kind in ("attn", "shared_attn"):
                per = attn
                if self.d_ff:
                    per += 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
                if kind == "shared_attn" and self.shared_block:
                    shared = per
                    continue
                n += cnt * per
            elif kind == "moe":
                per = attn + self.n_experts_held * 3 * d * self.moe_d_ff
                per += d * self.n_experts  # router
                if self.router == "sigmoid":
                    per += self.n_experts  # its correction bias
                    per += 3 * d * self.n_shared_experts * self.moe_d_ff
                n += cnt * per
            elif kind == "mamba2":
                di = self.d_inner
                per = d * (2 * di + 2 * self.ssm_heads * self.ssm_state
                           + self.ssm_heads) + di * d
                n += cnt * per
            elif kind == "mlstm":
                di = self.mlstm_inner
                per = d * 3 * di + 2 * di + di * d + 2 * d * di
                n += cnt * per
            elif kind == "slstm":
                per = 4 * d * d + 4 * d * d // self.lstm_heads + 2 * d * d
                n += cnt * per
        n += shared
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count; of the
        experts held, the share routed to them)."""
        if not self.n_experts:
            return self.param_count()
        held = self.n_experts_held
        if held == self.n_experts:
            dead = (self.n_experts - self.experts_per_token) * 3 * self.d_model * self.moe_d_ff
        else:
            dead = (held - self.experts_per_token * held / self.n_experts
                    ) * 3 * self.d_model * self.moe_d_ff
        moe_layers = sum(1 for k in self.block_pattern if k == "moe")
        return int(self.param_count() - moe_layers * dead)


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    """DeepSeek-V3's block, which the JAX package does not have (the
    port's ``models/attention.py`` ``apply_mla`` and ``models/moe.py``
    ``apply_moe_sigmoid``; one device, or replicated over the data axes).

    * Latent attention (``attn_type="mla"``): no query low rank; a joint
      key-value latent of ``kv_lora_rank`` with its RMSNorm; q.k over
      ``qk_nope_head_dim + qk_rope_head_dim`` dims, RoPE on the rope part
      (the key's one vector shared by every head); values of
      ``v_head_dim``.
    * The sigmoid router (``router="sigmoid"``): sigmoid scores over the
      ``n_experts`` routed over, the top ``experts_per_token`` of scores
      plus a correction bias chosen (drawn at N(0, ``bias_init_std``);
      training moves it by ``bias_rate`` a step), the chosen scores
      normalised and scaled by ``routed_scale``; no token dropped;
      ``n_shared_experts`` shared experts of width ``moe_d_ff`` on every
      token; the sequence-wise balance loss at ``router_aux_coef``.
      ``experts_held`` names the experts whose weights this device holds
      (empty: all of them).
    * ``first_k_dense`` leading layers outside the repeating pattern
      (``first_k_dense_replace``), each its own remat unit, under
      ``lead`` in the parameter tree.
    """
    attn_type: str = "mla"          # gqa | mla
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    router: str = "sigmoid"         # softmax | sigmoid
    n_shared_experts: int = 0
    routed_scale: float = 1.0
    bias_rate: float = 0.0
    bias_init_std: float = 0.0
    experts_held: tuple = ()
    first_k_dense: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: training or serving geometry."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Parallelism & distributed-optimization knobs."""
    fsdp: bool = False              # shard params/opt-state over the data axis
    remat: str = "block"            # none | block
    microbatches: int = 1           # gradient-accumulation steps
    pipeline_stages: int = 1        # >1 -> GPipe over the pod axis
    grad_compression: str = "none"  # none | int8_ef (cross-pod int8 + error feedback)
    scan_layers: bool = True
    # beyond-paper hillclimb knobs (EXPERIMENTS.md §Perf)
    seq_shard_long_kv: bool = True  # SP: shard long decode KV over data axis
    chunked_logits: int = 0         # >0: compute CE loss in vocab-chunks


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
