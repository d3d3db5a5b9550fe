"""The benchmark's frozen yardstick: the card's peaks and the counting of
operations and bytes.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  A roofline share is the
least time the card could take (the larger of operations over the peak
rate and bytes over the HBM rate) over the time measured; every input byte
counts as read once and every output byte as written once.

Nothing here imports the program: later changes to it cannot move these
numbers.
"""
from __future__ import annotations

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bf16": 2, "f32": 4, "int8": 1}
OUT_BYTES = {"bf16": 2, "f32": 4, "int8": 4}


def product_ops(p: dict) -> float:
    """Operations of one product ``{"m", "n", "k", "groups"}`` (a grouped
    product is ``groups`` independent m x n x k products)."""
    return 2.0 * p["m"] * p["n"] * p["k"] * p.get("groups", 1)


def product_bytes(p: dict, dtype: str) -> float:
    """A and B read once, C written once."""
    g = p.get("groups", 1)
    e = ELEM_BYTES[dtype]
    return g * (e * (p["m"] * p["k"] + p["k"] * p["n"])
                + OUT_BYTES[dtype] * p["m"] * p["n"])


def product_bound_s(p: dict, dtype: str) -> float:
    """The least time one product can take on the card."""
    return max(product_ops(p) / PEAK_OPS[dtype],
               product_bytes(p, dtype) / HBM_BYTES_PER_S)


def pass_ops(products: list[dict]) -> float:
    """Operations of one pass over a frozen product list (each entry's
    ``count`` is how many times a pass runs it)."""
    return sum(p["count"] * product_ops(p) for p in products)


def pass_bound_s(products: list[dict], dtype: str) -> float:
    return sum(p["count"] * product_bound_s(p, dtype) for p in products)


def roofline_pct(bound_s: float, measured_s: float) -> float | None:
    """The share of the bound, in percent; None where nothing was
    measured (never 0)."""
    if not measured_s or measured_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / measured_s


# ---------------------------------------------------------------------------
# Training: the planned products a dense step sends to the GEMM kernel, and
# the model's operations a step.
# ---------------------------------------------------------------------------


def train_gemm_products(arch: dict, tokens: int) -> list[dict]:
    """The products of one training step of a dense model on the planned
    GEMM kernel, as the model sends them (gate, up and down a layer, the
    tied head): a layer's product runs four times a step (forward, the
    block's recompute, dA, dB), the head three (forward, dA, dB).  Every
    run of a product has the same operations (dA and dB permute m, n, k)
    and, at these sizes, the same bound."""
    d, f = arch["hidden_size"], arch["intermediate_size"]
    layers = arch["num_hidden_layers"]
    vocab = padded_vocab(arch["vocab_size"])
    return [
        {"name": "gate", "m": tokens, "n": f, "k": d, "count": 4 * layers},
        {"name": "up", "m": tokens, "n": f, "k": d, "count": 4 * layers},
        {"name": "down", "m": tokens, "n": d, "k": f, "count": 4 * layers},
        {"name": "head", "m": tokens, "n": vocab, "k": d, "count": 3},
    ]


def padded_vocab(vocab: int) -> int:
    """The embedding table's rows: the vocabulary padded to a multiple of
    256, as the model stores it."""
    return 256 * -(-vocab // 256)


def dense_param_counts(arch: dict) -> dict:
    """Parameters of a dense decoder with a tied head, by kind: the
    matrices the forward multiplies by (``matmul``: layers' projections
    and the head, counted once at the logical vocabulary), and the rest."""
    d, f = arch["hidden_size"], arch["intermediate_size"]
    h, kv = arch["num_attention_heads"], arch["num_key_value_heads"]
    hd = arch.get("head_dim") or d // h
    layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
    return {"matmul": arch["num_hidden_layers"] * layer
            + arch["vocab_size"] * d}


def train_model_flops(arch: dict, batch: int, seq: int) -> float:
    """Model operations of one training step (forward and backward, three
    times the forward; the recompute is not counted): two a multiply-add
    over every matrix the forward applies, plus causal attention's scores
    and weighted values (each query position attends to itself and the
    positions before it)."""
    tokens = batch * seq
    h = arch["num_attention_heads"]
    hd = arch.get("head_dim") or arch["hidden_size"] // h
    fwd = 2.0 * dense_param_counts(arch)["matmul"] * tokens
    # scores q.k and p.v: 2 * 2 * h * hd per visible (query, key) pair
    pairs = batch * seq * (seq + 1) / 2
    fwd += arch["num_hidden_layers"] * 4.0 * h * hd * pairs
    return 3.0 * fwd


# ---------------------------------------------------------------------------
# Kernels by name in the device trace
# ---------------------------------------------------------------------------

#: the hand-written kernels a roofline share reads, by the name the
#: profiler gives their launches (``wgmma_gemm<`` is the dense bf16 kernel,
#: not the int8 ``wgmma_gemm_s8<``)
KERNELS = {"wgmma_gemm": r"\bwgmma_gemm<",
           "wgmma_gemm_s8": r"\bwgmma_gemm_s8<",
           "grouped_wgmma": r"\bgrouped_wgmma<"}


def kernel_seconds(kernels: dict, kernel: str) -> tuple[float, int]:
    """(device seconds, launches) of ``kernel`` in a trace's
    ``{name: [seconds, count]}``."""
    import re
    pat = re.compile(KERNELS[kernel])
    s = n = 0
    for name, (sec, count) in kernels.items():
        if pat.search(name):
            s += sec
            n += count
    return s, n
