"""Public wrappers for the GEMM and attention kernels.

``matmul`` routes through the unified plan/execute API
(``repro_torch.gemm``): it plans on the ``cuda`` backend — the paper's
analytical tile selection, memoised in the process-level plan cache — and
executes the frozen plan with the hand-written kernels.  ``grouped_gemm``
runs the grouped (per-expert) kernel, ``flash_attention`` the flash
attention kernel (the RMSNorm kernel's entry point is
``repro_torch.kernels.rmsnorm.rmsnorm``, as in the JAX package).  There is
no ``interpret`` argument and no platform switch here:
CUDA tensors launch the kernels, CPU tensors run their plain versions, and
anything else raises.
"""
from __future__ import annotations

from repro_torch import gemm as gemm_api
from repro_torch.core.tpu_model import TileConfig
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import grouped_gemm as grouped


def matmul(a, b, *, tile: TileConfig | None = None):
    """C = A @ B through the planned CUDA kernel (or, for CPU tensors, its
    plain version)."""
    m, k = a.shape
    n = b.shape[1]
    options = {} if tile is None else {"tile": tile}
    plan = gemm_api.plan((m, n, k), backend="cuda",
                         dtype=gemm_api.dtype_tag(a.dtype), **options)
    return plan.execute(a, b)


def grouped_gemm(x, w):
    """x: (E, C, D) @ w: (E, D, F) -> (E, C, F) (MoE expert FFN)."""
    return grouped.grouped_gemm(x, w)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """q, k, v: (B, S, H, D) -> (B, S, H, D) (KV heads already repeated)."""
    return flash.flash_attention_fwd(q, k, v, causal=causal, block_q=block_q,
                                     block_k=block_k)
