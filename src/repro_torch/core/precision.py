"""Per-operand dtype configurations for mixed-precision GEMM planning.

The source paper prices a GEMM for a single dtype per plan; its sequel —
"The Cambrian Explosion of Mixed-Precision Matrix Multiplication for
Quantized Deep Learning Inference" (arXiv 2506.11728) — shows edge inference
kernels take *per-operand* dtypes: int8/int4 inputs accumulated in int32,
or a wide activation operand quantized on the fly into a narrow micro-kernel
panel.  :class:`PrecisionConfig` is that triple, plus an optional KV-cache
dtype for the serving layer.

Modelling conventions (shared by both cost models):

* The **compute dtype** is the narrower of the two input operands — the
  micro-kernel / MXU path the arithmetic runs on.  Storage widths come from
  :data:`DTYPE_WIDTH`; ``int4`` is modelled at 1 byte (unpacked panels), so
  its advantage is purely the arithmetic rate, never phantom half-bytes.
* A **uniform** config (``a == b`` with the default accumulator) is, by
  definition, the existing single-dtype path: planners normalize it away
  (``GemmProblem`` drops it and keeps the plain dtype), so uniform configs
  are bit-identical to pre-mixed-precision plans.
* A *wider-than-compute* operand pays quantize/dequantize traffic: the
  ratio of extra bytes moved per compute-width byte,
  ``(width(op) - width(compute)) / width(compute)``, clamped at zero.
  The same ratios feed ``core/variants.traffic_terms[_batch]`` (per-term
  ``quant_*`` charges at the level the operand is packed/streamed) and
  ``core/tpu_model.estimate[_batch]`` (extra HBM bytes).
* The machine-side arithmetic rate resolves through the spec's
  ``rates_mixed`` table keyed by :meth:`PrecisionConfig.key` (e.g.
  ``"int4xint8->int32"``), falling back to the uniform ``arith_rate`` entry
  of the compute dtype when the mixed key is absent.
"""
from __future__ import annotations

import dataclasses

#: storage width (bytes) of each supported tag.  int4 panels are modelled
#: unpacked at one byte — see module docstring.
DTYPE_WIDTH = {"int4": 1.0, "int8": 1.0, "bf16": 2.0, "f32": 4.0,
               "int32": 4.0}
#: nominal bit width, used for the accuracy proxy and narrowness ordering.
DTYPE_BITS = {"int4": 4, "int8": 8, "bf16": 16, "f32": 32, "int32": 32}
#: tags allowed as A/B input operands.
OPERAND_DTYPES = ("int4", "int8", "bf16", "f32")
#: default accumulator per compute dtype (the sequel paper's convention:
#: integer inputs accumulate in int32, floating inputs in f32).
DEFAULT_ACC = {"int4": "int32", "int8": "int32", "bf16": "f32", "f32": "f32"}


def _narrower(a: str, b: str) -> str:
    """The narrower of two operand tags (ties broken by name for
    determinism — irrelevant in practice since equal-width tags tie only
    when identical or int4/int8, where bits still differ)."""
    return min((a, b), key=lambda t: (DTYPE_BITS[t], t))


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """A per-operand dtype assignment ``C[acc] (+)= A[a] . B[b]``.

    ``kv_dtype`` rides along for the serving layer (KV-cache storage dtype);
    it never affects GEMM cost, only the deployment footprint.
    """

    a_dtype: str
    b_dtype: str
    acc_dtype: str = ""
    kv_dtype: str | None = None

    def __post_init__(self):
        for role, tag in (("a_dtype", self.a_dtype),
                          ("b_dtype", self.b_dtype)):
            if tag not in OPERAND_DTYPES:
                raise ValueError(
                    f"PrecisionConfig.{role}={tag!r} is not an operand "
                    f"dtype; have {list(OPERAND_DTYPES)}")
        if not self.acc_dtype:
            object.__setattr__(self, "acc_dtype",
                               DEFAULT_ACC[self.compute_dtype])
        if self.acc_dtype not in DTYPE_WIDTH:
            raise ValueError(
                f"PrecisionConfig.acc_dtype={self.acc_dtype!r} is not a "
                f"known dtype; have {sorted(DTYPE_WIDTH)}")
        if self.kv_dtype is not None and self.kv_dtype not in OPERAND_DTYPES:
            raise ValueError(
                f"PrecisionConfig.kv_dtype={self.kv_dtype!r} is not an "
                f"operand dtype; have {list(OPERAND_DTYPES)}")

    # -- identity ------------------------------------------------------------

    @property
    def compute_dtype(self) -> str:
        """The dtype the arithmetic runs at: the narrower input operand."""
        return _narrower(self.a_dtype, self.b_dtype)

    @property
    def is_uniform(self) -> bool:
        """True when this config *is* the existing single-dtype path:
        identical operands with the default accumulator.  Uniform configs
        are normalized away by the planners and never consult
        ``rates_mixed`` or emit quantize traffic."""
        return (self.a_dtype == self.b_dtype
                and self.acc_dtype == DEFAULT_ACC[self.a_dtype])

    def key(self) -> str:
        """The machine-table / sweep-row key, e.g. ``"int4xint8->int32"``."""
        return f"{self.a_dtype}x{self.b_dtype}->{self.acc_dtype}"

    def __str__(self) -> str:
        base = self.key()
        return base if self.kv_dtype is None else f"{base}@kv={self.kv_dtype}"

    # -- cost-model inputs ---------------------------------------------------

    def widths(self) -> tuple[float, float, float]:
        """Storage widths (bytes) of (A, B, accumulator)."""
        return (DTYPE_WIDTH[self.a_dtype], DTYPE_WIDTH[self.b_dtype],
                DTYPE_WIDTH[self.acc_dtype])

    def quant_ratios(self, compute_bytes: float) -> tuple[float, float, float]:
        """Quantize/dequantize traffic ratios for (A, B, C).

        Each is the *extra* bytes moved per byte of the operand's
        compute-width traffic term: ``(width(op) - compute) / compute``,
        clamped at zero (an operand narrower than the compute width is not
        credited — the calibrated uniform rates already absorb the native
        accumulator traffic, see docs/COST_MODELS.md).
        """
        s = float(compute_bytes)
        wa, wb, wc = self.widths()
        return (max(0.0, (wa - s) / s), max(0.0, (wb - s) / s),
                max(0.0, (wc - s) / s))

    @property
    def accuracy_proxy(self) -> float:
        """Crude monotone accuracy stand-in for deployment ranking:
        narrowest input bits over 16, capped at 1.0 (bf16 is the reference
        inference precision) — int4 -> 0.25, int8 -> 0.5, bf16/f32 -> 1.0.
        A proxy for *relative ordering only*, not a quality prediction."""
        bits = min(DTYPE_BITS[self.a_dtype], DTYPE_BITS[self.b_dtype])
        return min(1.0, bits / 16.0)

    # -- construction --------------------------------------------------------

    @classmethod
    def uniform(cls, dtype: str, kv_dtype: str | None = None
                ) -> "PrecisionConfig":
        """The config equivalent to the plain single-dtype path."""
        return cls(dtype, dtype, kv_dtype=kv_dtype)

    @classmethod
    def parse(cls, text: str) -> "PrecisionConfig":
        """Parse ``"AxB"``, ``"AxB->ACC"`` or ``"AxB->ACC@kv=KV"`` (the
        :meth:`key` / CLI form); the accumulator defaults per
        :data:`DEFAULT_ACC` when omitted."""
        body, _, kv = text.partition("@kv=")
        left, _, acc = body.partition("->")
        a, sep, b = left.partition("x")
        if not sep or not a or not b:
            raise ValueError(
                f"cannot parse precision {text!r}; expected 'AxB' or "
                f"'AxB->ACC', e.g. 'int8xint8' or 'f32xint8->int32'")
        return cls(a, b, acc_dtype=acc, kv_dtype=kv or None)

    @classmethod
    def coerce(cls, obj) -> "PrecisionConfig | None":
        """None passes through; strings parse; configs are returned as-is."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, str):
            return cls.parse(obj)
        raise TypeError(
            f"cannot interpret {obj!r} as a PrecisionConfig; pass a "
            f"PrecisionConfig, a key string like 'int8xint8->int32', or None")
