"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

The paper's simulate-before-implement loop for one GEMM on an NVIDIA H100:
``gemm.plan()`` picks a blocking from the analytic model, ``plan.execute``
runs a hand-written CUDA kernel with exactly that blocking (``kernels/``),
``measure`` times it, ``machines.Calibrator`` fits the card's rates and
``measure.validate`` reports the prediction error.

The package imports ``torch`` and never ``jax``, nor anything of the JAX
package ``repro``: the NumPy-only modules it needs are copies with their
imports rewritten, under the same module names, and its file formats
(machine manifests, plan caches, sample stores) are the same.
"""
