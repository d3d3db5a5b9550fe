"""Build and load the CUDA kernels: ``nvcc`` into shared libraries, ``ctypes``.

Each source of ``kernels/csrc/`` is compiled at first use for ``sm_90a``
into one shared library per element type, all in parallel (one ``nvcc``
process per library): ``gemm.cu`` for bf16, f32 and int8,
``grouped_gemm.cu``, ``flash_attention.cu`` and ``rmsnorm.cu`` for bf16 and
f32.  The bf16 builds of ``gemm.cu``, ``grouped_gemm.cu`` and
``flash_attention.cu`` include ``wgmma_gemm.cuh`` (the tensor-core route:
TMA, mbarriers, wgmma), the int8 build of ``gemm.cu`` ``wgmma_s8.cuh``
(which includes it), the f32 GEMM builds ``tile_gemm.cuh``; that header
and the f32 build of ``flash_attention.cu`` take their cp.async copies and
fragment loads from ``cp_async.cuh``.
Libraries land in ``build/repro_torch/<hash>/`` at the repository root
(``.gitignore`` lists ``build/``; ``REPRO_TORCH_BUILD_DIR`` moves it), keyed
by a hash of every file under ``csrc/`` and the flags, so an edit to any
source or header rebuilds and an unchanged tree reuses the build.  The
sources expose plain ``extern "C"`` launchers and include no PyTorch
header, which keeps a build to seconds.

Nothing here runs at import time: the CPU tests import every module of the
package on a host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import NamedTuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)

#: each launcher's ctypes argument types.  Every pointer and the stream is a
#: c_void_p: a bare Python int would go through as a 32-bit int and cut it.
#: A, B, Cin, Cout; M, N, k0, k1; lda, ldb, ldc; bm, bn, bk, group; stream
#: (the f32 GEMM)
_GEMM_ARGS = (_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I64, _I64, _I64,
              _I32, _I32, _I32, _I32, _VP)
#: maps; Cin, Cout; M, N, K; ldc; k0, k1; bm, bn, ks, stages, group; stream
#: (the int8 GEMM)
_S8_ARGS = (_VP, _VP, _VP, _I32, _I32, _I32, _I64, _I32, _I32, _I32, _I32,
            _I32, _I32, _I32, _VP)
#: A, Bt, C; M, N, K; lda, ldbt, ldc; bm, bn, ks; maps (384 bytes, written)
#: (the int8 GEMM: Bt is B transposed, ldbt its row stride)
_S8_ENCODE_ARGS = (_VP, _VP, _VP, _I32, _I32, _I32, _I64, _I64, _I64, _I32,
                   _I32, _I32, _VP)
#: the bf16 GEMM's: the int8 ones and, before the stream or the maps, the
#: layout (ta, tb: wgmma's transpose bits)
_WGMMA_ARGS = (*_S8_ARGS[:-1], _I32, _I32, _VP)
_WGMMA_ENCODE_ARGS = (*_S8_ENCODE_ARGS[:-1], _I32, _I32, _VP)
#: B, Bt; K, N; ldb, ldbt; stream (the int8 GEMM's transposed copy of B)
_TRANSPOSE_ARGS = (_VP, _VP, _I32, _I32, _I64, _I64, _VP)
#: x, w, y; E, C, D, F; bc, bf, bk; stream (the f32 grouped GEMM)
_GROUPED_ARGS = (_VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                 _VP)
#: maps of x, w, y (y's may be null); y; E, C, D, F; y's row and expert
#: strides; bm, bn, ks, stages, group; ta, tb; stream
_GROUPED_WGMMA_ARGS = (_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I64,
                       _I64, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _VP)
#: map (128 bytes, written); base; rows, cols, depth; ld, plane; operand;
#: bm, bn, ks; trans (the operand stored transposed)
_GROUPED_ENCODE_ARGS = (_VP, _VP, _I32, _I32, _I32, _I64, _I64, _I32, _I32,
                        _I32, _I32, _I32)
#: q, k, v, o; B, S, Skv, H, D; q, k, v strides (batch, seq, head); causal;
#: stream (the f32 flash attention)
_FLASH_ARGS = (_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32,
               *(_I64,) * 9, _I32, _VP)
#: maps of q, k, v; o; B, S, Skv, H, d; width, block_k, consumers,
#: stages; causal; stream (the bf16 flash attention)
_FLASH_WGMMA_ARGS = (_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32,
                     _I32, _I32, _I32, _I32, _I32, _VP)
#: map (128 bytes, written); base; d, rows, heads, batch; sequence, head and
#: batch strides; box rows
_FLASH_ENCODE_ARGS = (_VP, _VP, _I32, _I32, _I32, _I32, _I64, _I64, _I64,
                      _I32)
#: x, scale, y; rows, D; eps; scale is bf16 (else f32); stream
_RMSNORM_ARGS = (_VP, _VP, _VP, _I32, _I32, _F32, _I32, _VP)


class Target(NamedTuple):
    """One shared library: its source under csrc/, the define that selects
    its element type, its launcher's name and ctypes argument types, and
    any other exported function as ``(name, argtypes)`` pairs (each returns
    an error code, as the launcher does)."""
    source: str
    define: str
    launcher: str
    argtypes: tuple
    helpers: tuple = ()


TARGETS = {
    "gemm_bf16": Target("gemm.cu", "REPRO_GEMM_BF16", "repro_gemm_wgmma",
                        _WGMMA_ARGS, (("repro_gemm_wgmma_encode",
                                       _WGMMA_ENCODE_ARGS),)),
    "gemm_f32": Target("gemm.cu", "REPRO_GEMM_F32", "repro_gemm_tile",
                       _GEMM_ARGS),
    "gemm_int8": Target("gemm.cu", "REPRO_GEMM_INT8", "repro_gemm_s8",
                        _S8_ARGS, (("repro_gemm_s8_encode",
                                    _S8_ENCODE_ARGS),
                                   ("repro_transpose_s8", _TRANSPOSE_ARGS))),
    "grouped_gemm_bf16": Target("grouped_gemm.cu", "REPRO_GEMM_BF16",
                                "repro_grouped_gemm_wgmma",
                                _GROUPED_WGMMA_ARGS,
                                (("repro_grouped_encode",
                                  _GROUPED_ENCODE_ARGS),)),
    "grouped_gemm_f32": Target("grouped_gemm.cu", "REPRO_GEMM_F32",
                               "repro_grouped_gemm", _GROUPED_ARGS),
    "flash_attention_bf16": Target("flash_attention.cu", "REPRO_ELEM_BF16",
                                   "repro_flash_attention_wgmma",
                                   _FLASH_WGMMA_ARGS,
                                   (("repro_flash_encode",
                                     _FLASH_ENCODE_ARGS),)),
    "flash_attention_f32": Target("flash_attention.cu", "REPRO_ELEM_F32",
                                  "repro_flash_attention", _FLASH_ARGS),
    "rmsnorm_bf16": Target("rmsnorm.cu", "REPRO_ELEM_BF16", "repro_rmsnorm",
                           _RMSNORM_ARGS),
    "rmsnorm_f32": Target("rmsnorm.cu", "REPRO_ELEM_F32", "repro_rmsnorm",
                          _RMSNORM_ARGS),
}

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    root = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))
    return os.environ.get("REPRO_TORCH_BUILD_DIR",
                          os.path.join(root, "build", "repro_torch"))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are compiled on a machine with the CUDA "
        "toolkit and an sm_90a card")


def sources() -> list[str]:
    """Every file under ``csrc/``, sorted: what the build hash covers."""
    return sorted(os.path.join(CSRC, n) for n in os.listdir(CSRC)
                  if n.endswith((".cu", ".cuh")))


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(build_dir(), h.hexdigest()[:16], f"lib{name}.so")


def build() -> dict[str, str]:
    """Compile every library that is not built yet, all in parallel;
    returns ``{target: library path}``.  Raises with nvcc's output if any
    compile fails."""
    paths = {t: _lib_path(t) for t in TARGETS}
    todo = {t: p for t, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for v, path in todo.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        spec = TARGETS[v]
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, f"-D{spec.define}",
               "-o", tmp, os.path.join(CSRC, spec.source)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for v, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        with open(f"{path}.log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"[{v}] exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    one built library."""
    target(name)
    with open(_lib_path(name) + ".log") as f:
        return f.read()


def target(name: str) -> Target:
    """The :class:`Target` of one library; raises ValueError for a name
    ``TARGETS`` does not list."""
    try:
        return TARGETS[name]
    except KeyError:
        raise ValueError(f"no CUDA library {name!r}: the targets are "
                         f"{sorted(TARGETS)}") from None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one target (e.g. ``"gemm_bf16"``), building
    every library first if needed; its launcher and helpers take the
    argument types its :class:`Target` names and return a CUDA error
    code."""
    spec = target(name)
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build()[name])
        for fn_name, argtypes in ((spec.launcher, spec.argtypes),
                                  *spec.helpers):
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = _I32
        lib.repro_cuda_error_string.argtypes = [_I32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
