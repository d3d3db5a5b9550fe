"""Build and load the CUDA kernels: ``nvcc`` into shared libraries, ``ctypes``.

Each source of ``kernels/csrc/`` is compiled at first use for ``sm_90a``
into one shared library per element type, all in parallel (one ``nvcc``
process per library): ``gemm.cu`` for bf16, f32 and int8,
``grouped_gemm.cu`` for bf16 and f32.  Both include ``tile_gemm.cuh``.
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

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: library name -> (source under csrc/, the define that selects its
#: element type)
TARGETS = {
    "gemm_bf16": ("gemm.cu", "REPRO_GEMM_BF16"),
    "gemm_f32": ("gemm.cu", "REPRO_GEMM_F32"),
    "gemm_int8": ("gemm.cu", "REPRO_GEMM_INT8"),
    "grouped_gemm_bf16": ("grouped_gemm.cu", "REPRO_GEMM_BF16"),
    "grouped_gemm_f32": ("grouped_gemm.cu", "REPRO_GEMM_F32"),
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


def _lib_path(target: str) -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(build_dir(), h.hexdigest()[:16], f"lib{target}.so")


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
        source, define = TARGETS[v]
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, f"-D{define}",
               "-o", tmp, os.path.join(CSRC, source)]
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


def build_log(target: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    one built library."""
    with open(_lib_path(target) + ".log") as f:
        return f.read()


def load(target: str) -> ctypes.CDLL:
    """The loaded library of one target (e.g. ``"gemm_bf16"``), building
    every library first if needed."""
    lib = _LIBS.get(target)
    if lib is None:
        lib = ctypes.CDLL(build()[target])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if TARGETS[target][0] == "gemm.cu":
            lib.repro_gemm_tile.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                            i64, i64, i64, i32, i32, i32, vp]
            lib.repro_gemm_tile.restype = i32
        else:
            lib.repro_grouped_gemm.argtypes = [vp, vp, vp, i32, i32, i32,
                                               i32, i32, i32, i32, vp]
            lib.repro_grouped_gemm.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[target] = lib
    return lib
