"""Build and load the CUDA kernels: ``nvcc`` into shared libraries, ``ctypes``.

``kernels/csrc/gemm.cu`` is compiled at first use for ``sm_90a`` into one
shared library per element type, all in parallel (one ``nvcc`` process
each).  Libraries land in
``build/repro_torch/<hash>/`` at the repository root (``.gitignore`` lists
``build/``; ``REPRO_TORCH_BUILD_DIR`` moves it), keyed by a hash of the
source and the flags, so an edit rebuilds and an unchanged tree reuses the
build.  The sources expose plain ``extern "C"`` launchers and include no
PyTorch header, which keeps a build to seconds.

Nothing here runs at import time: the CPU tests import every module of the
package on a host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "gemm.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: element-type variant -> the define that selects it in csrc/gemm.cu
VARIANTS = {"bf16": "REPRO_GEMM_BF16", "f32": "REPRO_GEMM_F32",
            "int8": "REPRO_GEMM_INT8"}

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


def _lib_path(variant: str) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(build_dir(), h.hexdigest()[:16],
                        f"libgemm_{variant}.so")


def build() -> dict[str, str]:
    """Compile every variant that is not built yet, all in parallel;
    returns ``{variant: library path}``.  Raises with nvcc's output if any
    compile fails."""
    paths = {v: _lib_path(v) for v in VARIANTS}
    todo = {v: p for v, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for v, path in todo.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, f"-D{VARIANTS[v]}",
               "-o", tmp, SOURCE]
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
        raise RuntimeError("nvcc failed for csrc/gemm.cu:\n"
                           + "\n".join(failed))
    return paths


def build_log(variant: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    one built variant."""
    with open(_lib_path(variant) + ".log") as f:
        return f.read()


def load(variant: str) -> ctypes.CDLL:
    """The loaded library of one variant, building it first if needed."""
    lib = _LIBS.get(variant)
    if lib is None:
        lib = ctypes.CDLL(build()[variant])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.repro_gemm_tile.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                        i64, i64, i64, i32, i32, i32, vp]
        lib.repro_gemm_tile.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[variant] = lib
    return lib
