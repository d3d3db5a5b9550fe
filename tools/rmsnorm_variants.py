#!/usr/bin/env python3
"""Time variants of the RMSNorm launcher in turns on one card.

    python3 tools/rmsnorm_variants.py [--variants as-is ring ...]

Each variant is ``src/repro_torch/kernels/csrc/rmsnorm.cu`` with the text
edits ``VARIANTS`` names (an edit whose text the source no longer holds
fails the run), built with the package's nvcc flags into a library of its
own under ``build/rmsnorm_variants/`` (one nvcc for each, all started
together) and called through its C entry ``repro_rmsnorm`` on the same
inputs.  Each output is held against ``rmsnorm_plain`` (f32 rtol = atol =
1e-5, bf16 one ulp of |y|) and each variant timed by CUDA-graph replay,
in the order first, ..., last, last, ..., first, at ``SHAPES`` in bf16
and f32 with the models' f32 scale.  Prints the card's name and power
limit, then one line a shape: each variant's two device times in ms and
the share of the bytes bound from its faster turn.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: name -> [(text in the launcher, its replacement)]
VARIANTS = {
    # the launcher as it is
    "as-is": [],
    # aligned rows through the ring (the element path) like every other
    # row of unit column stride
    "ring": [("    if (vec)\n      return launch_direct",
              "    if (false)\n      return launch_direct")],
    # the direct kernel's rule for fewer rows than SMs at every row count
    "direct-few": [("const bool few = rows < sm_count();",
                    "const bool few = true;")],
    # its rule for more rows at every row count
    "direct-many": [("const bool few = rows < sm_count();",
                     "const bool few = false;")],
}
#: (rows, D, layout as chip_smoke.norm_input takes it)
SHAPES = ((4, 1536, "contiguous"), (32, 1536, "contiguous"),
          (131, 1536, "contiguous"), (256, 1536, "contiguous"),
          (1024, 1536, "contiguous"), (4096, 1536, "contiguous"),
          (32768, 1536, "contiguous"), (4096, 1536, "slice"),
          (4096, 5120, "contiguous"), (4096, 7168, "contiguous"),
          (4096, 16384, "contiguous"))


def variant_source(text: str, name: str) -> str:
    """``text`` (rmsnorm.cu) with the edits of variant ``name``."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not in the "
                             f"source exactly once")
        text = text.replace(old, new)
    return text


def build_variants(names) -> dict:
    """{(variant, "bf16" | "f32"): loaded library}, all built at once."""
    from repro_torch.kernels import build
    with open(os.path.join(build.CSRC, "rmsnorm.cu")) as f:
        text = f.read()
    out = os.path.join(ROOT, "build", "rmsnorm_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, name))
        for tag, define in (("bf16", "REPRO_ELEM_BF16"),
                            ("f32", "REPRO_ELEM_F32")):
            lib = os.path.join(out, f"lib{name}_{tag}.so")
            cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
                   f"-D{define}", "-o", lib, src]
            procs[(name, tag)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(path)
        lib.repro_rmsnorm.argtypes = list(
            build.target("rmsnorm_f32").argtypes)
        lib.repro_rmsnorm.restype = ctypes.c_int
        libs[key] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; the variants run on an H100",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import rmsnorm as R
    from repro_torch.kernels.gemm import raw_stream

    print(C.smi("name,power.limit"), flush=True)
    libs = build_variants(args.variants)
    dev = torch.device("cuda", 0)
    order = args.variants + args.variants[::-1]
    print(f"order: {order}; device ms by CUDA-graph replay, two turns a "
          f"variant (share of the bytes bound from the faster)")
    for i, (n, d, layout) in enumerate(SHAPES):
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            g = torch.Generator(dev).manual_seed(900 + i)
            x = C.norm_input(n, d, layout, dt, g, dev)
            scale = torch.randn((d,), generator=g, device=dev)
            y = torch.empty((n, d), dtype=dt, device=dev)
            want = R.rmsnorm_plain(x, scale)

            def call(lib):
                err = lib.repro_rmsnorm(x.data_ptr(), x.stride(0), 1,
                                        scale.data_ptr(), y.data_ptr(), n,
                                        d, 1e-5, 0, raw_stream(x))
                C.check(err == 0, f"repro_rmsnorm returned {err}")

            times = {v: [] for v in args.variants}
            for v in order:
                lib = libs[(v, tag)]
                y.zero_()
                call(lib)
                torch.cuda.synchronize()
                C.held(f"rmsnorm {v} {n}x{d}", tag, y, want,
                       C.norm_tolerance(tag, want))
                times[v].append(C.graph_ms(lambda: call(lib)))
            bms = C.norm_bound(n, d, tag)[0]
            print(f"{n:>6} x {d:<5} {tag:<5}{layout:<11}" + "; ".join(
                f"{v} {t[0]:.4f} / {t[1]:.4f} ({100 * bms / min(t):.1f}%)"
                for v, t in times.items()), flush=True)
            del x, y, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
