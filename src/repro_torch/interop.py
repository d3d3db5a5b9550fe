"""Moving data between numpy, the JAX package's conventions and the port.

Both packages are fed the same inputs as numpy arrays made from a seed.
bf16 travels as float32 (numpy has no bfloat16) and is cast on arrival.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "float32": torch.float32,
           "int8": torch.int8, "int32": torch.int32}


def require_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, raising when it names a CUDA
    device this process cannot see — the port never swaps in the CPU for a
    missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available for {dev} (torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}); pass "
            f"device='cpu' to run the plain versions on the host")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype tag or a numpy name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(np.dtype(dtype)) if not isinstance(dtype, str)
                   else dtype]


def operands_from_numpy(*arrays, device="cuda", dtype=None):
    """Numpy operands as tensors on ``device``; ``dtype`` (a torch dtype or
    tag, e.g. ``"bf16"``) casts floating arrays, so bf16 operands carried as
    float32 arrive as bfloat16.  Integer arrays keep their dtype.  Returns
    one tensor per array (a single tensor for a single array)."""
    dev = require_device(device)
    want = None if dtype is None else torch_dtype(dtype)
    out = []
    for arr in arrays:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if want is not None and t.dtype.is_floating_point:
            t = t.to(want)
        out.append(t.to(dev))
    return out[0] if len(out) == 1 else tuple(out)
