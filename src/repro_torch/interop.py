"""Moving data between numpy, the JAX package's conventions and the port.

Both packages are fed the same inputs as numpy arrays made from a seed.
bf16 travels as float32 (numpy has no bfloat16) and is cast on arrival.
Model weights cross the same way: :func:`load_jax_params` fills the port's
``LM`` with the JAX package's parameter values, its period stack
unstacked.
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


def _flatten(tree, prefix=()) -> dict:
    """{key path: leaf} of a nested dict (lists index by position)."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for key, val in items:
        out.update(_flatten(val, prefix + (key,)))
    return out


def _unstack(values) -> dict:
    """The JAX package's value tree in the port's layout: the leading period
    axis of every ``stack`` leaf becomes the position in a list of period
    dicts."""
    flat = _flatten(values)
    periods = {np.shape(v)[0] for path, v in flat.items()
               if path[0] == "stack"}
    if len(periods) > 1:
        raise ValueError(f"stack leaves disagree on the period count: "
                         f"{sorted(periods)}")
    out = {}
    for path, v in flat.items():
        if path[0] == "stack":
            for i in range(next(iter(periods))):
                out[("stack", i) + path[1:]] = np.asarray(v)[i]
        else:
            out[path] = np.asarray(v)
    return out


def load_jax_params(lm, values) -> dict:
    """Fill ``lm`` (a ``repro_torch.models.model.LM``) with the JAX
    package's parameter values, as ``split_params(LM(cfg, HOST_MESH).init
    (key))[0]`` gives them with numpy leaves.

    The stacked period axis is unstacked onto the port's list of periods.
    Raises ValueError on a missing key, an extra key or a shape mismatch.
    bf16 leaves travel as float32 and are cast to the parameter's dtype.
    An ``lm`` without parameters is initialised first (from a fixed seed)
    to lay the tree out.  Returns ``lm.values()``.
    """
    if lm.params is None:
        lm.init(torch.Generator(device=lm.device).manual_seed(0))
    have = _flatten(lm.values())
    got = _unstack(values)
    missing = sorted(map(str, set(have) - set(got)))
    extra = sorted(map(str, set(got) - set(have)))
    if missing or extra:
        raise ValueError(f"JAX parameters do not match the port's layout: "
                         f"missing {missing}, extra {extra}")
    for path, param in have.items():
        src = got[path]
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{'.'.join(map(str, path))}: JAX shape "
                             f"{tuple(src.shape)} vs port "
                             f"{tuple(param.shape)}")
        if src.dtype.name == "bfloat16":      # ml_dtypes' numpy bfloat16
            src = src.astype(np.float32)
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    return lm.values()
