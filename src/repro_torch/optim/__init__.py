from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from repro_torch.optim.compression import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    init_error_buffer,
    quantize_int8,
)

__all__ = [
    "AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
    "lr_schedule", "compress_tree", "decompress_tree", "dequantize_int8",
    "init_error_buffer", "quantize_int8",
]
