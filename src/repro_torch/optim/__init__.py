from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
    opt_state_specs,
)
from repro_torch.optim.compression import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    init_error_buffer,
    psum_compressed,
    quantize_int8,
)

__all__ = [
    "AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
    "lr_schedule", "opt_state_specs", "compress_tree", "decompress_tree", "dequantize_int8",
    "init_error_buffer", "psum_compressed", "quantize_int8",
]
