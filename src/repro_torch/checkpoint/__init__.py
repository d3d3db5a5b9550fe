"""repro_torch.checkpoint: atomic, keep-N, preemption-safe checkpoints."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
