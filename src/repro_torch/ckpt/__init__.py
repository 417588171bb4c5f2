"""repro_torch.ckpt — async atomic checkpointing, in the reference's format."""
from .manager import CheckpointManager
