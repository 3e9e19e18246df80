from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .config import DeformConvSpec, effective_step, ntuple

__all__ = ["DeformConvSpec", "effective_step", "ntuple", "save_checkpoint",
           "restore_checkpoint", "latest_step"]
