from .config import DeformConvSpec, effective_step, ntuple

__all__ = ["DeformConvSpec", "effective_step", "ntuple"]
