"""modulated_deform_conv_tpu_torch: the PyTorch / CUDA port of
modulated_deform_conv_tpu.

Deformable convolutions (DCNv1 / DCNv2, 2D and 3D) in plain PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 on the 2D and 3D forward and
backward: the bounded-offset shift-blend pairs and the general-offset
gather pairs.  The DCN-ResNet backbones, 2D and 3D, and the DCN video
backbone train through them.  The JAX package stays beside it as the
reference the port is held against; this package imports neither jax nor
that package.
"""
from .models import (DCNResNet, DCNResNet3d, DCNVideoNet, DeformConv2d,
                     DeformConv2dPack, DeformConv3d, DeformConv3dPack,
                     ModulatedDeformConv2d,
                     ModulatedDeformConv2dPack, ModulatedDeformConv3d,
                     ModulatedDeformConv3dPack, flax_to_state_dict,
                     load_flax_params, state_dict_to_flax,
                     validate_against_module)
from .ops import (deform_conv2d, deform_conv3d, modulated_deform_conv2d,
                  modulated_deform_conv3d)

__version__ = "0.1.0"

__all__ = [
    "deform_conv2d", "modulated_deform_conv2d", "deform_conv3d",
    "modulated_deform_conv3d", "DeformConv2d", "ModulatedDeformConv2d",
    "DeformConv2dPack", "ModulatedDeformConv2dPack", "DeformConv3d",
    "ModulatedDeformConv3d", "DeformConv3dPack", "ModulatedDeformConv3dPack",
    "DCNResNet", "DCNResNet3d", "DCNVideoNet", "flax_to_state_dict",
    "load_flax_params", "state_dict_to_flax", "validate_against_module",
]
