from .backbone import (ConvBN, ConvBN3d, DCN3dBottleneck, DCNBottleneck,
                       DCNResNet, DCNResNet3d, DCNStage, DCNVideoNet)
from .modules import (DeformConv2d, DeformConv2dPack, DeformConv3d,
                      DeformConv3dPack, ModulatedDeformConv2d,
                      ModulatedDeformConv2dPack, ModulatedDeformConv3d,
                      ModulatedDeformConv3dPack)
from .torch_compat import (flax_to_state_dict, load_flax_params,
                           state_dict_to_flax, validate_against_module)

__all__ = [
    "DeformConv2d", "ModulatedDeformConv2d", "DeformConv2dPack",
    "ModulatedDeformConv2dPack", "DeformConv3d", "ModulatedDeformConv3d",
    "DeformConv3dPack", "ModulatedDeformConv3dPack", "ConvBN",
    "DCNBottleneck", "DCNStage", "DCNResNet", "ConvBN3d", "DCN3dBottleneck",
    "DCNVideoNet", "DCNResNet3d", "flax_to_state_dict", "load_flax_params",
    "state_dict_to_flax", "validate_against_module",
]
