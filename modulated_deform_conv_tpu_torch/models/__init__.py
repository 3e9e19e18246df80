from .backbone import ConvBN, DCNBottleneck, DCNResNet, DCNStage
from .modules import (DeformConv2d, DeformConv2dPack, ModulatedDeformConv2d,
                      ModulatedDeformConv2dPack)
from .torch_compat import flax_to_state_dict, load_flax_params

__all__ = [
    "DeformConv2d", "ModulatedDeformConv2d", "DeformConv2dPack",
    "ModulatedDeformConv2dPack", "ConvBN", "DCNBottleneck", "DCNStage",
    "DCNResNet", "flax_to_state_dict", "load_flax_params",
]
