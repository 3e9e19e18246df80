from .api import (deform_conv2d, deform_conv3d, modulated_deform_conv2d,
                  modulated_deform_conv3d)

__all__ = ["deform_conv2d", "modulated_deform_conv2d", "deform_conv3d",
           "modulated_deform_conv3d"]
