"""Sharding layer: mesh construction, the sharded ops and the process-group
start-up, on torch.distributed (the JAX package's `parallel/`)."""
from .runtime import device_summary, initialize_distributed, pod_mesh
from .sharding import (make_mesh, required_halo, sharded_deform_conv,
                       sharded_deform_conv2d, sharded_deform_conv3d,
                       sharded_modulated_deform_conv2d,
                       sharded_modulated_deform_conv3d)

__all__ = [
    "make_mesh", "required_halo", "sharded_deform_conv",
    "sharded_deform_conv2d", "sharded_modulated_deform_conv2d",
    "sharded_deform_conv3d", "sharded_modulated_deform_conv3d",
    "initialize_distributed", "pod_mesh", "device_summary",
]
