"""Carry weights from the JAX package's flax modules to the port's modules.

A flax module of `modulated_deform_conv_tpu.models.modules` holds
``{"params": {"weight", "bias", "conv_offset": {...}, "conv_mask": {...}}}``;
the port's module of the same name holds the state_dict entries ``weight``,
``bias``, ``conv_offset.weight``, ``conv_offset.bias``, ``conv_mask.weight``
and ``conv_mask.bias``.  Both sides store OIHW, so the mapping renames and
copies: no transpose, no numeric change.

Leaves may be numpy arrays or anything `numpy.asarray` takes (jax arrays
included); jax itself is never imported here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_PACK_CHILDREN = ("conv_offset", "conv_mask")


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``variables`` (or their ``params``) -> torch state_dict (CPU)."""
    params = variables.get("params", variables)
    flat = {name: params[name] for name in ("weight", "bias")
            if name in params}
    for child in _PACK_CHILDREN:
        for name, val in (params.get(child) or {}).items():
            flat[f"{child}.{name}"] = val
    if "weight" not in flat:
        raise KeyError("no 'weight' among the flax params: "
                       f"{sorted(params)}")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
            flat.items()}


def load_flax_params(module: nn.Module, variables: Mapping[str, Any]
                     ) -> nn.Module:
    """Load flax ``variables`` into `module` in place, onto the device and
    dtype of its parameters.  Strict: a missing, unexpected or mis-shaped
    entry raises.  Returns the module."""
    own = module.state_dict()
    sd = {k: v.to(device=own[k].device, dtype=own[k].dtype) if k in own
          else v for k, v in flax_to_state_dict(variables).items()}
    module.load_state_dict(sd, strict=True)
    return module
