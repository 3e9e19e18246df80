"""Carry weights from the JAX package's flax modules to the port's modules.

Two kinds of flax trees are taken:

* a deformable-conv module of `modulated_deform_conv_tpu.models.modules`,
  ``{"params": {"weight", "bias", "conv_offset": {...}, "conv_mask":
  {...}}}``, whose leaves map one to one onto the state_dict entries
  ``weight``, ``bias``, ``conv_offset.weight`` ... of the port's module of
  the same name (both OIHW: renaming only);
* a `DCNResNet` or `DCNVideoNet` (models/backbone.py) and its parts.
  Flax names some submodules itself (``ConvBN_0``, ``ConvBN_1``,
  ``ConvBN3d_0``, ``ConvBN3d_1``, ``Conv_0``, ``GroupNorm_0``); they become
  the port's ``conv1``, ``conv3``, ``conv1``, ``conv3``, ``conv`` and
  ``norm``, and the names flax was given (``stem``, ``c3``, ``block0``,
  ``s1b0``, ``dcn``, ``conv2``, ``proj``, ``fc``) stay.  An ``nn.Conv``
  kernel goes from (*spatial, in, out) to (out, in, *spatial) (HWIO to
  OIHW, DHWIO to OIDHW), an ``nn.Dense`` kernel from (in, out) to (out,
  in), and a GroupNorm ``scale`` becomes ``weight``.

Leaves may be numpy arrays or anything `numpy.asarray` takes (jax arrays
included); jax itself is never imported here.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"ConvBN_0": "conv1", "ConvBN_1": "conv3", "ConvBN3d_0": "conv1",
           "ConvBN3d_1": "conv3", "Conv_0": "conv", "GroupNorm_0": "norm"}


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def _convert(path: Tuple[str, ...], val) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    arr = np.array(val, copy=True)
    if leaf == "kernel":
        # nn.Conv: (*spatial, in, out) -> (out, in, *spatial);
        # nn.Dense: (in, out) -> (out, in).
        n = arr.ndim
        arr = (arr.transpose(n - 1, n - 2, *range(n - 2)) if n > 2
               else arr.T)
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([_RENAME.get(m, m) for m in mods] + [leaf]), arr


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``variables`` (or their ``params``) -> torch state_dict (CPU)."""
    params = variables.get("params", variables)
    flat = dict(_convert(path, val) for path, val in _leaves(params))
    if not any(k == "weight" or k.endswith(".weight") for k in flat):
        raise KeyError("no 'weight' or 'kernel' among the flax params: "
                       f"{sorted(params)}")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in flat.items()}


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
