"""Carry weights between the JAX package's flax modules and the port's
modules, both ways.

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

`state_dict_to_flax` is the inverse direction, the counterpart of the JAX
package's `from_torch_state_dict` / `to_torch_state_dict` pair: a port
state_dict to a numpy ``{"params": ...}`` tree that the JAX package's
modules and backbones take.  `validate_against_module` checks a state_dict
(or a flax tree) against a port module built on ``meta``, computing
nothing, as the JAX package's check does with `jax.eval_shape`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Tuple, Union

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


def _flax_name(path: Tuple[str, ...], name: str,
               state_dict: Mapping[str, Any]) -> str:
    """The flax name of the port submodule `name` under `path`: `_RENAME`
    inverted, ``conv1`` / ``conv3`` becoming ``ConvBN3d_*`` where their
    conv kernel is 3D."""
    if name in ("conv1", "conv3"):
        w = state_dict.get(".".join(path + (name, "conv", "weight")))
        rank = "3d" if w is not None and w.ndim == 5 else ""
        return f"ConvBN{rank}_{0 if name == 'conv1' else 1}"
    return {"conv": "Conv_0", "norm": "GroupNorm_0"}.get(name, name)


def state_dict_to_flax(state_dict: Mapping[str, Any], prefix: str = ""
                       ) -> Dict[str, Any]:
    """Port ``state_dict`` -> numpy flax ``{"params": ...}`` tree, the
    inverse of `flax_to_state_dict`.  `prefix` selects a submodule's
    entries (e.g. ``"c3.block0.dcn."``) and is stripped.  A ``conv``'s
    weight becomes an ``nn.Conv`` kernel ((out, in, *spatial) -> (*spatial,
    in, out)), a 2D weight an ``nn.Dense`` kernel (transposed), a
    ``norm``'s weight a GroupNorm ``scale``; a deformable-conv module's
    leaves keep their names and layout."""
    sd = {k[len(prefix):]: np.array(v.detach().cpu() if hasattr(v, "detach")
                                    else v, copy=True)
          for k, v in state_dict.items() if k.startswith(prefix)}
    if not sd:
        raise KeyError(f"no entries under prefix {prefix!r}; state_dict "
                       f"keys: {list(state_dict)[:8]}...")
    params: Dict[str, Any] = {}
    for key, arr in sd.items():
        *mods, leaf = key.split(".")
        parent = mods[-1] if mods else ""
        if leaf == "weight" and parent == "conv" and arr.ndim > 2:
            leaf, arr = "kernel", arr.transpose(*range(2, arr.ndim), 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight" and parent == "norm":
            leaf = "scale"
        node = params
        for i, m in enumerate(mods):
            node = node.setdefault(_flax_name(tuple(mods[:i]), m, sd), {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": params}


def validate_against_module(
        module: Union[nn.Module, Callable[..., nn.Module]],
        state_dict: Mapping[str, Any], **build_kwargs) -> None:
    """Raise ValueError if `state_dict` (or flax ``variables``, converted by
    `flax_to_state_dict`) cannot load into `module`: a missing, unexpected
    or mis-shaped entry.  `module` is a port module, or its class or a
    factory, called with `build_kwargs` and ``device="meta"``: parameters
    with shapes and no storage, so nothing is allocated or computed."""
    if not isinstance(module, nn.Module):
        module = module(**build_kwargs, device="meta")
    if "params" in state_dict or any(isinstance(v, Mapping)
                                     for v in state_dict.values()):
        state_dict = flax_to_state_dict(state_dict)
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in state_dict.items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"state_dict mismatch: missing {missing}, "
                         f"unexpected {extra}")
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError("shape mismatch (state_dict vs module): "
                         + ", ".join(f"{k} {a} vs {b}"
                                     for k, (a, b) in bad.items()))
