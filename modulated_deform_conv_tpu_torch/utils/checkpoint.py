"""Checkpoint / resume helpers on `torch.save` / `torch.load`.

Counterpart of the JAX package's utils/checkpoint.py, which writes pytrees
with orbax (or numpy) into one directory per step.  Here the state is what
PyTorch trains with: a `state_dict`, or a dict of them (model and
optimizer), written to ``<path>/step_<step>/checkpoint.pt``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

_FILE = "checkpoint.pt"


def _step_dir(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    return path if step is None else os.path.join(path, f"step_{step}")


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> str:
    """Save `state` under `path` (in ``step_<step>/`` when a step is given).
    The file is written beside its final name and then renamed, so a
    reader never sees half of it.  Returns the directory written."""
    d = _step_dir(path, step)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{_FILE}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(d, _FILE))
    return d


def restore_checkpoint(path: str, step: Optional[int] = None) -> Any:
    """Load what `save_checkpoint` wrote, its tensors on the CPU
    (load_state_dict moves them to the module's device)."""
    return torch.load(os.path.join(_step_dir(path, step), _FILE),
                      map_location="cpu", weights_only=True)


def latest_step(path: str) -> Optional[int]:
    """The largest N of a ``step_N`` entry under path, or None (no such
    entry, or no directory), as the JAX package's `latest_step`."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None
