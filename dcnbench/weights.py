"""Parameters and inputs made from the seed, on the card, in few calls.

Both sides of the comparison get these tensors: the program has them
copied into its modules, the reference reads them as they are.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds from the run's seed (any whole number
    >= 0), one per thing the run makes."""
    state = np.random.SeedSequence(int(seed)).generate_state(2 * n, np.uint32)
    return [int(state[2 * i]) << 31 ^ int(state[2 * i + 1]) for i in range(n)]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def make_params(shapes: Iterable[Tuple[str, Tuple[int, ...]]], rules,
                seed: int, device, dtype=torch.float32
                ) -> Dict[str, torch.Tensor]:
    """One tensor per (name, shape), cut from a single draw of U(-1, 1).
    `rules` is a list of [suffix, rule, scale]; the first suffix a name
    ends with decides: "const" fills with scale, "fan_in_uniform" makes
    U(-a, a) with a = scale / sqrt(fan_in), fan_in = numel / shape[0]."""
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.rand(total, generator=generator(seed, device),
                      device=device, dtype=dtype).mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        rule = next((r for r in rules if name.endswith(r[0])), None)
        if rule is None:
            raise ValueError(f"no init rule for parameter {name!r}")
        _, kind, scale = rule
        if kind == "const":
            t.fill_(scale)
        elif kind == "fan_in_uniform":
            t.mul_(scale / math.sqrt(n // shape[0]))
        else:
            raise ValueError(f"unknown init rule {kind!r} for {name!r}")
        out[name] = t
    return out
