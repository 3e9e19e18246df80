"""The one traffic generator: every mix is a JSON file of parameters under
dcnbench/traffic/ that this module reads.

Keys of a mix:

* "kind": "train" (a training step on each batch, back to back) or
  "serve" (a forward on each request, one client, each request sent as
  soon as the one before it is back: a closed loop);
* "batch": samples a step or a request; "sample": one sample's shape;
* "pool": distinct batches made at set-up and cycled (sized past 4x the
  card's 50 MB L2 cache);
* "in_flight" (train): steps dispatched ahead of the device;
* "trace_steps": steps or requests in a traced window;
* "compare": the number of pool entries whose every request is compared
  with the reference (serve), or of first steps the reference follows
  (train).

The values of the inputs, and which pool entry each request takes, come
from the seed; their sizes and their number do not, so that seeds change
the data and not the work.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict

import numpy as np
import torch

from .weights import generator

KINDS = ("train", "serve")


def load(path: pathlib.Path) -> Dict:
    mix = json.loads(path.read_text())
    if mix.get("kind") not in KINDS:
        raise ValueError(f"{path}: kind must be one of {KINDS}")
    return mix


def make_pool(mix: Dict, classes: int, seed: int, device):
    """(x, y): x (pool, batch, *sample) standard normal, y (pool, batch)
    labels uniform over the classes, both on the device, in two calls."""
    g = generator(seed, device)
    x = torch.randn((mix["pool"], mix["batch"]) + tuple(mix["sample"]),
                    generator=g, device=device)
    y = torch.randint(0, classes, (mix["pool"], mix["batch"]), generator=g,
                      device=device)
    return x, y


def order(mix: Dict, seed: int) -> np.ndarray:
    """The order in which the pool's entries are used, from the seed."""
    return np.random.default_rng(seed).permutation(mix["pool"])
