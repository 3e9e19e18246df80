"""`lib.launch` on the CPU, for the tests of its launch table: the C side
stubbed (`lib.kernel`, the CUDA device and stream), so that a wrapper's
launch runs through `lib.launch` on CPU or meta tensors and is counted as
on the card."""
import contextlib
import types

import torch

from modulated_deform_conv_tpu_torch.ops.cuda import lib


def stub_c_side(monkeypatch, err=0, returns=None):
    """Every C entry returns `err` (`returns[entry]` where given, for an
    entry that returns a value) and appends its name to the list this
    returns; no CUDA device or stream is touched."""
    calls, returns = [], returns or {}

    def kernel(name, entry=None):
        def fn(*args):
            calls.append(entry or name)
            return returns.get(entry or name, err)
        return fn

    monkeypatch.setattr(lib, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    return calls
