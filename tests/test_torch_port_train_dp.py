"""The trainer's data-parallel branch on 2 gloo ranks, against one process
on the whole batch.

The JAX trainer shards its batch over every visible device
(examples/train_dcn_resnet.py:44-53); the port's trainer, with
torch.distributed initialised on more than one rank and a batch that
divides evenly, gives each rank its slice, broadcasts the parameters from
rank 0 and averages the loss and the gradients over the ranks in rank
order.  DCNResNet-50 at width 8 on 4 images of 64 x 64, 2 AdamW steps on
the CPU (the ranks: spawned processes joined by a `file://` store, each
with one thread): every rank's losses and parameters equal the
one-process run's within 1e-6 of each tensor's max, and the two ranks hold
the same bits.  With a batch of 3, which does not divide over 2 ranks,
every rank trains on the whole batch, to the same bits, and only rank 0
writes the checkpoint.

The sums over the batch are taken in another order on two ranks, and
AdamW's first step, near g / (|g| + eps), turns the rounding of a gradient
element near zero into an update of lr times up to 1: the comparison holds
only where rounding stays far below eps.  Hence float64, and 64 x 64 (c5 at
2 x 2): at 32 x 32, c5 runs at 1 x 1 and its GroupNorms amplify rounding
(tests/test_torch_port_backbone.py), which moved gradients by 1.9e-12 of
their max in float64 and parameters by 9.4e-7 after 2 steps, in a
one-process rehearsal of this split; at 64 x 64, 7e-15 and 3.2e-12.  In
float32, at 32 x 32, the second loss moved by 4%.
"""
import os

import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import train
from modulated_deform_conv_tpu_torch.parallel import dryrun

KW = dict(steps=2, batch=4, width=8, classes=10, size=64, device="cpu",
          dtype=torch.float64)
# A batch that does not divide over 2 ranks.
ODD = dict(KW, batch=3, size=32, dtype=torch.float32)


def _rank(rank, n, out_dir):
    got = {}
    for name, kw in (("dp", KW), ("odd", ODD)):
        logs = []
        res = train(log=logs.append, **kw)
        got[name] = {"losses": res["losses"], "logs": logs,
                     "params": res["model"].state_dict(),
                     "checkpoint": res["checkpoint"]}
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_dp"))
    dryrun.spawn_gloo(_rank, 2, out, store_dir=out, timeout=240.0)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]


@pytest.fixture(scope="module")
def single():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)                # as each rank runs
    try:
        res = train(log=lambda s: None, **KW)
    finally:
        torch.set_num_threads(threads)
    return res["losses"], res["model"].state_dict()


def test_ranks_took_the_data_parallel_branch(ranks):
    for r, got in enumerate(ranks):
        res = got["dp"]
        assert "data-parallel over 2 ranks: 2 samples a rank" in res["logs"]
        # Only rank 0 writes the checkpoint.
        assert (res["checkpoint"] is None) == (r != 0)


def test_ranks_replicate_a_batch_that_does_not_divide(ranks):
    for r, got in enumerate(ranks):
        res = got["odd"]
        assert ("batch 3 does not divide over 2 ranks: every rank trains "
                "on the whole batch") in res["logs"]
        assert not any("data-parallel" in line for line in res["logs"])
        assert (res["checkpoint"] is None) == (r != 0)
    assert ranks[0]["odd"]["losses"] == ranks[1]["odd"]["losses"]
    for k, v in ranks[0]["odd"]["params"].items():
        assert torch.equal(v, ranks[1]["odd"]["params"][k]), k


def test_ranks_match_one_process_on_the_whole_batch(ranks, single):
    losses, params = single
    ranks = [got["dp"] for got in ranks]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-6)
        assert res["params"].keys() == params.keys()
        for k, want in params.items():
            err = float((res["params"][k] - want).abs().max())
            assert err <= 1e-6 * float(want.abs().max()), (k, err)
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
