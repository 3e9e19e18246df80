"""Sharded training rehearsal on spawned gloo CPU ranks.

The port's counterpart of the JAX package's `dryrun_multichip`
(__graft_entry__.py:70): `dryrun_multichip(n)` starts n processes, joins
them in one gloo process group through a `file://` store, and every rank
runs `dryrun_rank`: four sub-runs, each one training step with every
gradient, each held against the same step computed unsharded on the rank
(the loss, and every gradient's shard):

1. a toy predictor (1x1 convs) and a deformable conv on the (data, space,
   group) mesh: batch, halo and group-aligned tensor parallelism at once;
2. `DCNStage` (Pack modules, zero-init offsets and a sigmoid mask) on a
   (data, space) mesh;
3. a 3D modulated op sharded on its leading spatial axis;
4. a halo wider than a shard (the multi-hop ring).

    python -m modulated_deform_conv_tpu_torch.parallel.dryrun 8
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models.backbone import DCNStage
from ..ops.api import modulated_deform_conv2d, modulated_deform_conv3d
from ..utils.config import DeformConvSpec
from . import sharding as sh


def spawn_gloo(fn, n: int, *args, store_dir=None, timeout: float = 300.0):
    """Run fn(rank, n, *args) in n spawned processes joined in one gloo
    process group (a `file://` store in `store_dir`, a new temporary
    directory by default), each with one thread.  Raises if a rank raises
    or the run passes `timeout` seconds (its processes are then ended)."""
    store_dir = store_dir or tempfile.mkdtemp(prefix="mdc_gloo_")
    store = os.path.join(store_dir, f"store_{time.time_ns()}")
    ctx = mp.start_processes(_rank_entry, args=(n, store, fn, args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def _rank_entry(rank, n, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def _check(name, got, want, tol=3e-4):
    """Max abs / rel error between two lists of tensors; raises past `tol`
    (either one within it passes), as the JAX package's dryrun checks."""
    max_abs = max_rel = 0.0
    for a, b in zip(got, want):
        err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.
        scale = float(b.double().abs().max()) if b.numel() else 0.0
        max_abs, max_rel = max(max_abs, err), max(max_rel, err / (scale
                                                                  + 1e-30))
    ok = max_rel <= tol or max_abs <= tol
    if dist.get_rank() == 0:
        print(f"    {name}: max_abs_err={max_abs:.3e} "
              f"max_rel_err={max_rel:.3e} [{'OK' if ok else 'FAIL'}]",
              flush=True)
    if not ok:
        raise AssertionError(f"{name}: sharded result diverges from the "
                             f"unsharded step (max_abs={max_abs:.3e}, "
                             f"max_rel={max_rel:.3e}, tol={tol})")
    return max_abs, max_rel


def _say(msg):
    if dist.get_rank() == 0:
        print(msg, flush=True)


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float32, requires_grad=grad)


def _step(loss_fn, params):
    """The loss and the gradients of one step."""
    loss = loss_fn(params)
    return loss.detach(), list(torch.autograd.grad(loss, params))


def _global_loss(local, mesh, axes):
    """The loss summed over the ranks' shards (reported, not
    differentiated)."""
    return sh.all_sum(local.detach(), mesh, axes)


def dryrun_rank(rank: int, n: int) -> None:
    """The four sub-runs on this rank (the world is n ranks)."""
    if n % 8 == 0:
        shape = (n // 4, 2, 2)
    elif n % 2 == 0 and n >= 4:
        shape = (n // 2, 2, 1)
    elif n >= 2:
        shape = (1, n, 1)
    else:
        shape = (1, 1, 1)
    names = ("data", "space", "group")
    mesh = sh.make_mesh(shape, names, device_type="cpu")
    n_data, n_space, n_group = shape
    axes = [a for a, s in zip(names, shape) if s > 1]

    # --- 1: toy predictor + deformable conv on (data, space, group).
    B, C, O, H, W, k, dg, g = 2 * n_data, 8, 8, 4 * n_space, 8, 3, 2, 2
    K = k * k
    rng = np.random.default_rng(0)
    init = [rng.standard_normal((dg * 2 * K, C)) * 0.01,
            rng.standard_normal((dg * K, C)) * 0.01,
            rng.standard_normal((O, C // g, k, k)) * 0.1, np.zeros(O)]
    x = _t(rng.standard_normal((B, C, H, W)))
    kw = dict(stride=1, padding=1, groups=g, deformable_groups=dg)
    xl = sh.local_shard(x, {0: "data", 2: "space"}, mesh)
    n_g, i_g = n_group, mesh.get_local_rank("group")

    def predict(xx, w_off, w_mask):
        off = torch.einsum("bchw,oc->bohw", xx, w_off)
        return off, torch.sigmoid(torch.einsum("bchw,oc->bohw", xx, w_mask))

    def loss_sharded(p):
        # The predictors see every rank's data and channel share: their
        # gradients sum over all axes.  The op sums its weight's over the
        # data axes; each rank of the group axis uses its own rows of it.
        w_off, w_mask = (sh.sum_grad(t, mesh, axes) for t in p[:2])
        w, b = (sh.sum_grad(t, mesh, ["group"] if n_g > 1 else [])
                for t in p[2:])
        off, mask = predict(xl, w_off, w_mask)

        def mine(t, dim):    # this rank's channels on the group axis
            step = t.shape[dim] // n_g
            return t.narrow(dim, i_g * step, step)
        y = sh.sharded_modulated_deform_conv2d(
            mine(xl, 1), mine(off, 1), mine(mask, 1), mine(w, 0),
            mine(b, 0), mesh=mesh,
            max_offset=1.0, batch_axis="data", spatial_axis="space",
            group_axis="group" if n_g > 1 else None, **kw)
        return (y * y).sum() / (B * O * H * W)

    def loss_plain(p):
        off, mask = predict(x, p[0], p[1])
        y = modulated_deform_conv2d(x, off, mask, p[2], p[3], **kw)
        return (y * y).mean()

    loss, grads = _step(loss_sharded, [_t(a, True) for a in init])
    oloss, ograds = _step(loss_plain, [_t(a, True) for a in init])
    loss = _global_loss(loss, mesh, axes)
    _say(f"dryrun_multichip [1/4] toy (data,space,group) step: mesh="
         f"{dict(zip(names, shape))} loss={float(loss):.6f} "
         f"oracle={float(oloss):.6f}")
    _check("loss", [loss], [oloss])
    _check("grads", grads, ograds)

    # --- 2: DCNStage (Pack modules) on a (data, space) mesh.
    n_sp2 = n_space * n_group
    mesh2 = sh.make_mesh((n_data, n_sp2), ("data", "space"),
                         device_type="cpu")
    torch.manual_seed(0)
    stage = DCNStage(1, 16, 16, 32, deformable_groups=2, mesh=mesh2,
                     max_offset=1.0, device="cpu")
    plain = DCNStage(1, 16, 16, 32, deformable_groups=2, device="cpu")
    plain.load_state_dict(stage.state_dict())
    xs = _t(rng.standard_normal((2 * n_data, 16, 4 * n_sp2, 8)))
    xsl = sh.local_shard(xs, {0: "data", 2: "space"}, mesh2)
    n_out = xs.shape[0] * 32 * xs.shape[2] * xs.shape[3]
    sloss = (stage(xsl) ** 2).sum() / n_out
    sgrads = torch.autograd.grad(sloss, list(stage.parameters()))
    ploss = (plain(xs) ** 2).mean()
    pgrads = torch.autograd.grad(ploss, list(plain.parameters()))
    ploss = ploss.detach()
    sloss = _global_loss(sloss, mesh2, ["data", "space"])
    _say(f"dryrun_multichip [2/4] DCNStage (Pack, zero-init+sigmoid) train "
         f"step: mesh=(data={n_data}, space={n_sp2}) loss={float(sloss):.6f}"
         f" oracle={float(ploss):.6f}")
    _check("loss", [sloss], [ploss])
    _check("grads", list(sgrads), list(pgrads))

    # --- 3: a 3D modulated op sharded on its leading spatial axis.
    B3, C3, S3, k3, dg3 = 2, 8, (4 * n_sp2, 6, 6), 3, 2
    K3 = k3 ** 3
    init3 = [rng.standard_normal((B3, C3) + S3),
             rng.uniform(-1, 1, (B3, dg3 * 3 * K3) + S3),
             rng.uniform(0, 1, (B3, dg3 * K3) + S3),
             rng.standard_normal((C3, C3, k3, k3, k3)) * 0.1]
    lay3 = [{2: "space"}] * 3 + [{}]
    n3 = B3 * C3 * int(np.prod(S3))

    def loss3(p):
        y = sh.sharded_modulated_deform_conv3d(
            *p, None, mesh=mesh2, stride=1, padding=1,
            deformable_groups=dg3, max_offset=1.0, batch_axis=None,
            spatial_axis="space")
        return (y * y).sum() / n3

    def loss3_plain(p):
        y = modulated_deform_conv3d(*p, None, 1, 1, deformable_groups=dg3)
        return (y * y).mean()

    _sub_run(3, "sharded 3D op fwd+bwd", f"n_space={n_sp2}", init3, lay3,
             loss3, loss3_plain, mesh2, ["space"])

    # --- 4: a halo wider than a shard (the multi-hop ring).
    spec4 = DeformConvSpec.make(2, (3, 3), 1, 1, 1, 1, 1, 64, True)
    Hs = 8
    max_off4 = float(Hs + 2)
    halo4 = sh.required_halo(spec4, max_off4)
    assert halo4 > Hs, "dryrun 4 must take the multi-hop branch"
    B4, C4, H4, W4 = 2, 8, 8 * n_sp2, 8
    init4 = [rng.standard_normal((B4, C4, H4, W4)),
             rng.uniform(-2, 2, (B4, 18, H4, W4)),
             rng.uniform(0, 1, (B4, 9, H4, W4)),
             rng.standard_normal((C4, C4, 3, 3)) * 0.1]
    n4 = B4 * C4 * H4 * W4

    def loss4(p):
        y = sh.sharded_modulated_deform_conv2d(
            *p, None, mesh=mesh2, stride=1, padding=1, max_offset=max_off4,
            batch_axis=None, spatial_axis="space")
        return (y * y).sum() / n4

    def loss4_plain(p):
        y = modulated_deform_conv2d(*p, None, 1, 1)
        return (y * y).mean()

    _sub_run(4, f"multi-hop halo (halo={halo4} > Hs={Hs}) fwd+bwd", "",
             init4, lay3, loss4, loss4_plain, mesh2, ["space"])
    _say("dryrun_multichip OK: all 4 sub-runs match the unsharded step "
         f"(mesh={dict(zip(names, shape))})")


def _sub_run(i, what, extra, init, layouts, loss_sharded, loss_plain, mesh,
             axes):
    """One op-level sub-run: the sharded loss on the rank's shards against
    the plain one on the whole tensors, gradients compared shard by
    shard."""
    full = [_t(a, True) for a in init]
    local = [sh.local_shard(t.detach(), lay, mesh).requires_grad_(True)
             for t, lay in zip(full, layouts)]
    loss, grads = _step(loss_sharded, local)
    oloss, ograds = _step(loss_plain, full)
    loss = _global_loss(loss, mesh, axes)
    _say(f"dryrun_multichip [{i}/4] {what}: {extra + ' ' if extra else ''}"
         f"loss={float(loss):.6f} oracle={float(oloss):.6f}")
    _check("loss", [loss], [oloss])
    _check("grads", grads, [sh.local_shard(g, lay, mesh)
                            for g, lay in zip(ograds, layouts)])


def dryrun_multichip(n_devices: int = 8, timeout: float = 600.0) -> None:
    """The four sub-runs on n_devices spawned gloo CPU ranks; raises if
    any rank's check fails."""
    spawn_gloo(dryrun_rank, n_devices, timeout=timeout)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
