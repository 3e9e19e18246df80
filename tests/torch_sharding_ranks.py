"""The rank side of the port's gloo sharding tests, and the parent's
stitching.

A test file's module fixture (`spawn`) starts the gloo ranks once through
`parallel.dryrun.spawn_gloo` (a `file://` store under the test's temporary
directory, one thread a rank).  Every rank runs every case of the file in
order (`serve`) and saves its results; a case that raises on every rank
records the error.  This module imports torch, numpy and the port only, so
the ranks never import JAX; the parent, which holds JAX, stitches the
shards back (`stitch`) and compares.

A case is a dict: "kind" ("op", "module" or "dryrun"), "mesh" ((shape,
axis names)), and for "op": "fn" (a sharded wrapper's name), "inputs"
(global numpy arrays x, offset, mask or None, weight, bias or None), "kw"
(the wrapper's keywords) and "cot" (a global cotangent of the output, or
None for the forward only); for "module" (test_torch_port_sharding_
modules.py): the module class, its arguments, inputs and their layouts.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from modulated_deform_conv_tpu_torch import models
from modulated_deform_conv_tpu_torch.parallel import dryrun
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

_MESHES = {}


def _mesh(shape, names):
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = sh.make_mesh(shape, names, device_type="cpu")
    return _MESHES[key]


def _t(a):
    return None if a is None else torch.tensor(a, dtype=torch.float32)


def _spec(case):
    x, _, mask, w = case["inputs"][:4]
    kw = case["kw"]
    return DeformConvSpec.make(
        x.ndim - 2, w.shape[2:], kw.get("stride", 1), kw.get("padding", 0),
        kw.get("dilation", 1), kw.get("groups", 1),
        kw.get("deformable_groups", 1), modulated=mask is not None)


def _op_case(case):
    mesh = _mesh(*case["mesh"])
    if mesh.get_coordinate() is None:       # a rank outside a smaller mesh
        return {"skip": True}
    kw = dict(case["kw"])
    x, off, mask, w, b = (_t(a) for a in case["inputs"])
    plan = sh.shard_plan(
        x.shape, off.shape, w.shape, None if mask is None else mask.shape,
        None if b is None else b.shape, _spec(case), sh.axis_sizes(mesh),
        kw.get("batch_axis", "data"), kw.get("spatial_axis", "space"),
        kw.get("max_offset", 0.0), kw.get("halo"), kw.get("group_axis"))
    pl = plan.placements()
    roles = ("x", "x", "x", "weight", "bias")
    ins = [sh.local_shard(t, pl[r], mesh) for t, r in zip((x, off, mask, w,
                                                          b), roles)]
    cot = case.get("cot")
    for t in ins:
        if t is not None and cot is not None:
            t.requires_grad_(True)
    x_l, off_l, mask_l, w_l, b_l = ins
    args = (x_l, off_l, w_l) if mask is None else (x_l, off_l, mask_l, w_l)
    y = getattr(sh, case["fn"])(*args, b_l, mesh=mesh, **kw)
    res = {"coords": sh.mesh_coords(mesh), "sizes": sh.axis_sizes(mesh),
           "pl": pl, "out": y.detach()}
    if cot is not None:
        y.backward(sh.local_shard(_t(cot), pl["out"], mesh))
        res["grads"] = [None if t is None else t.grad for t in ins]
    return res


def _module_case(case):
    """A module with a mesh against the same module without, on every
    rank: the rank's shard of the output and of x's gradient, and every
    parameter's gradient, beside the unsharded ones."""
    mesh = _mesh(*case["mesh"])
    shard = dict(mesh=mesh, **case.get("shard", {}))
    torch.manual_seed(0)
    cls = getattr(models, case["cls"])
    mod = cls(*case["args"], **case.get("kwargs", {}), **shard, device="cpu")
    ref = cls(*case["args"], **case.get("kwargs", {}), device="cpu")
    ref.load_state_dict(mod.state_dict())
    inputs = [_t(a) for a in case["inputs"]]
    lay = case["layouts"]
    local = [sh.local_shard(t, lay_i, mesh).requires_grad_(True)
             for t, lay_i in zip(inputs, lay)]
    full = [t.clone().requires_grad_(True) for t in inputs]
    y, y0 = mod(*local), ref(*full)
    cot = _t(case["cot"])
    y.backward(sh.local_shard(cot, case["out_layout"], mesh))
    y0.backward(cot)
    return {"out": (y.detach(), sh.local_shard(y0.detach(),
                                                case["out_layout"], mesh)),
            "inputs": [(t.grad, sh.local_shard(f.grad, lay_i, mesh))
                       for t, f, lay_i in zip(local, full, lay)],
            "params": [(p.grad, q.grad) for p, q in zip(mod.parameters(),
                                                        ref.parameters())]}


def run_case(rank, n, case):
    kind = case["kind"]
    if kind == "op":
        return _op_case(case)
    if kind == "module":
        return _module_case(case)
    if kind == "dryrun":
        dryrun.dryrun_rank(rank, n)
        return {"ok": True}
    raise ValueError(f"unknown case kind {kind!r}")


def serve(rank, n, cases, out_dir):
    """Every case in order on this rank; the results (or each case's
    error) saved to out_dir/rank<rank>.pt."""
    results = {}
    for name, case in cases:
        try:
            results[name] = run_case(rank, n, case)
        except Exception as e:  # recorded: the parent asserts on it
            results[name] = {"error": (type(e).__name__, str(e))}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(cases, n, tmp_dir, timeout=300.0):
    """Run the cases on n spawned gloo ranks; {rank: results}."""
    tmp_dir = str(tmp_dir)
    dryrun.spawn_gloo(serve, n, cases, tmp_dir, store_dir=tmp_dir,
                      timeout=timeout)
    return {r: torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(n)}


def stitch(results, name, role, shape, pick):
    """The global tensor of `shape` from every rank's shard `pick(res)` of
    placement role `role`.  Where ranks hold the same slice (a replicated
    tensor or gradient) they must hold the same bits."""
    out = np.zeros(shape, np.float32)
    seen = np.zeros(shape, bool)
    for r in sorted(results):
        res = results[r][name]
        if "error" in res:
            raise AssertionError(f"rank {r}: {res['error']}")
        if res.get("skip"):
            continue
        sl = sh.shard_slices(shape, res["pl"][role], res["coords"],
                             res["sizes"])
        local = pick(res).numpy()
        again = seen[sl]
        assert np.array_equal(out[sl][again], local[again]), (
            f"{name}: ranks disagree on a replicated {role}")
        out[sl], seen[sl] = local, True
    assert seen.all()
    return out
