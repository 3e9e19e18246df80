"""The kernels' dtype rule (`lib.io_dtype`, `lib.kernel_inputs`) and the
four kernel entries on CPU tensors: bf16 activations go to the autograd
Functions as they are, the Functions save the caller's tensors, and every
result has its input's type; fp16 and mixed activation types take the
upcast route.  No JAX; about 5 s on the CPU.
"""
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

from test_torch_port_sharding_lead import GEOMETRIES, _globals, _plan, _spec

bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16


def _meta(dtype, shape=(1, 8, 4, 4)):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("types, want", [
    ((bf16, bf16, bf16), bf16),
    ((f32, f32, f32), f32),
    ((bf16, bf16, None), bf16),
    ((bf16, f32, bf16), None),     # mixed activations: upcast
    ((f32, f32, bf16), None),
    ((f16, f16, f16), None),       # fp16: upcast, as JAX does
    ((torch.float64,) * 3, None),
])
def test_io_dtype(types, want):
    x, off, mask = (None if t is None else _meta(t) for t in types)
    assert lib.io_dtype(x, off, mask) == want


@pytest.mark.parametrize("wtype", [f32, bf16])
def test_kernel_inputs_pass_bf16_through(wtype):
    """bf16 activations with an fp32 (the Packs) or a bf16 weight: all
    five tensors reach the Function as they are, no copy."""
    x, off, mask = (torch.ones(1, 4, 2, 2, dtype=bf16) for _ in range(3))
    w, b = torch.ones(4, 4, 3, 3, dtype=wtype), torch.ones(4, dtype=wtype)
    got = lib.kernel_inputs(x, off, mask, w, b)
    assert all(g is t for g, t in zip(got, (x, off, mask, w, b)))


@pytest.mark.parametrize("types", [(bf16, f32), (f16, f16)])
def test_kernel_inputs_upcast_route(types):
    """Mixed activation types, and fp16, go to the kernels in fp32; an fp16
    weight too, an fp32 one as it is."""
    xt, ot = types
    x, mask = torch.ones(1, 4, 2, 2, dtype=xt), torch.ones(1, 4, 2, 2,
                                                           dtype=xt)
    off = torch.ones(1, 4, 2, 2, dtype=ot)
    w = torch.ones(4, 4, 3, 3, dtype=f16)
    got = lib.kernel_inputs(x, off, mask, w, None)
    assert [t.dtype for t in got[:4]] == [f32] * 4 and got[4] is None


def test_weight_layouts_widen_bf16_exactly():
    w = torch.randn(8, 4, 3, 3).to(bf16)
    for fn in (lib.fwd_weight, lib.tap_major_weight):
        got = fn(w, 2)
        assert got.dtype == f32 and got.is_contiguous()
        assert torch.equal(got, fn(w.float(), 2))


def _inputs(nd, B=1, C=8, O=8, S=None, g=1, bound=1.0, wtype=f32, seed=0):
    S = S or ((6, 6) if nd == 2 else (2, 8, 16))
    spec = DeformConvSpec.make(nd, 3, 1, 1, 1, g, 1, modulated=True)
    K = spec.tap_count
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, C) + S),
            rng.uniform(-bound, bound, (B, nd * K) + S),
            rng.uniform(0, 1, (B, K) + S)]
    ts = [torch.tensor(a, dtype=f32).to(bf16).requires_grad_(True)
          for a in arrs]
    ts += [torch.tensor(rng.standard_normal((O, C // g) + (3,) * nd) * 0.2,
                        dtype=f32).to(wtype).requires_grad_(True),
           torch.tensor(rng.standard_normal((O,)), dtype=f32).to(
               wtype).requires_grad_(True)]
    cot = torch.tensor(rng.standard_normal((B, O) + S), dtype=f32).to(bf16)
    return spec, ts, cot


def _node(out, name):
    """The autograd node named `name` under out."""
    todo, seen = [out.grad_fn], set()
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        if type(n).__name__ == name:
            return n
        todo += [m for m, _ in n.next_functions]
    raise AssertionError(f"no {name} under {out.grad_fn}")


ENTRIES = {
    "fused_pair": (2, 1, "_GathermmFwdBackward",
                   lambda ts, s: gm.deform_conv_fused_pair(
                       *ts, s, "float32")),
    "fused_pair_3d": (3, 1, "_GathermmFwdBackward",
                      lambda ts, s: gm.deform_conv_fused_pair(
                          *ts, s, "float32")),
    "cols": (2, 2, "_GathermmColsBackward",
             lambda ts, s: gm.deform_conv_cols(*ts, s, "bfloat16")),
    "shift": (2, 1, "_ShiftblendFwdBackward",
              lambda ts, s: sb.deform_conv_shift(*ts, s, "float32", 1.0)),
    "shift_3d": (3, 1, "_ShiftblendFwdBackward",
                 lambda ts, s: sb.deform_conv_shift(*ts, s, "float32", 1.0)),
}


@pytest.mark.parametrize("wtype", [f32, bf16])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_keeps_callers_types(entry, wtype):
    """out has x's type, each gradient its input's; the Function saved the
    caller's bf16 tensors themselves (x, offset, mask, and the weight but
    on the columns path, whose product saves it)."""
    nd, g, node, fn = ENTRIES[entry]
    spec, ts, cot = _inputs(nd, g=g, wtype=wtype)
    out = fn(ts, spec)
    assert out.dtype == bf16
    saved = _node(out, node).saved_tensors
    for t, s in zip(ts, saved):
        assert s.dtype == t.dtype and s.data_ptr() == t.data_ptr()
    out.backward(cot)
    assert [t.grad.dtype for t in ts] == [bf16] * 3 + [wtype] * 2
    assert all(torch.isfinite(t.grad.float()).all() for t in ts)


def test_entry_mixed_types_take_upcast_route():
    """bf16 x with an fp32 offset: the Function gets fp32 copies and the
    results are cast back to each input's type."""
    spec, ts, cot = _inputs(2)
    off32 = ts[1].detach().float().requires_grad_(True)
    ins = [ts[0], off32] + ts[2:]
    out = gm.deform_conv_fused_pair(*ins, spec, "float32")
    assert out.dtype == bf16
    saved = _node(out, "_GathermmFwdBackward").saved_tensors
    assert [s.dtype for s in saved[:3]] == [f32] * 3
    out.backward(cot)
    assert [t.grad.dtype for t in ins] == [bf16, f32, bf16, f32, f32]


def test_sharded_lead_entry_keeps_callers_types():
    """`deform_conv_shift_sharded` on an interior shard's block in bf16."""
    mo = GEOMETRIES["2d"][-1]
    g = [torch.tensor(a) for a in _globals("2d", False)]
    plan = _plan("2d", *g[:4])
    (shd,) = plan.shards
    xe = sh.cut_block(g[0], plan.shards, [1])
    local, placement, gates = sh.block_args(_spec("2d"), plan.shards, [1],
                                            tuple(xe.shape[2:]))
    sl = slice(shd.out_local, 2 * shd.out_local)
    ts = [t.contiguous().to(bf16).requires_grad_(True)
          for t in (xe, g[1][:, :, sl], g[2][:, :, sl])]
    ts += [t.clone().requires_grad_(True) for t in g[3:]]
    OS = tuple(ts[1].shape[2:])
    out = sb.deform_conv_shift_sharded(*ts, local, "float32", mo, OS, gates,
                                       placement)
    assert out.dtype == bf16 and tuple(out.shape[2:]) == OS
    saved = _node(out, "_ShiftblendFwdBackward").saved_tensors
    for t, s in zip(ts, saved):
        assert s.data_ptr() == t.data_ptr()
    out.backward(torch.ones_like(out))
    assert [t.grad.dtype for t in ts] == [bf16] * 3 + [f32] * 2


@pytest.mark.parametrize("nd", [2, 3])
def test_wrappers_return_input_types(nd):
    """The kernel wrappers on CPU tensors (their plain versions): out of
    x's type, grad_weight of the weight's, and the same values as the
    upcast route's results cast back (the plain versions read bf16 in
    fp32 and round once)."""
    spec, ts, cot = _inputs(nd)
    x, off, mask, w, b = (t.detach() for t in ts)
    fwd, bwd = gm.fused_fwd, gm.fused_bwd
    out = fwd(x, off, mask, w, b, spec, "float32")
    up = fwd(x.float(), off.float(), mask.float(), w, b, spec, "float32")
    assert out.dtype == bf16 and torch.equal(out, up.to(bf16))
    grads = bwd(x, off, mask, w, cot, spec, "float32")
    ups = bwd(x.float(), off.float(), mask.float(), w, cot.float(), spec,
              "float32")
    for g, u, t in zip(grads, ups, (x, off, mask, w)):
        assert g.dtype == t.dtype and torch.equal(g, u.to(t.dtype))
