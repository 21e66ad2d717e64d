"""Port parity for the conv module's bn_out stage at the edges that its
CUDA kernels (`cat_tpu_torch/csrc/bn_out.cu`) are held to on the card, in
float32 on the CPU, and the backward's launch plan.

`bn_out_reference` and `bn_out_backward_reference`, the plain versions
that the kernels are compared with in `tests/test_torch_cuda.py` and
`chip_smoke.py`, against the JAX package's `fused_bn_out` (its Pallas
kernels in interpret mode, and `jax.grad` through them) at the widths 384
and 512, one row, and a mask with every frame off, which gives out = x
and zero gradients exactly (dx is dO itself, the residual), as the
kernels' sums without atomics must too.

`bn_out_plan` (the backward's wgrad split and workspace): every 64-row
block of R lies in exactly one split and one column-partial block; and a
blocked emulation of the kernels' fixed-order sums on the plan (column
partials of each 64-row block, 8 warps over the blocks in turn, weight
partials by split, dmu and dvar formed from the sums) against the plain
backward.
Tolerance: rtol 1e-4, atol 1e-4 (float32, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops.conv_module_pallas import fused_bn_out as jax_bn_out
from cat_tpu_torch.ops import conv_module

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
EPS = conv_module.BN_EPS


def _case(N, T, D, mask, seed):
    """conv, x, dO (N, T, D), the mask (N, T) ("ragged": lengths T, T - 7,
    ...; "off": every frame off) and the parameters (mean, var, scale,
    bias, W, b), f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    conv, x, g = f(N, T, D), f(N, T, D), f(N, T, D)
    lengths = np.array([max(T - 7 * i, 1) for i in range(N)])
    m = np.arange(T)[None, :] < lengths[:, None]
    if mask == "off":
        m[:] = False
    params = (f(D, scale=0.1), 1 + np.abs(f(D, scale=0.3)),
              1 + f(D, scale=0.1), f(D, scale=0.1), f(D, D, scale=D ** -0.5),
              f(D, scale=0.05))
    return conv, x, g, m, params


# widths the existing parity tests leave out, one row, every frame off
CASES = [(2, 30, 384, "ragged"), (3, 17, 512, "ragged"), (1, 1, 512, "ragged"),
         (2, 9, 384, "off")]


@pytest.mark.parametrize("N,T,D,mask", CASES)
def test_bn_out_matches_jax(N, T, D, mask):
    conv, x, _, m, params = _case(N, T, D, mask, seed=D + T)
    want = np.asarray(jax_bn_out(jnp.asarray(conv), jnp.asarray(x),
                                 jnp.asarray(m), *map(jnp.asarray, params),
                                 interpret=True))
    got = conv_module.fused_bn_out(torch.from_numpy(conv),
                                   torch.from_numpy(x), torch.from_numpy(m),
                                   *map(torch.from_numpy, params))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy()[~m], x[~m])


@pytest.mark.parametrize("N,T,D,mask", CASES)
def test_bn_out_backward_matches_jax(N, T, D, mask):
    conv, x, g, m, params = _case(N, T, D, mask, seed=D * T)
    want = jax.grad(
        lambda c, x, *p: jnp.sum(jax_bn_out(c, x, jnp.asarray(m), *p,
                                            interpret=True) * g),
        argnums=tuple(range(8)))(jnp.asarray(conv), jnp.asarray(x),
                                 *map(jnp.asarray, params))
    dc, dmu, dvar, dsc, dbi, dw, db = conv_module.bn_out_backward_reference(
        torch.from_numpy(conv), torch.from_numpy(x), torch.from_numpy(m),
        *map(torch.from_numpy, params), torch.from_numpy(g))
    got = (dc, torch.from_numpy(g), dmu, dvar, dsc, dbi, dw, db)
    names = "conv x mean var scale bias w b".split()
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    if mask == "off":  # no row passes a gradient, but dx = dO
        for name, a in zip(names, got):
            assert (name == "x") == bool(a.any()), name


@pytest.mark.parametrize("R", [0, 1, 63, 64, 65, 4097, 15776])
def test_bn_out_plan_covers_every_row_once(R):
    rows = np.arange(R)
    for D in conv_module._DIMS:
        plan = conv_module.bn_out_plan(R, D)
        assert plan.blocks == -(-R // conv_module.BN_ROWS)
        block = rows // conv_module.BN_ROWS
        assert (block < plan.blocks).all()
        assert np.array_equal(np.bincount(block, minlength=plan.blocks)
                              .astype(bool), np.ones(plan.blocks, bool))
        # the wgrad splits: `per` blocks each, none empty, one wave of
        # (D/128)² output tiles at most, unless R is not split
        split = block // max(plan.per, 1)
        assert 1 <= plan.splits <= conv_module.BN_MAX_SPLITS
        assert (split < plan.splits).all()
        if R:
            assert (plan.splits - 1) * plan.per < plan.blocks \
                <= plan.splits * plan.per
            assert len(np.unique(split)) == plan.splits
        tiles = (D // 128) ** 2
        assert plan.splits == 1 or plan.splits * tiles <= conv_module.SMS
        assert plan.ws_floats == 3 * plan.blocks * D + (
            plan.splits * D * D if plan.splits > 1 else 0)
        assert plan.ws_floats % 64 == 0


def _emulate(conv, mask, mean, var, scale, bias, w, dout, plan):
    """The kernels' backward on `plan`, in float32: per-row values, the
    column partials of each 64-row block, the reduce's order (8 warps over
    the blocks in turn, then the 8 warp sums in order), weight partials
    by split summed in split order, dmu and dvar from the reduced sums."""
    R, D = conv.shape
    rstd = torch.rsqrt(var + EPS)
    xn = (conv - mean) * rstd
    y0 = xn * scale + bias
    sig = torch.sigmoid(y0)
    y = y0 * sig
    dh = dout * mask[:, None]
    dy0 = (dh @ w.t()) * sig * (1.0 + y0 * (1.0 - sig))
    dconv = dy0 * scale * rstd
    step = conv_module.BN_ROWS

    def reduce(v):
        parts = [v[b * step:(b + 1) * step].sum(0) for b in range(plan.blocks)]
        total = torch.zeros(D)
        for warp in range(8):
            s = torch.zeros(D)
            for p in parts[warp::8]:
                s = s + p
            total = total + s
        return total

    db, sdy, sdx = reduce(dh), reduce(dy0), reduce(dy0 * xn)
    dw = torch.zeros(D, D)
    rows = plan.per * step
    for sp in range(plan.splits):
        dw = dw + y[sp * rows:(sp + 1) * rows].t() @ dh[sp * rows:(sp + 1) * rows]
    dmu = -scale * rstd * sdy
    dvar = -0.5 * scale * rstd * rstd * sdx
    return dconv, dmu, dvar, sdx, sdy, dw, db


@pytest.mark.parametrize("R,D", [(0, 128), (1, 384), (65, 256), (300, 128),
                                 (4097, 128)])
def test_bn_out_blocked_sums_match_the_plain_backward(R, D):
    rng = np.random.default_rng(R + D)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32))
    conv, x, dout = f(R, D), f(R, D), f(R, D)
    mask = torch.from_numpy(rng.random(R) > 0.2)
    mean, var = f(D, scale=0.1), 1 + f(D, scale=0.3).abs()
    scale, bias, w, b = (1 + f(D, scale=0.1), f(D, scale=0.1),
                         f(D, D, scale=D ** -0.5), f(D, scale=0.05))
    plan = conv_module.bn_out_plan(R, D)
    got = _emulate(conv, mask.float(), mean, var, scale, bias, w, dout, plan)
    want = conv_module.bn_out_backward_reference(
        conv, x, mask, mean, var, scale, bias, w, b, dout)
    for name, a, b_ in zip("conv mean var scale bias w b".split(), got, want):
        assert a.shape == b_.shape, name
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL, err_msg=name)
