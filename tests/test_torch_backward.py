"""Port parity for the backward of the fused ops, in float32 on the CPU.

Each plain backward of `cat_tpu_torch.ops` (`ff_backward_reference`,
`glu_in_backward_reference`, `bn_out_backward_reference`,
`relpos_attention_backward_reference`) is held
- against `jax.grad` of the JAX op, run as the JAX package's own tests run
  it: the Pallas kernels in interpret mode, and for attention past one
  64-frame tile also the XLA reference; dropout rate 0 (the TPU's
  hardware bits cannot be matched);
- against `torch.autograd.grad` through the port's plain forward, at rate
  0 and 0.1 (the same Philox mask in forward and backward).
The autograd wrappers are checked to keep the graph: an output built from
inputs that require grad has a grad_fn, and every input gets a gradient.
Lengths are ragged, including a length of 1, and T crosses a 64-frame tile.
Tolerance: rtol 1e-4, atol 1e-4 (float32, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops.attention_pallas import flash_relpos_attention
from cat_tpu.ops.attention_pallas import \
    relpos_attention_reference as jax_attention
from cat_tpu.ops.conv_module_pallas import fused_bn_out as jax_bn_out
from cat_tpu.ops.conv_module_pallas import fused_glu_in as jax_glu_in
from cat_tpu.ops.ffn_pallas import fused_ff_residual as jax_ff
from cat_tpu_torch.ops import attention, conv_module, ffn

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
SEED = (0x12345678, 0x9ABCDEF0)


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=name,
                               **TOL)


def _autograd(fn, tensors, dout):
    leaves = [torch.from_numpy(a).requires_grad_() for a in tensors]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, dout)


# ---- FF module ----

def _ff_case(N, T, D, F, seed):
    f = _rng(seed)
    params = (1 + f(D, scale=0.2), f(D, scale=0.1), f(D, F, scale=D ** -0.5),
              f(F, scale=0.05), f(F, D, scale=F ** -0.5), f(D, scale=0.05))
    return f(N, T, D), params, f(N, T, D)


@pytest.mark.parametrize("N,T,D,F,alpha", [(2, 24, 128, 512, 0.5),
                                           (1, 37, 128, 256, 1.0)])
def test_ff_backward_matches_jax(N, T, D, F, alpha):
    x, params, g = _ff_case(N, T, D, F, seed=N + T)
    want = jax.grad(lambda *a: jnp.sum(jax_ff(*a, alpha=alpha, interpret=True)
                                       * g), argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, params))
    got = ffn.ff_backward_reference(torch.from_numpy(x),
                                    *map(torch.from_numpy, params),
                                    torch.from_numpy(g), alpha=alpha)
    for name, a, b in zip("x gamma beta w1 b1 w2 b2".split(), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ff_backward_matches_autograd(rate):
    x, params, g = _ff_case(2, 13, 128, 256, seed=7)
    want = _autograd(lambda *a: ffn.ff_reference(*a, alpha=0.5, rate=rate,
                                                 seed=SEED),
                     (x, *params), torch.from_numpy(g))
    got = ffn.ff_backward_reference(torch.from_numpy(x),
                                    *map(torch.from_numpy, params),
                                    torch.from_numpy(g), alpha=0.5,
                                    rate=rate, seed=SEED)
    for name, a, b in zip("x gamma beta w1 b1 w2 b2".split(), got, want):
        _close(a, b, name)


# ---- conv module stages ----

def _mask(N, T):
    lengths = np.array([T] + [max(T - 7 * i, 1) for i in range(1, N - 1)]
                       + [1])[:N]
    return np.arange(T)[None, :] < lengths[:, None]


@pytest.mark.parametrize("N,T,D", [(2, 30, 128), (3, 17, 256)])
def test_glu_in_backward_matches_jax(N, T, D):
    f = _rng(D + T)
    mask = _mask(N, T)
    x, g = f(N, T, D), f(N, T, D)
    params = (1 + f(D, scale=0.2), f(D, scale=0.1),
              f(D, 2 * D, scale=D ** -0.5), f(2 * D, scale=0.05))
    want = jax.grad(
        lambda x, *p: jnp.sum(jax_glu_in(x, jnp.asarray(mask), *p,
                                         interpret=True) * g),
        argnums=tuple(range(5)))(jnp.asarray(x), *map(jnp.asarray, params))
    got = conv_module.glu_in_backward_reference(
        torch.from_numpy(x), torch.from_numpy(mask),
        *map(torch.from_numpy, params), torch.from_numpy(g))
    for name, a, b in zip("x gamma beta w b".split(), got, want):
        _close(a, b, name)
    auto = _autograd(lambda x, *p: conv_module.glu_in_reference(
        x, torch.from_numpy(mask), *p), (x, *params), torch.from_numpy(g))
    for name, a, b in zip("x gamma beta w b".split(), got, auto):
        _close(a, b, "autograd " + name)


def _bn_case(N, T, D, seed):
    f = _rng(seed)
    conv, x, g = f(N, T, D), f(N, T, D), f(N, T, D)
    params = (f(D, scale=0.1), 1 + np.abs(f(D, scale=0.3)),
              1 + f(D, scale=0.1), f(D, scale=0.1), f(D, D, scale=D ** -0.5),
              f(D, scale=0.05))
    return conv, x, g, params


@pytest.mark.parametrize("N,T,D", [(2, 30, 128), (3, 17, 256)])
def test_bn_out_backward_matches_jax(N, T, D):
    conv, x, g, params = _bn_case(N, T, D, seed=D * T)
    mask = _mask(N, T)
    want = jax.grad(
        lambda c, x, *p: jnp.sum(jax_bn_out(c, x, jnp.asarray(mask), *p,
                                            interpret=True) * g),
        argnums=tuple(range(8)))(jnp.asarray(conv), jnp.asarray(x),
                                 *map(jnp.asarray, params))
    dc, dmu, dvar, dsc, dbi, dw, db = conv_module.bn_out_backward_reference(
        torch.from_numpy(conv), torch.from_numpy(x), torch.from_numpy(mask),
        *map(torch.from_numpy, params), torch.from_numpy(g))
    got = (dc, g, dmu, dvar, dsc, dbi, dw, db)  # dx is dO itself
    for name, a, b in zip("conv x mean var scale bias w b".split(), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bn_out_backward_matches_autograd(rate):
    conv, x, g, params = _bn_case(2, 21, 128, seed=3)
    mask = torch.from_numpy(_mask(2, 21))
    auto = _autograd(lambda c, x, *p: conv_module.bn_out_reference(
        c, x, mask, *p, rate=rate, seed=SEED), (conv, x, *params),
        torch.from_numpy(g))
    dc, dmu, dvar, dsc, dbi, dw, db = conv_module.bn_out_backward_reference(
        torch.from_numpy(conv), torch.from_numpy(x), mask,
        *map(torch.from_numpy, params), torch.from_numpy(g), rate=rate,
        seed=SEED)
    got = (dc, torch.from_numpy(g), dmu, dvar, dsc, dbi, dw, db)
    for name, a, b in zip("conv x mean var scale bias w b".split(), got, auto):
        _close(a, b, name)


# ---- rel-pos attention ----

def _attn_case(N, T, H, Dh, seed):
    f = _rng(seed)
    q, k, v = f(N, T, H, Dh), f(N, T, H, Dh), f(N, T, H, Dh)
    p = f(2 * T - 1, H, Dh, scale=0.5)
    u, vb = f(H, Dh, scale=0.1), f(H, Dh, scale=0.1)
    lengths = np.array([T] + [max(T - 31 * i, 1) for i in range(1, N - 1)]
                       + [1])[:N]
    kmask = np.arange(T)[None, :] < lengths[:, None]
    g = f(N, T, H, Dh) * kmask[:, :, None, None]  # the layer zeroes padding
    return (q, k, v, p, u, vb), lengths, kmask, g


def _port_attention_grads(args, lengths, g, rate=0.0):
    t = [torch.from_numpy(a) for a in args]
    out, lse = attention.relpos_attention_reference_lse(
        *t, torch.from_numpy(lengths), rate=rate, seed=SEED)
    return attention.relpos_attention_backward_reference(
        *t, torch.from_numpy(lengths), out, lse, torch.from_numpy(g),
        rate=rate, seed=SEED)


@pytest.mark.parametrize("N,T,H,Dh,kernel", [(3, 70, 2, 16, True),
                                             (2, 130, 2, 32, False)])
def test_attention_backward_matches_jax(N, T, H, Dh, kernel):
    """T=70 against the single-tile Pallas kernel in interpret mode (the
    TPU's path up to 512 frames); T=130 against the XLA reference."""
    args, lengths, kmask, g = _attn_case(N, T, H, Dh, seed=T)
    km = jnp.asarray(kmask)
    if kernel:
        fn = lambda *a: flash_relpos_attention(*a, km, interpret=True)
    else:
        fn = lambda *a: jax_attention(*a, km)
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * g),
                    argnums=tuple(range(6)))(*map(jnp.asarray, args))
    got = _port_attention_grads(args, lengths, g)
    for name, a, b in zip("q k v p u v_bias".split(), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_backward_matches_autograd(rate):
    args, lengths, kmask, g = _attn_case(3, 67, 2, 16, seed=11)
    auto = _autograd(lambda *a: attention.relpos_attention_reference(
        *a, torch.from_numpy(lengths), rate=rate, seed=SEED), args,
        torch.from_numpy(g))
    got = _port_attention_grads(args, lengths, g, rate)
    for name, a, b in zip("q k v p u v_bias".split(), got, auto):
        _close(a, b, name)


# ---- the autograd wrappers keep the graph ----

def test_fused_ops_keep_the_graph_on_the_cpu():
    """Every fused op is an autograd Function: on the CPU each output built
    from inputs that require grad has a grad_fn, and every such input
    receives a gradient."""
    leaves = lambda *arrays: [torch.from_numpy(a).requires_grad_()
                              for a in arrays]
    x, params, _ = _ff_case(1, 9, 128, 256, seed=1)
    ins = leaves(x, *params)
    out = ffn.fused_ff_residual(*ins, rate=0.1, seed=SEED)
    conv, x2, _, bp = _bn_case(2, 9, 128, seed=2)
    mask = torch.from_numpy(_mask(2, 9))
    f = _rng(3)
    glu = leaves(x2, 1 + f(128), f(128), f(128, 256, scale=0.1), f(256))
    bn = leaves(conv, x2, *bp)
    args, lengths, _, _ = _attn_case(2, 9, 2, 16, seed=4)
    att = leaves(*args)
    outs = [out, conv_module.fused_glu_in(glu[0], mask, *glu[1:]),
            conv_module.fused_bn_out(bn[0], bn[1], mask, *bn[2:], rate=0.1,
                                     seed=SEED),
            attention.relpos_attention(*att, torch.from_numpy(lengths),
                                       rate=0.1, seed=SEED)]
    assert all(o.grad_fn is not None for o in outs)
    sum(o.sum() for o in outs).backward()
    for t in ins + glu + bn + att:
        assert t.grad is not None and torch.isfinite(t.grad).all()
