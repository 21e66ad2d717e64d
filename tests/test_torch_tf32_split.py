"""The 3xTF32 arithmetic of the float32 FF backward's tensor-core route
(`csrc/hopper_tf32.cuh`, `csrc/ffn_f32.cu` `ffn_f32_bwd_tc`), through its
plain twin `cat_tpu_torch.ops.ffn.tf32_split`.

Checks: hi and lo are TF32 values (low 13 bits zero) and hi + lo gives back
every normal f32 value within 2^-22 relative, ties, values next to powers
of two and the largest finite ones included; where lo is subnormal (|x|
below about 2^-115) the TF32 step there bounds it, 2^-137 absolute. A
product of split (256 x 2048) and (2048 x 256) operands as lo·hi + hi·lo
+ hi·hi, summed in float64, lies within 1e-6 relative norm of the float64
product of the unsplit operands and at least 100x closer than hi·hi
alone (single-pass TF32). The FF backward whose five products run in that
arithmetic (f32 sums) agrees with JAX's fused FF backward (Pallas,
interpret mode, float32) as closely as the plain version does. Every
width the port runs takes the tensor-core route.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops.ffn_pallas import fused_ff_residual as jax_ff
from cat_tpu_torch.ops import ffn

torch.set_num_threads(2)


def _bits(t):
    return t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _values(kind, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        v = rng.standard_normal(n) * 2.0 ** rng.integers(-100, 100, n)
    elif kind == "powers of two":
        e = rng.integers(-100, 120, n).astype(np.float64)
        k = rng.integers(-40, 40, n).astype(np.float64)
        v = np.sign(rng.standard_normal(n)) * 2.0 ** e * (1 + k * 2.0 ** -23)
    elif kind == "ties":
        m = rng.integers(1 << 10, 1 << 11, n).astype(np.float64)
        v = (m + 0.5) * 2.0 ** (rng.integers(-60, 60, n) - 10)
    elif kind == "largest":
        v = np.float32(3.4e38) * (1 - rng.random(n) * 1e-3)
    else:
        raise ValueError(kind)
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "powers of two", "ties",
                                  "largest"])
def test_split_reconstructs_normal_values(kind):
    x = _values(kind)
    hi, lo = ffn.tf32_split(x)
    assert (_bits(hi) & 0x1FFF == 0).all() and (_bits(lo) & 0x1FFF == 0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert torch.isfinite(hi).all() or kind == "largest"
    finite = torch.isfinite(hi)
    assert (err[finite] <= 2.0 ** -22 * x.double().abs()[finite]).all()
    assert finite.float().mean() > 0.9
    # hi alone is single-pass TF32: within 2^-11, no closer in general
    rel_hi = ((hi.double() - x.double()).abs() / x.double().abs())[finite]
    assert (rel_hi <= 2.0 ** -11).all()
    if kind == "random":
        assert rel_hi.max() > 2.0 ** -13


def test_split_of_subnormals_and_zeros():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(2000) * 2.0 ** -135,
        rng.standard_normal(2000) * 2.0 ** -118,
        [0.0, -0.0, 2.0 ** -149, -(2.0 ** -126)]]).astype(np.float32))
    hi, lo = ffn.tf32_split(x)
    assert (_bits(hi) & 0x1FFF == 0).all() and (_bits(lo) & 0x1FFF == 0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -137).all()
    assert torch.equal(hi[-4:-2] + lo[-4:-2], x[-4:-2])


def test_three_term_product_is_float32_accurate():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((256, 2048)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2048, 256)).astype(np.float32))
    (ah, al), (bh, bl) = ffn.tf32_split(a), ffn.tf32_split(b)
    d = lambda t: t.double()  # noqa: E731
    exact = d(a) @ d(b)
    three = d(al) @ d(bh) + d(ah) @ d(bl) + d(ah) @ d(bh)
    one = d(ah) @ d(bh)
    rel = lambda t: float((t - exact).norm() / exact.norm())  # noqa: E731
    assert rel(three) <= 1e-6
    assert rel(one) >= 100 * rel(three)


@pytest.mark.parametrize("D, F", [(16, 64), (256, 1024), (320, 1280),
                                  (512, 2048), (128, 512)])
def test_the_port_s_widths_take_the_tensor_cores(D, F):
    assert ffn.f32_bwd_route(D, F) == "tensor_cores"


@pytest.mark.parametrize("D, F", [(18, 72), (16, 66), (130, 520)])
def test_widths_tma_cannot_take_go_to_the_cuda_cores(D, F):
    assert ffn.f32_bwd_route(D, F) == "cuda_cores"


def _tf32_matmul(a, b):
    """a @ b as the kernel's products: lo·hi + hi·lo + hi·hi, f32 sums."""
    (ah, al), (bh, bl) = ffn.tf32_split(a), ffn.tf32_split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah,
                                                                          bh)


@pytest.mark.parametrize("N, T, D, F", [(2, 24, 128, 512), (1, 37, 128, 256)])
def test_ff_backward_in_3xtf32_matches_jax(N, T, D, F):
    rng = np.random.default_rng(N + T)
    f = lambda *s, scale=1.0: (rng.standard_normal(s)  # noqa: E731
                               * scale).astype(np.float32)
    params = (1 + f(D, scale=0.2), f(D, scale=0.1), f(D, F, scale=D ** -0.5),
              f(F, scale=0.05), f(F, D, scale=F ** -0.5), f(D, scale=0.05))
    x, g = f(N, T, D), f(N, T, D)
    want = jax.grad(lambda *a: jnp.sum(jax_ff(*a, interpret=True) * g),
                    argnums=tuple(range(7)))(jnp.asarray(x),
                                             *map(jnp.asarray, params))
    args = (torch.from_numpy(x), *map(torch.from_numpy, params),
            torch.from_numpy(g))
    plain = ffn.ff_backward_reference(*args)
    with mock.patch.object(torch.Tensor, "__matmul__", _tf32_matmul):
        got = ffn.ff_backward_reference(*args)
    for name, a, p, w in zip("x gamma beta w1 b1 w2 b2".split(), got, plain,
                             want):
        w = np.asarray(w, np.float64)
        e_got = np.linalg.norm(a.double().numpy() - w) / np.linalg.norm(w)
        e_plain = np.linalg.norm(p.double().numpy() - w) / np.linalg.norm(w)
        assert e_got <= 1e-5, (name, e_got)
        assert e_got <= 4 * e_plain + 1e-7, (name, e_got, e_plain)
