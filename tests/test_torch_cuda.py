"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked `cuda`, and skips
elsewhere. The file imports nothing of JAX (the machine with the card has
none), so it runs there without the repo's JAX conftest:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes cover what chip_smoke.py's batches do not: every width the kernels
take (D 128-512, Dh 16-128), ragged row counts, lengths of 1 and T, T of 1
and past 512, dropout rates 0 and 0.1 (the plain versions draw the same
Philox masks as the kernels), and identical, constant and zero rows.
Tolerance (`cat_tpu_torch.utils.tolerance`): bf16 outputs |kernel - plain|
<= 0.02 + 0.02·|plain|; f32 gradients that are sums over many rows
(weight, bias, norm, position and statistics gradients) ||kernel - plain||
/ ||plain|| <= 1e-2, because their bf16 operands are summed in another
order (by atomics in the attention backward at Dh 16, 32 and 128).
The loss kernels (f32), as chip_smoke.py holds them: dropout bit for
bit; CTC states live in the plain version (above LOG_EPS / 2) within
1e-3 + 2e-6·|plain|, den snapshots there within 1e-5 relative, the other
states at or below LOG_EPS / 2 in both; den logZ to 1e-5 relative;
gradient rows |kernel - plain| <= 1e-3 + 1e-3·|plain|; CTC and RNN-T
states on both routes of `ctc.ctc_plan` and `rnnt.rnnt_plan`, two calls
bit for bit. The front end and the device beam (no kernel of their own):
cuFFT's log-mel and CMVN against the CPU's within 1e-3 + 1e-4·|x| in the
mel bins within 16 nats of their frame's largest, the others' power
within 1e-9 of the frame's largest against a float64 witness; the batched
prefix beam against the same function on the CPU (prefixes of live lanes
identical, scores within 1e-4 + 1e-5·|s|); both bit for bit over two
calls on the card.
"""
import numpy as np
import pytest
import torch

from cat_tpu_torch.ctc.train import build_model
from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.models.layers import length_mask
from cat_tpu_torch.ops import attention, conv_module, crf_dense, ctc, dropout
from cat_tpu_torch.ops import ffn, rnnt, rnnt_simple
from cat_tpu_torch.utils import tolerance

pytestmark = pytest.mark.cuda
TOL = dict(atol=tolerance.ATOL, rtol=tolerance.RTOL)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the port's CUDA kernels")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, s=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * s).to(dtype)


def _close(got, want, mask=None):
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


def _rel(got, want, name=""):
    """The relative norm tolerance of `cat_tpu_torch.utils.tolerance`."""
    assert torch.isfinite(got.float()).all(), name
    err, bound = tolerance.rel_error(got, want)
    assert err <= bound, f"{name}: error norm {err:.3g} > {bound:.3g}"


SEED = (0x2468ACE0, 0x13579BDF)


def _special_rows(t):
    """t (N, T, D) with identical, constant and zero rows in every
    utterance, where T allows (as chip_smoke.py's `special_rows`)."""
    T = t.shape[1]
    if T < 8:
        return t
    t = t.clone()
    a, b, c = T // 4, T // 2, 3 * T // 4
    t[:, a:b] = t[:, a - 1:a]
    t[:, b:c] = t[:, b:c, :1]
    t[:, c:c + 2] = 0
    return t


def _ffn_inputs(gen, D, F, N, T):
    x = _special_rows(_rnd(gen, N, T, D, dtype=torch.bfloat16))
    do = _rnd(gen, N, T, D, dtype=torch.bfloat16)
    p = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, F, s=D ** -0.5), _rnd(gen, F, s=0.1),
         _rnd(gen, F, D, s=F ** -0.5), _rnd(gen, D, s=0.1))
    return x, do, p


# every width; row counts R = N·T of 1, around the 64-row blocks of the
# row passes and the 64- and 128-row tiles of the products (63, 64, 65,
# 129) and 4,097 (the forward's down product on 128-row tiles there, on
# 64-row ones at the others); F of 64 and 192, not multiples of the
# 128-column tile
FFN_SHAPES = [(128, 512, 1, 1), (256, 1024, 3, 11), (384, 1536, 2, 33),
              (512, 2048, 2, 50), (128, 64, 1, 63), (256, 192, 1, 64),
              (512, 64, 1, 65), (384, 192, 1, 129), (512, 2048, 1, 4097)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,F,N,T", FFN_SHAPES)
def test_ffn_kernel(gen, D, F, N, T, rate):
    x, _, p = _ffn_inputs(gen, D, F, N, T)
    kw = dict(alpha=1.0, rate=rate, seed=SEED)
    before = ffn.ff_forward.launches
    got = ffn.fused_ff_residual(x, *p, **kw)
    assert ffn.ff_forward.launches == before + 1
    _close(got, ffn.ff_reference(x, *p, **kw))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,F,N,T", FFN_SHAPES)
def test_ffn_backward_kernel(gen, D, F, N, T, rate):
    x, do, p = _ffn_inputs(gen, D, F, N, T)
    kw = dict(alpha=0.5, rate=rate, seed=SEED)
    _close(ffn.ff_forward(x, *p, **kw), ffn.ff_reference(x, *p, **kw))
    before = ffn.ff_backward.launches
    got = ffn.ff_backward(x, *p, do, **kw)
    assert ffn.ff_backward.launches == before + 1
    want = ffn.ff_backward_reference(x, *p, do, **kw)
    # a layer norm's backward multiplies rows of zero variance by
    # 1/sqrt(eps): there dx is held to the relative norm (chip_smoke.py)
    flat = x.float().var(-1) == 0
    _close(got[0], want[0], ~flat)
    if flat.any():
        _rel(got[0][flat], want[0][flat], "dx, zero-variance rows")
    for name, a, b in zip("gamma beta w1 b1 w2 b2".split(), got[1:], want[1:]):
        _rel(a, b, name)


# the weight gradients unsplit (D = 512) and split over R (D = 128: 8
# output tiles, 8 splits summed by the reduce pass)
@pytest.mark.parametrize("D,F,N,T", [(512, 2048, 4, 300), (128, 512, 1, 4097)])
def test_ffn_backward_kernel_is_reproducible(gen, D, F, N, T):
    x, do, p = _ffn_inputs(gen, D, F, N, T)
    kw = dict(alpha=0.5, rate=0.1, seed=SEED)
    first = ffn.ff_backward(x, *p, do, **kw)
    second = ffn.ff_backward(x, *p, do, **kw)
    for name, a, b in zip("x gamma beta w1 b1 w2 b2".split(), first, second):
        assert torch.equal(a, b), name


# the forward's down product on 128-row tiles (R = 2,400, D = 512: 76
# tiles, or 152 of 64 rows, two on some of the 132 SMs) and on 64-row
# ping-pong tiles (R = 4,097, D = 128: 65 tiles of 64 rows, one a block)
@pytest.mark.parametrize("D,F,N,T", [(512, 2048, 4, 600), (128, 512, 1, 4097)])
def test_ffn_forward_kernel_is_reproducible(gen, D, F, N, T):
    x, _, p = _ffn_inputs(gen, D, F, N, T)
    kw = dict(alpha=0.5, rate=0.1, seed=SEED)
    assert torch.equal(ffn.ff_forward(x, *p, **kw), ffn.ff_forward(x, *p, **kw))


@pytest.mark.parametrize("D,N,T", [(128, 1, 1), (256, 3, 11), (384, 2, 33),
                                   (512, 2, 50)])
def test_conv_module_kernels(gen, D, N, T):
    bf = torch.bfloat16
    x, c = _rnd(gen, N, T, D, dtype=bf), _rnd(gen, N, T, D, dtype=bf)
    mask = length_mask(torch.tensor([T] + [max(T // 2, 1)] * (N - 1),
                                    device="cuda"), T)
    g = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, 2 * D, s=D ** -0.5), _rnd(gen, 2 * D, s=0.1))
    _close(conv_module.fused_glu_in(x, mask, *g),
           conv_module.glu_in_reference(x, mask, *g))
    b = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
         1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, D, s=D ** -0.5), _rnd(gen, D, s=0.1))
    _close(conv_module.fused_bn_out(c, x, mask, *b),
           conv_module.bn_out_reference(c, x, mask, *b))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,N,T", [(128, 1, 1), (256, 3, 11), (384, 2, 33),
                                   (512, 2, 50)])
def test_conv_module_backward_kernels(gen, D, N, T, rate):
    bf = torch.bfloat16
    x, c = _rnd(gen, N, T, D, dtype=bf), _rnd(gen, N, T, D, dtype=bf)
    do = _rnd(gen, N, T, D, dtype=bf)
    mask = length_mask(torch.tensor([T] + [max(T // 2, 1)] * (N - 1),
                                    device="cuda"), T)
    g = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, 2 * D, s=D ** -0.5), _rnd(gen, 2 * D, s=0.1))
    got = conv_module.glu_in_backward(x, mask, *g, do)
    want = conv_module.glu_in_backward_reference(x, mask, *g, do)
    _close(got[0], want[0])
    for name, a, b in zip("gamma beta w b".split(), got[1:], want[1:]):
        _rel(a, b, "glu_in " + name)
    b = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
         1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, D, s=D ** -0.5), _rnd(gen, D, s=0.1))
    kw = dict(rate=rate, seed=SEED)
    _close(conv_module.bn_out_forward(c, x, mask, *b, **kw),
           conv_module.bn_out_reference(c, x, mask, *b, **kw))
    got = conv_module.bn_out_backward(c, x, mask, *b, do, **kw)
    want = conv_module.bn_out_backward_reference(c, x, mask, *b, do, **kw)
    _close(got[0], want[0])
    for name, a, b_ in zip("mean var scale bias w b".split(), got[1:],
                           want[1:]):
        _rel(a, b_, "bn_out " + name)


def _glu_inputs(gen, D, R, mask="ragged"):
    """x, dO (1, R, D) bf16 with identical, constant and zero rows where R
    allows; mask (1, R): about 1 in 5 rows off at random, all off, or all
    on; the glu_in parameters (gamma, beta, W (D, 2D), b)."""
    bf = torch.bfloat16
    x = _special_rows(_rnd(gen, 1, R, D, dtype=bf))
    do = _special_rows(_rnd(gen, 1, R, D, dtype=bf))
    m = torch.rand(1, R, generator=gen, device="cuda") > 0.2
    m = {"ragged": m, "zero": torch.zeros_like(m), "one": torch.ones_like(m)}
    g = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, 2 * D, s=D ** -0.5), _rnd(gen, 2 * D, s=0.1))
    return x, do, m[mask], g


# every width; row counts R of 0, below 64, around the backward's 64-row
# up tiles and LayerNorm blocks and the 128-row tiles of the forward's up
# (ping-pong below about 1,000 rows at D = 512) and of the down and wgrad
# stages, and 4,097 (wgrad split over R into the workspace); masks ragged,
# all off and all on
GLU_SHAPES = [(D, R) for D in (128, 256, 384, 512)
              for R in (0, 1, 37, 63, 64, 65, 127, 128, 129, 4097)]


@pytest.mark.parametrize("mask", ["ragged", "zero", "one"])
@pytest.mark.parametrize("D,R", GLU_SHAPES)
def test_glu_in_kernels(gen, D, R, mask):
    x, do, m, g = _glu_inputs(gen, D, R, mask)
    before = (conv_module.glu_in_forward.launches,
              conv_module.glu_in_backward.launches)
    _close(conv_module.glu_in_forward(x, m, *g),
           conv_module.glu_in_reference(x, m, *g))
    got = conv_module.glu_in_backward(x, m, *g, do)
    assert (conv_module.glu_in_forward.launches,
            conv_module.glu_in_backward.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = conv_module.glu_in_backward_reference(x, m, *g, do)
    # a layer norm's backward multiplies the rows of zero variance by
    # 1/sqrt(eps) = 1000: their dx is held to the relative norm tolerance
    flat = x.float().var(-1, unbiased=False) == 0
    _close(got[0], want[0], ~flat)
    if flat.any():
        _rel(got[0][flat], want[0][flat], "glu_in dx, zero-variance rows")
    for name, a, b in zip("gamma beta w b".split(), got[1:], want[1:]):
        assert a.shape == b.shape, name
        _rel(a, b, "glu_in " + name)
    if mask == "zero" or R == 0:  # no row passes a gradient
        for name, a in zip("x gamma beta w b".split(), got):
            assert not a.any(), name


# the forward's up stage on 128-row tiles (R = 15,776, D = 512) and on
# 64-row ping-pong ones (R = 4,792); the backward's weight gradient split
# over R (summed by the reduce pass) at both, unsplit at R = 37
@pytest.mark.parametrize("D,R", [(512, 15776), (512, 4792), (128, 4097),
                                 (384, 37)])
def test_glu_in_kernels_are_reproducible(gen, D, R):
    x, do, m, g = _glu_inputs(gen, D, R)
    assert torch.equal(conv_module.glu_in_forward(x, m, *g),
                       conv_module.glu_in_forward(x, m, *g))
    first = conv_module.glu_in_backward(x, m, *g, do)
    second = conv_module.glu_in_backward(x, m, *g, do)
    for name, a, b in zip("x gamma beta w b".split(), first, second):
        assert torch.equal(a, b), name


def _bn_inputs(gen, D, R, mask="ragged"):
    """conv, x, dO (1, R, D) bf16 with identical, constant and zero rows
    where R allows; mask (1, R) as `_glu_inputs`; the bn_out parameters
    (mean, var, scale, bias, W (D, D), b)."""
    bf = torch.bfloat16
    c = _special_rows(_rnd(gen, 1, R, D, dtype=bf))
    x = _rnd(gen, 1, R, D, dtype=bf)
    do = _special_rows(_rnd(gen, 1, R, D, dtype=bf))
    m = torch.rand(1, R, generator=gen, device="cuda") > 0.2
    m = {"ragged": m, "zero": torch.zeros_like(m), "one": torch.ones_like(m)}
    b = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
         1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, D, s=D ** -0.5), _rnd(gen, D, s=0.1))
    return c, x, do, m[mask], b


# every width; row counts R of 0, below 64, around the 64-row blocks of
# the backward's prep pass and the 64-row tiles of both directions'
# row-wise products, around the 128-row tiles of wgrad's output, and
# 4,097 (wgrad split over R into the workspace); masks ragged, all off and
# all on; rates 0 and 0.1
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask", ["ragged", "zero", "one"])
@pytest.mark.parametrize("D,R", GLU_SHAPES)
def test_bn_out_kernels(gen, D, R, mask, rate):
    c, x, do, m, b = _bn_inputs(gen, D, R, mask)
    kw = dict(rate=rate, seed=SEED)
    before = (conv_module.bn_out_forward.launches,
              conv_module.bn_out_backward.launches)
    out = conv_module.bn_out_forward(c, x, m, *b, **kw)
    _close(out, conv_module.bn_out_reference(c, x, m, *b, **kw))
    assert torch.equal(out[~m], x[~m])  # masked rows are x itself
    got = conv_module.bn_out_backward(c, x, m, *b, do, **kw)
    assert (conv_module.bn_out_forward.launches,
            conv_module.bn_out_backward.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = conv_module.bn_out_backward_reference(c, x, m, *b, do, **kw)
    _close(got[0], want[0])
    names = "conv mean var scale bias w b".split()
    for name, a, b_ in zip(names[1:], got[1:], want[1:]):
        assert a.shape == b_.shape, name
        _rel(a, b_, "bn_out " + name)
    if mask == "zero" or R == 0:  # no row passes a gradient
        for name, a in zip(names, got):
            assert not a.any(), name


# the training (R = 15,776) and serving (R = 4,792) batches at D = 512;
# the backward's weight gradient split over R (summed by the reduce pass)
# there and at 4,097, unsplit at R = 37; both directions at rate 0.1
@pytest.mark.parametrize("D,R", [(512, 15776), (512, 4792), (128, 4097),
                                 (384, 37)])
def test_bn_out_kernels_are_reproducible(gen, D, R):
    c, x, do, m, b = _bn_inputs(gen, D, R)
    kw = dict(rate=0.1, seed=SEED)
    assert torch.equal(conv_module.bn_out_forward(c, x, m, *b, **kw),
                       conv_module.bn_out_forward(c, x, m, *b, **kw))
    first = conv_module.bn_out_backward(c, x, m, *b, do, **kw)
    second = conv_module.bn_out_backward(c, x, m, *b, do, **kw)
    for name, a, b_ in zip("conv mean var scale bias w b".split(), first,
                           second):
        assert torch.equal(a, b_), name


def _f32_rel(got, want, tol, name):
    """Relative norm within `tol` (chip_smoke.py's [f32] gates)."""
    assert torch.isfinite(got).all(), name
    err = ((got.double() - want.double()).norm()
           / want.double().norm().clamp_min(1e-30)).item()
    assert err <= tol, f"{name}: relative norm {err:.3g} > {tol}"


# rows 14-17 at float32 (csrc/conv_module_f32.cu): D a multiple of 32, 96
# below the bf16 kernels' widths; R of 0, 1, below, at and past the 64-row
# tiles and the column sums' 64-row chunks, and 4,097 (dW over 8 slices)
F32_CONV_SHAPES = [(D, R) for D in (96, 128, 384, 512)
                   for R in (0, 1, 37, 64, 65, 4097)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask", ["ragged", "zero"])
@pytest.mark.parametrize("D,R", F32_CONV_SHAPES)
def test_conv_module_f32_kernels(gen, D, R, mask, rate):
    """The f32 glu_in and bn_out kernels against their plain versions:
    outputs within 1e-5 relative norm (a LayerNorm's output and dx on the
    rows of zero variance 1e-3), sums over rows within 1e-4; two calls bit
    for bit; each dispatcher sends a CUDA f32 tensor to its f32 kernel."""
    x, do, m, g = _glu_inputs(gen, D, R, mask)
    x, do = x.float(), do.float()
    flat = x.var(-1, unbiased=False) == 0
    before = [w.launches for w in (conv_module.glu_in_forward_f32,
                                   conv_module.glu_in_backward_f32,
                                   conv_module.bn_out_forward_f32,
                                   conv_module.bn_out_backward_f32)]
    out = conv_module.glu_in_forward(x, m, *g)
    want = conv_module.glu_in_reference(x, m, *g)
    _f32_rel(out[~flat], want[~flat], 1e-5, "glu_in out")
    _f32_rel(out[flat], want[flat], 1e-3, "glu_in out, zero-variance rows")
    got = conv_module.glu_in_backward(x, m, *g, do)
    want = conv_module.glu_in_backward_reference(x, m, *g, do)
    _f32_rel(got[0][~flat], want[0][~flat], 1e-5, "glu_in dx")
    _f32_rel(got[0][flat], want[0][flat], 1e-3, "glu_in dx, zero-variance")
    for name, a, b in zip("gamma beta w b".split(), got[1:], want[1:]):
        _f32_rel(a, b, 1e-4, "glu_in " + name)
    again = conv_module.glu_in_backward_f32(x, m, *g, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    c, x, do, m, b = _bn_inputs(gen, D, R, mask)
    c, x, do = c.float(), x.float(), do.float()
    kw = dict(rate=rate, seed=SEED)
    out = conv_module.bn_out_forward(c, x, m, *b, **kw)
    _f32_rel(out, conv_module.bn_out_reference(c, x, m, *b, **kw), 1e-5,
             "bn_out out")
    assert torch.equal(out[~m], x[~m])  # masked rows are x itself
    got = conv_module.bn_out_backward(c, x, m, *b, do, **kw)
    want = conv_module.bn_out_backward_reference(c, x, m, *b, do, **kw)
    names = "conv mean var scale bias w b".split()
    for name, a, b_ in zip(names, got, want):
        assert a.shape == b_.shape, name
        _f32_rel(a, b_, 1e-5 if name == "conv" else 1e-4, "bn_out " + name)
    again = conv_module.bn_out_backward_f32(c, x, m, *b, do, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    after = [w.launches for w in (conv_module.glu_in_forward_f32,
                                  conv_module.glu_in_backward_f32,
                                  conv_module.bn_out_forward_f32,
                                  conv_module.bn_out_backward_f32)]
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 2, 1, 2]


# Dh = 64 takes the TMA + wgmma kernel (128-query tiles, 64-key stages):
# T at and around both tile sizes, H = 8 as in every recipe, lengths T and
# 8, 15 (mid-tile)
ATT_SHAPES = [(1, 1, 1, 64), (2, 7, 2, 16), (3, 65, 2, 32), (2, 130, 4, 64),
              (2, 700, 2, 128), (3, 64, 8, 64), (3, 65, 8, 64),
              (3, 128, 8, 64), (3, 129, 8, 64), (3, 599, 8, 64)]


@pytest.mark.parametrize("N,T,H,Dh", ATT_SHAPES)
def test_attention_kernel(gen, N, T, H, Dh):
    bf = torch.bfloat16
    q, k, v = (_rnd(gen, N, T, H, Dh, dtype=bf) for _ in range(3))
    p = _rnd(gen, 2 * T - 1, H, Dh, s=0.5, dtype=bf)
    u, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                      dtype=bf)
    lengths = torch.tensor([T] + [1 + (7 * i) % T for i in range(1, N)],
                           device="cuda")
    got = attention.relpos_attention(q, k, v, p, u, vb, lengths)
    valid = length_mask(lengths, T)
    _close(got, attention.relpos_attention_reference(q, k, v, p, u, vb,
                                                     lengths), valid)
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,T,H,Dh", ATT_SHAPES)
def test_attention_backward_kernel(gen, N, T, H, Dh, rate):
    bf = torch.bfloat16
    q, k, v = (_rnd(gen, N, T, H, Dh, dtype=bf) for _ in range(3))
    p = _rnd(gen, 2 * T - 1, H, Dh, s=0.5, dtype=bf)
    u, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                      dtype=bf)
    lengths = torch.tensor([T] + [1 + (7 * i) % T for i in range(1, N)],
                           device="cuda")
    valid = length_mask(lengths, T)
    do = (_rnd(gen, N, T, H, Dh) * valid[..., None, None]).to(bf)
    args = (q, k, v, p, u, vb, lengths)
    kw = dict(rate=rate, seed=SEED)
    out, lse = attention.relpos_attention_forward(*args, **kw)
    want_out, want_lse = attention.relpos_attention_reference_lse(*args, **kw)
    _close(out, want_out, valid)
    torch.testing.assert_close(lse[valid.unsqueeze(1).expand_as(lse)],
                               want_lse[valid.unsqueeze(1).expand_as(lse)],
                               atol=1e-3, rtol=1e-3)
    got = attention.relpos_attention_backward(*args, out, lse, do, **kw)
    want = attention.relpos_attention_backward_reference(*args, out, lse, do,
                                                         **kw)
    for name, a, b in zip("dq dk dv".split(), got[:3], want[:3]):
        _close(a, b)
    for name, a, b in zip("dp du dv_bias".split(), got[3:], want[3:]):
        _rel(a, b, name)


def _attention_inputs(gen, N, T, H, Dh):
    bf = torch.bfloat16
    q, k, v = (_rnd(gen, N, T, H, Dh, dtype=bf) for _ in range(3))
    p = _rnd(gen, 2 * T - 1, H, Dh, s=0.5, dtype=bf)
    u, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                      dtype=bf)
    lengths = torch.tensor([T] + [1 + (7 * i) % T for i in range(1, N)],
                           device="cuda")
    return q, k, v, p, u, vb, lengths


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [129, 599])
def test_attention_forward_is_reproducible(gen, T, rate):
    """The Dh = 64 forward has no atomics: two calls, the same bits."""
    args = _attention_inputs(gen, 3, T, 8, 64)
    kw = dict(rate=rate, seed=SEED)
    first = attention.relpos_attention_forward(*args, **kw)
    second = attention.relpos_attention_forward(*args, **kw)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_attention_forward_routes(gen):
    """Dh = 64 launches the wgmma kernel, Dh = 32 the wmma one; each
    counts on its own route and on `launches`."""
    fwd = attention.relpos_attention_forward
    for Dh, route in ((64, "wgmma"), (32, "wmma")):
        before, total = dict(fwd.routes), fwd.launches
        fwd(*_attention_inputs(gen, 2, 65, 2, Dh))
        assert fwd.launches == total + 1
        assert fwd.routes == {**before, route: before[route] + 1}


def test_attention_backward_routes(gen):
    """Dh = 64 takes the wgmma route (the dq pass, the reduce and the
    dK/dV pass), 16, 32 and 128 the wmma kernel alone; each call counts
    once on `launches` and on its route."""
    bwd = attention.relpos_attention_backward
    for Dh in (16, 32, 64, 128):
        route = "wgmma" if Dh == 64 else "wmma"
        assert attention.bwd_route(Dh) == route
        args = _attention_inputs(gen, 2, 65, 2, Dh)
        out, lse = attention.relpos_attention_forward(*args)
        do = _rnd(gen, *out.shape, dtype=torch.bfloat16)
        before, total = dict(bwd.routes), bwd.launches
        bwd(*args, out, lse, do)
        assert bwd.launches == total + 1
        assert bwd.routes == {**before, route: before[route] + 1}


def test_dkdv_tile_product(gen):
    """One tile of the Dh = 64 dK/dV pass's products, aᵀ·b through its
    shared-memory layouts and MN-major descriptors, against torch.matmul
    in f32 (the same bf16 products, summed in another order)."""
    a = _rnd(gen, 64, 64, dtype=torch.bfloat16)
    b = _rnd(gen, 64, 64, dtype=torch.bfloat16)
    before = attention.dkdv_tile_product.launches
    got = attention.dkdv_tile_product(a, b)
    assert attention.dkdv_tile_product.launches == before + 1
    torch.testing.assert_close(got, torch.matmul(a.float().T, b.float()),
                               atol=1e-3, rtol=1e-3)


# lengths (N = 3 or 4) with the dK/dV pass's edges: consumer 1 idle (a
# block's first 64 keys hold the last valid one: 40, 64, 130), key blocks
# wholly past the length, a last query tile that straddles the length
# (91, 263, 299) or T
DKDV_LENGTHS = {65: [65, 40, 1], 128: [128, 91, 64, 1],
                129: [129, 128, 65, 3], 300: [300, 263, 130, 40],
                493: [493, 299, 200, 64]}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", sorted(DKDV_LENGTHS))
def test_attention_backward_dkdv(gen, T, rate):
    """dK and dV of the Dh = 64 route against the plain backward; keys
    past the length are zeros."""
    bf, H, Dh = torch.bfloat16, 8, 64
    lengths = torch.tensor(DKDV_LENGTHS[T], device="cuda")
    N = len(lengths)
    q, k, v = (_rnd(gen, N, T, H, Dh, dtype=bf) for _ in range(3))
    p = _rnd(gen, 2 * T - 1, H, Dh, s=0.5, dtype=bf)
    u, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                      dtype=bf)
    valid = length_mask(lengths, T)
    do = (_rnd(gen, N, T, H, Dh) * valid[..., None, None]).to(bf)
    args = (q, k, v, p, u, vb, lengths)
    kw = dict(rate=rate, seed=SEED)
    out, lse = attention.relpos_attention_forward(*args, **kw)
    got = attention.relpos_attention_backward(*args, out, lse, do, **kw)
    want = attention.relpos_attention_backward_reference(*args, out, lse, do,
                                                         **kw)
    for name, a, b in zip(("dk", "dv"), got[1:3], want[1:3]):
        _close(a, b)
        assert (a[~valid] == 0).all(), name


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [129, 599])
def test_attention_backward_is_reproducible(gen, T, rate):
    """The Dh = 64 backward has no atomics: two calls give all six
    outputs bit for bit."""
    args = _attention_inputs(gen, 3, T, 8, 64)
    kw = dict(rate=rate, seed=SEED)
    out, lse = attention.relpos_attention_forward(*args, **kw)
    valid = length_mask(args[-1], T)
    do = (_rnd(gen, 3, T, 8, 64) * valid[..., None, None]).to(torch.bfloat16)
    first = attention.relpos_attention_backward(*args, out, lse, do, **kw)
    second = attention.relpos_attention_backward(*args, out, lse, do, **kw)
    for name, a, b in zip("dq dk dv dp du dv_bias".split(), first, second):
        assert torch.equal(a, b), name


def _special_rows(t):
    """t (N, T, ...) with rows 11..39 of every utterance equal to row 10,
    rows 40..49 constant across their values and rows 50..54 zero."""
    t = t.clone()
    t[:, 11:40] = t[:, 10:11]
    const = t[:, 40:50].reshape(t.shape[0], 10, -1)
    t[:, 40:50] = const[..., :1].expand_as(const).reshape(t[:, 40:50].shape)
    t[:, 50:55] = 0
    return t


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernels_on_identical_constant_and_zero_rows(gen, rate):
    """Rows as SpecAugment's time masks leave them after the subsampling
    (identical), constant rows (zero variance: a layer norm divides by
    sqrt(eps)) and zero rows, in every kernel's inputs, forward and
    backward."""
    bf = torch.bfloat16
    D, F, N, T, H, Dh = 256, 1024, 2, 90, 4, 64
    lengths = torch.tensor([T, 77], device="cuda")
    mask = length_mask(lengths, T)
    x, c, do = (_special_rows(_rnd(gen, N, T, D, dtype=bf)) for _ in range(3))
    kw = dict(rate=rate, seed=SEED)
    ffp = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, F, s=D ** -0.5), _rnd(gen, F, s=0.1),
           _rnd(gen, F, D, s=F ** -0.5), _rnd(gen, D, s=0.1))
    # a layer norm's backward multiplies the rows of zero variance by
    # 1/sqrt(eps) = 1000: their dx is held to the relative norm tolerance
    flat = x.float().var(-1) == 0
    _close(ffn.ff_forward(x, *ffp, **kw), ffn.ff_reference(x, *ffp, **kw))
    got = ffn.ff_backward(x, *ffp, do, **kw)
    want = ffn.ff_backward_reference(x, *ffp, do, **kw)
    _close(got[0], want[0], ~flat)
    _rel(got[0][flat], want[0][flat], "ff dx, zero-variance rows")
    for name, a, b in zip("gamma beta w1 b1 w2 b2".split(), got[1:], want[1:]):
        _rel(a, b, "ff " + name)
    g = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, 2 * D, s=D ** -0.5), _rnd(gen, 2 * D, s=0.1))
    _close(conv_module.glu_in_forward(x, mask, *g),
           conv_module.glu_in_reference(x, mask, *g))
    got = conv_module.glu_in_backward(x, mask, *g, do)
    want = conv_module.glu_in_backward_reference(x, mask, *g, do)
    _close(got[0], want[0], ~flat)
    _rel(got[0][flat], want[0][flat], "glu_in dx, zero-variance rows")
    for name, a, b in zip("gamma beta w b".split(), got[1:], want[1:]):
        _rel(a, b, "glu_in " + name)
    b = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
         1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, D, s=D ** -0.5), _rnd(gen, D, s=0.1))
    _close(conv_module.bn_out_forward(c, x, mask, *b, **kw),
           conv_module.bn_out_reference(c, x, mask, *b, **kw))
    got = conv_module.bn_out_backward(c, x, mask, *b, do, **kw)
    want = conv_module.bn_out_backward_reference(c, x, mask, *b, do, **kw)
    _close(got[0], want[0])
    for name, a, b_ in zip("mean var scale bias w b".split(), got[1:],
                           want[1:]):
        _rel(a, b_, "bn_out " + name)
    q, k, v = (_special_rows(_rnd(gen, N, T, H, Dh, dtype=bf))
               for _ in range(3))
    p = _rnd(gen, 2 * T - 1, H, Dh, s=0.5, dtype=bf)
    u, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                      dtype=bf)
    dao = _special_rows(_rnd(gen, N, T, H, Dh) * mask[..., None, None]).to(bf)
    args = (q, k, v, p, u, vb, lengths)
    out, lse = attention.relpos_attention_forward(*args, **kw)
    want_out, _ = attention.relpos_attention_reference_lse(*args, **kw)
    _close(out, want_out, mask)
    got = attention.relpos_attention_backward(*args, out, lse, dao, **kw)
    want = attention.relpos_attention_backward_reference(*args, out, lse,
                                                         dao, **kw)
    for a, b_ in zip(got[:3], want[:3]):
        _close(a, b_)
    for name, a, b_ in zip("dp du dv_bias".split(), got[3:], want[3:]):
        _rel(a, b_, name)


def test_fused_ops_keep_the_graph_on_the_card(gen):
    """On a CUDA tensor every fused op returns an output with a grad_fn,
    and every input that requires grad receives a gradient."""
    bf = torch.bfloat16
    D, N, T, H = 128, 2, 9, 2
    leaf = lambda *s, s_=1.0, dt=bf: _rnd(gen, *s, s=s_, dtype=dt) \
        .requires_grad_()
    mask = length_mask(torch.tensor([T, 4], device="cuda"), T)
    x = leaf(N, T, D)
    ff = [leaf(D, dt=torch.float32), leaf(D, dt=torch.float32),
          leaf(D, 4 * D, s_=0.1, dt=torch.float32),
          leaf(4 * D, dt=torch.float32),
          leaf(4 * D, D, s_=0.05, dt=torch.float32),
          leaf(D, dt=torch.float32)]
    glu = [leaf(D, dt=torch.float32), leaf(D, dt=torch.float32),
           leaf(D, 2 * D, s_=0.1, dt=torch.float32),
           leaf(2 * D, dt=torch.float32)]
    c = leaf(N, T, D)
    bn = [leaf(D, dt=torch.float32), (1 + _rnd(gen, D).abs()).requires_grad_(),
          leaf(D, dt=torch.float32), leaf(D, dt=torch.float32),
          leaf(D, D, s_=0.1, dt=torch.float32), leaf(D, dt=torch.float32)]
    att = [leaf(N, T, H, 64) for _ in range(3)] + [leaf(2 * T - 1, H, 64),
                                                   leaf(H, 64), leaf(H, 64)]
    lengths = torch.tensor([T, 4], device="cuda")
    outs = [ffn.fused_ff_residual(x, *ff, rate=0.1, seed=SEED),
            conv_module.fused_glu_in(x, mask, *glu),
            conv_module.fused_bn_out(c, x, mask, *bn, rate=0.1, seed=SEED),
            attention.relpos_attention(*att, lengths, rate=0.1, seed=SEED)]
    assert all(o.grad_fn is not None for o in outs)
    before = (ffn.ff_backward.launches, conv_module.glu_in_backward.launches,
              conv_module.bn_out_backward.launches,
              attention.relpos_attention_backward.launches)
    sum(o.float().sum() for o in outs).backward()
    assert (ffn.ff_backward.launches, conv_module.glu_in_backward.launches,
            conv_module.bn_out_backward.launches,
            attention.relpos_attention_backward.launches) == tuple(
                b + 1 for b in before)
    for t in [x, c] + ff + glu + bn + att:
        assert t.grad is not None and torch.isfinite(t.grad).all()


# row 13 f32 (csrc/ffn_f32.cu): D, F multiples of 4 take the 3xTF32 route
# (ragged R past the 128-row tiles and the 32-row stages; R of 0 and 1;
# D below a 32-wide stage), others the CUDA-core tiles
F32_FF_SHAPES = [(16, 64, 37), (16, 64, 0), (256, 1024, 1), (256, 1024, 500),
                 (320, 1280, 300), (512, 2048, 129), (36, 100, 70),
                 (18, 72, 40)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,F,R", F32_FF_SHAPES)
def test_ff_backward_f32_routes(gen, D, F, R, rate):
    """Row 13 f32 against its plain version (outputs 1e-5, sums over rows
    1e-4 relative norm), two calls bit for bit, on the route of
    `f32_bwd_route`."""
    x, do = _rnd(gen, R, D), _rnd(gen, R, D)
    p = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, F, s=D ** -0.5), _rnd(gen, F, s=0.1),
         _rnd(gen, F, D, s=F ** -0.5), _rnd(gen, D, s=0.1))
    kw = dict(rate=rate, seed=SEED)
    route = ffn.f32_bwd_route(D, F)
    before = ffn.ff_backward_f32.routes[route]
    got = ffn.ff_backward(x, *p, do, **kw)
    assert ffn.ff_backward_f32.routes[route] == before + 1
    want = ffn.ff_backward_reference(x, *p, do, **kw)
    for name, a, b in zip("dx gamma beta w1 b1 w2 b2".split(), got, want):
        if R == 0:
            assert not a.any(), name
        else:
            _f32_rel(a, b, 1e-5 if name == "dx" else 1e-4, name)
    again = ffn.ff_backward(x, *p, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rows,cols", [(46, 46), (46, 48), (512, 512),
                                       (3, 5), (1, 1), (17, 36)])
def test_dropout_mask_is_dropout_scale(gen, rows, cols):
    for stream in (0, 1):
        before = dropout.dropout_mask.launches
        got = dropout.dropout_mask(SEED, stream, rows, cols, 0.1, "cuda")
        assert dropout.dropout_mask.launches == before + 1
        assert torch.equal(got, dropout.dropout_scale(SEED, stream, 1, rows,
                                                      cols, 0.1, "cuda"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_kernel_off_the_16_byte_route(gen, dtype):
    """Tensors that are not 16-byte aligned, and rows of a multiple of 4
    values but of an odd number of Philox groups, give the same bits."""
    x = _rnd(gen, 4 * 64 + 1, dtype=dtype)[1:].view(4, 64)
    assert torch.equal(dropout.dropout_apply(x, 0.1, SEED),
                       dropout.dropout_reference(x, 0.1, SEED))
    y = _rnd(gen, 3, 5, 4, dtype=dtype)
    assert torch.equal(dropout.dropout_apply(y, 0.3, SEED),
                       dropout.dropout_reference(y, 0.3, SEED))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("C", [512, 510])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_kernel_is_bit_exact(gen, rate, C, dtype):
    x = _rnd(gen, 3, 37, C, dtype=dtype).requires_grad_()
    before = dropout.dropout_apply.launches
    y = dropout.dropout(x, rate, SEED)
    assert torch.equal(y, dropout.dropout_reference(x.detach(), rate, SEED))
    g = _rnd(gen, 3, 37, C, dtype=dtype)
    y.backward(g)
    assert torch.equal(x.grad, dropout.dropout_reference(g, rate, SEED))
    assert dropout.dropout_apply.launches == before + (2 if rate else 0)


def _lattice(gen, S, T, N):
    """A CTC case of S lattice states over V = 72 (S = 2U + 1, or for an
    even S the lattice of S // 2 label slots, its last state padding):
    labels with repeats, U_n falling from U to 0 and, for N > 1, an
    utterance of one frame; em, allow2, allow2_dst, beta_last as `_CTCNll`
    builds them."""
    U = (S - 1) // 2
    lp = torch.log_softmax(_rnd(gen, N, T, 72, s=2.0), -1)
    labels = torch.randint(1, 72, (N, S // 2), generator=gen, device="cuda")
    labels[:, 1:U:5] = labels[:, 0:U - 1:5]
    llens = torch.tensor([U - (U * i) // N for i in range(N)], device="cuda")
    ilens = torch.tensor([max(1, T - 3 * i) for i in range(N)],
                         device="cuda")
    if N > 1:
        llens[-1], ilens[1] = 0, 1
    labels *= torch.arange(S // 2, device="cuda")[None, :] < llens[:, None]
    ext, svalid, allow2 = ctc._lattice_tables(labels, llens, 0, S)
    em = ctc._emissions(lp, ext, svalid, ilens, 0)
    return (em, allow2, *ctc._beta_tables(allow2, llens))


def _states_close(got, want, atol=1e-3, rtol=2e-6):
    live = want > ctc.LOG_EPS / 2
    assert (got[~live] <= ctc.LOG_EPS / 2).all()
    assert ((got - want).abs() <= atol + rtol * want.abs())[live].all(), \
        (got - want).abs()[live].max().item()


@pytest.mark.parametrize("S,T,N", [(3, 1, 1), (5, 23, 3), (31, 17, 3),
                                   (32, 17, 3), (33, 17, 3), (64, 17, 3),
                                   (65, 17, 3), (247, 493, 32),
                                   (256, 40, 3), (257, 40, 3),
                                   (1023, 40, 3), (1025, 40, 3),
                                   (6001, 12, 2)])
def test_ctc_kernels(gen, S, T, N):
    """Both routes of `ctc.ctc_plan` (lanes up to S = 1024, frames above)
    against the plain versions, one launch each, two calls bit for bit."""
    em, allow2, allow2_dst, beta_last = _lattice(gen, S, T, N)
    assert ctc.ctc_plan(S).route == ("lanes" if S <= 1024 else "frames")
    before = (ctc.forward_alphas.launches, ctc.backward_betas.launches)
    alphas = ctc.forward_alphas(em, allow2)
    betas = ctc.backward_betas(em, allow2_dst, beta_last)
    assert (ctc.forward_alphas.launches, ctc.backward_betas.launches) == (
        before[0] + 1, before[1] + 1)
    _states_close(alphas, ctc.forward_alphas_reference(em, allow2))
    _states_close(betas,
                  ctc.backward_betas_reference(em, allow2_dst, beta_last))
    assert torch.equal(ctc.forward_alphas(em, allow2), alphas)
    assert torch.equal(ctc.backward_betas(em, allow2_dst, beta_last), betas)


def _den(V, order):
    rng = np.random.default_rng(order)
    seqs = [list(map(int, rng.integers(1, V, size=int(rng.integers(3, 30)))))
            for _ in range(200)]
    return crf_dense.DenseDen.from_ngram(train_ngram(seqs, order=order), V)


def _den_inputs(gen, V, T, N):
    lp = torch.log_softmax(_rnd(gen, N, T, V, s=2.0), -1).contiguous()
    lens = torch.tensor([T] + [max(1, T - 7 * i) for i in range(1, N)],
                        device="cuda")
    if N > 2:
        lens[-1] = 1
    return lp, lens


# V = 96 (MAX_V) reads the expW slices from L2, V = 72 and 9 keep them in
# shared memory; N = 40 puts more utterances in a cluster than 32 does
# (ragged, lengths down to 1)
@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("V,T,N", [(9, 1, 1), (9, 23, 3), (9, 24, 2),
                                   (9, 25, 3), (72, 25, 1), (72, 493, 32),
                                   (72, 60, 40), (96, 50, 5)])
def test_den_kernels(gen, order, V, T, N):
    den = _den(V, order)
    lp, lens = _den_inputs(gen, V, T, N)
    before = (crf_dense.den_forward.launches, crf_dense.den_backward.launches)
    (s_in, s_bl), logz = crf_dense.den_forward(lp, lens, den)
    (r_in, r_bl), r_logz = crf_dense.den_forward_reference(lp, lens, den)
    torch.testing.assert_close(logz, r_logz, rtol=1e-5, atol=0)
    for got, want in ((s_in, r_in), (s_bl, r_bl)):
        _states_close(got, want, atol=0.0, rtol=1e-5)
    g = _rnd(gen, N)
    got = crf_dense.den_backward(lp, lens, (s_in, s_bl), logz, g, den)
    want = crf_dense.den_backward_reference(lp, lens, (r_in, r_bl), r_logz,
                                            g, den)
    assert ((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all(), \
        (got - want).abs().max().item()
    assert (crf_dense.den_forward.launches,
            crf_dense.den_backward.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("V,T,N", [(9, 25, 3), (72, 493, 32), (72, 60, 40),
                                   (96, 50, 5)])
def test_den_kernels_are_reproducible(gen, V, T, N):
    """Two calls of each den kernel on the same inputs give the same bits:
    every sum runs in a fixed order and nothing goes through atomics."""
    den = _den(V, 3)
    lp, lens = _den_inputs(gen, V, T, N)
    (a_in, a_bl), a_z = crf_dense.den_forward(lp, lens, den)
    (b_in, b_bl), b_z = crf_dense.den_forward(lp, lens, den)
    assert torch.equal(a_in, b_in) and torch.equal(a_bl, b_bl)
    assert torch.equal(a_z, b_z)
    g = _rnd(gen, N)
    assert torch.equal(
        crf_dense.den_backward(lp, lens, (a_in, a_bl), a_z, g, den),
        crf_dense.den_backward(lp, lens, (a_in, a_bl), a_z, g, den))


def test_loss_functions_keep_the_graph_on_the_card(gen):
    """ctc_crf_loss_dense on a CUDA tensor goes through all four loss
    kernels, and its gradient matches the CPU's plain path."""
    V, N, T = 9, 3, 30
    den = _den(V, 3)
    lp = torch.log_softmax(_rnd(gen, N, T, V, s=2.0), -1)
    labels = torch.randint(1, V, (N, 5), generator=gen, device="cuda")
    lens = torch.tensor([30, 21, 9], device="cuda")
    llens = torch.tensor([5, 3, 2], device="cuda")
    ks = (ctc.forward_alphas, ctc.backward_betas, crf_dense.den_forward,
          crf_dense.den_backward)
    before = [k.launches for k in ks]
    x = lp.clone().requires_grad_()
    crf_dense.ctc_crf_loss_dense(x, labels, lens, llens, den).backward()
    assert [k.launches for k in ks] == [b + 1 for b in before]
    xc = lp.cpu().requires_grad_()
    crf_dense.ctc_crf_loss_dense(xc, labels.cpu(), lens.cpu(), llens.cpu(),
                                 den).backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, atol=1e-4, rtol=1e-4)


def _rnnt_tables(gen, U1, T, N, V=9):
    """RNN-T tables (`_row_tables`) of U = U1 - 1 labels over V: label
    lengths falling from U to 0 and input lengths from T; for N > 1 the
    last utterance has no label and the second one frame."""
    U = U1 - 1
    lp = torch.log_softmax(_rnd(gen, N, T, U1, V, s=2.0), -1)
    labels = torch.randint(1, V, (N, U), generator=gen, device="cuda")
    llens = torch.tensor([U - (U * i) // N for i in range(N)], device="cuda")
    ilens = torch.tensor([max(1, T - 3 * i) for i in range(N)],
                         device="cuda")
    if N > 1:
        llens[-1], ilens[1] = 0, 1
    labels *= torch.arange(U, device="cuda")[None, :] < llens[:, None]
    return rnnt._row_tables(lp, labels, ilens, llens, 0), llens


@pytest.mark.parametrize("N", [1, 3, 32])
@pytest.mark.parametrize("T", [1, 24, 493])
@pytest.mark.parametrize("U1", [1, 2, 31, 32, 33, 64, 65, 83, 96, 97, 256,
                                257, 1500])
def test_rnnt_kernels(gen, U1, T, N):
    """Both routes of `rnnt_plan` (wavefront up to U+1 = 1024, in its
    instantiations for up to 8 and up to 32 warps; row scan above) against the plain versions, one launch a call, and two calls
    bit for bit."""
    (be, le, _, _), llens = _rnnt_tables(gen, U1, T, N)
    term = rnnt.beta_term(llens, U1)
    assert rnnt.rnnt_plan(U1).route == ("wavefront" if U1 <= 1024
                                        else "rowscan")
    before = (rnnt.forward_alphas.launches, rnnt.backward_betas.launches)
    alphas = rnnt.forward_alphas(be, le)
    betas = rnnt.backward_betas(be, le, term)
    assert (rnnt.forward_alphas.launches, rnnt.backward_betas.launches) == (
        before[0] + 1, before[1] + 1)
    _states_close(alphas, rnnt.forward_alphas_reference(be, le))
    _states_close(betas, rnnt.backward_betas_reference(be, le, term))
    assert torch.equal(rnnt.forward_alphas(be, le), alphas)
    assert torch.equal(rnnt.backward_betas(be, le, term), betas)


@pytest.mark.parametrize("lattice", ["rnnt", "ctc"])
def test_chain_floor(gen, lattice):
    """The measurement kernel of a recursion's bound runs and keeps finite
    states."""
    out = torch.full((32, 32), float("nan"), device="cuda")
    {"rnnt": rnnt, "ctc": ctc}[lattice].chain_floor(out, 575)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


def test_rnnt_losses_keep_the_graph_on_the_card(gen):
    """rnnt_loss and rnnt_loss_simple on CUDA tensors go through both
    kernels, and their gradients match the CPU's plain path."""
    N, T, U, V = 3, 20, 6, 11
    labels = torch.randint(1, V, (N, U), generator=gen, device="cuda")
    lens = torch.tensor([20, 13, 1], device="cuda")
    llens = torch.tensor([6, 2, 0], device="cuda")
    ks = (rnnt.forward_alphas, rnnt.backward_betas)
    lp = torch.log_softmax(_rnd(gen, N, T, U + 1, V, s=2.0), -1)
    f, g = _rnd(gen, N, T, V, s=2.0), _rnd(gen, N, U + 1, V, s=2.0)
    for fn, args in ((rnnt.rnnt_loss, (lp,)),
                     (rnnt_simple.rnnt_loss_simple, (f, g))):
        before = [k.launches for k in ks]
        xs = [a.clone().requires_grad_() for a in args]
        fn(*xs, labels, lens, llens, reduction="sum").backward()
        assert [k.launches for k in ks] == [b + 1 for b in before]
        xc = [a.cpu().requires_grad_() for a in args]
        fn(*xc, labels.cpu(), lens.cpu(), llens.cpu(),
           reduction="sum").backward()
        for a, b in zip(xs, xc):
            torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4,
                                       rtol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x32 = _rnd(gen, 2, 3, 256)
    p = (torch.ones(256, device="cuda"), torch.zeros(256, device="cuda"),
         _rnd(gen, 256, 512), torch.zeros(512, device="cuda"),
         _rnd(gen, 512, 256), torch.zeros(256, device="cuda"))
    with pytest.raises(ValueError, match="bfloat16"):
        ffn.fused_ff_residual(x32, *p)
    x192 = _rnd(gen, 2, 3, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):
        conv_module.fused_glu_in(x192, torch.ones(2, 3, dtype=torch.bool,
                                                  device="cuda"),
                                 torch.ones(192, device="cuda"),
                                 torch.zeros(192, device="cuda"),
                                 _rnd(gen, 192, 384),
                                 torch.zeros(384, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        dropout.dropout_apply(_rnd(gen, 4, 6).t(), 0.1, SEED)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        dropout.dropout_apply(_rnd(gen, 4, 6, dtype=torch.float16), 0.1, SEED)
    em = _rnd(gen, 5, 2, 7)
    allow2 = torch.zeros(2, 7, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="f32"):
        ctc.forward_alphas(em.double(), allow2)
    with pytest.raises(ValueError, match="bool"):
        ctc.forward_alphas(em, allow2.float())
    with pytest.raises(ValueError, match="f32"):
        ctc.backward_betas(em, allow2, _rnd(gen, 2, 6))
    den = _den(9, 2)
    lp = _rnd(gen, 2, 5, 9)
    lens = torch.tensor([5, 3], device="cuda")
    with pytest.raises(ValueError, match="int64"):
        crf_dense.den_forward(lp, lens.int(), den)
    with pytest.raises(ValueError, match="contiguous"):
        crf_dense.den_forward(lp.transpose(0, 1), lens, den)
    with pytest.raises(ValueError, match="V = 8"):
        crf_dense.den_forward(lp[..., :8].contiguous(), lens, den)
    be, le = _rnd(gen, 5, 2, 7), _rnd(gen, 5, 2, 7)
    term = _rnd(gen, 2, 7)
    with pytest.raises(ValueError, match="contiguous"):
        rnnt.forward_alphas(be.transpose(0, 1), le.transpose(0, 1))
    with pytest.raises(ValueError, match="f32"):
        rnnt.forward_alphas(be.double(), le)
    with pytest.raises(ValueError, match="one CUDA device"):
        rnnt.forward_alphas(be, le.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        rnnt.backward_betas(be, le, term.cpu())
    with pytest.raises(ValueError, match="f32"):
        rnnt.backward_betas(be, le, term[:, :6].contiguous())
    big = torch.zeros(1, 1, rnnt.MAX_U1 + 1, device="cuda")
    with pytest.raises(ValueError, match="U\\+1 <="):
        rnnt.forward_alphas(big, big)
    # the C entries refuse any plan but `rnnt_plan`'s
    out = torch.empty_like(be)
    for plan in (rnnt.RnntPlan("rowscan", 0), rnnt.RnntPlan("wavefront", 2)):
        with pytest.raises(RuntimeError, match="rnnt_alpha"):
            rnnt._launch("rnnt_alpha", (be.data_ptr(), le.data_ptr(),
                                        out.data_ptr()), be.shape, plan,
                         be.device)
        with pytest.raises(RuntimeError, match="rnnt_beta"):
            rnnt._launch("rnnt_beta", (be.data_ptr(), le.data_ptr(),
                                       term.data_ptr(), out.data_ptr()),
                         be.shape, plan, be.device)


def test_conformer_forward_matches_plain_on_the_card(gen, monkeypatch):
    """A bf16 and a float32 (the default dtype, every fused op on its f32
    route) 2-cell conformer against their forwards on the plain versions:
    bf16 within 0.1, float32 within 1e-4 relative norm."""
    kw = dict(num_cells=2, hdim=256, num_heads=4, kernel_size=15,
              dropout_rate=0.0)
    cfg = {"encoder": {"type": "ConformerNet",
                       "kwargs": dict(kw, dtype="bfloat16")}}
    model = build_model(cfg, num_classes=11, device="cuda", seed=3)
    f32 = build_model({"encoder": {"type": "ConformerNet", "kwargs": kw}},
                      num_classes=11, device="cuda", seed=3)
    x = _rnd(gen, 3, 130, 80)
    lengths = torch.tensor([130, 97, 40], device="cuda")
    with torch.inference_mode():
        got, got_len = model(x, lengths)
        got32, _ = f32(x, lengths)
        for mod, name, fn in (
                (ffn, "fused_ff_residual", ffn.ff_reference),
                (conv_module, "fused_glu_in", conv_module.glu_in_reference),
                (conv_module, "fused_bn_out", conv_module.bn_out_reference),
                (attention, "relpos_attention",
                 attention.relpos_attention_reference)):
            monkeypatch.setattr(mod, name, fn)
        want, want_len = model(x, lengths)
        want32, _ = f32(x, lengths)
    assert torch.equal(got_len, want_len)
    valid = length_mask(got_len, got.shape[1])
    assert (got - want).abs()[valid].max().item() <= 0.1
    _f32_rel(got32[valid], want32[valid], 1e-4, "float32 logits")


def test_manager_checkpoint_round_trip_on_the_card(gen, tmp_path):
    """A toy Manager run on the card (2-cell bf16 conformer, dropout 0.1,
    CTC on its kernels, fold 2, check_freq 3): the step-3 checkpoint,
    taken mid-fold, loads into a fresh Manager (model from another seed)
    with every tensor bit for bit equal to the run's at the moment of
    saving: parameters, running statistics, Adam moments and steps, the
    fold's sums, weight and count."""
    from cat_tpu_torch.ctc.train import (init_state, make_eval_step,
                                         make_train_step)
    from cat_tpu_torch.utils.checkpoint import CheckpointManager
    from cat_tpu_torch.utils.data import (BucketedLoader, SpeechDataset,
                                          pack_speech_data)
    from cat_tpu_torch.utils.manager import Manager
    from cat_tpu_torch.utils.scheduler import build_scheduler

    rng = np.random.default_rng(0)
    utts = []
    for i in range(16):
        T = int(rng.integers(60, 200))
        utts.append((f"u{i}", rng.standard_normal((T, 80), np.float32),
                     [int(c) for c in rng.integers(1, 11, T // 16)]))
    split = pack_speech_data(str(tmp_path / "train"), utts)
    cfg = {"encoder": {"type": "ConformerNet", "kwargs": dict(
        num_cells=2, hdim=256, num_heads=4, kernel_size=15,
        dropout_rate=0.1, dtype="bfloat16")}}
    sched_cfg = {"type": "SchedulerNoam", "kwargs": {"dim_model": 256,
                                                     "warmup_step": 10},
                 "optimizer": {"type": "Adam", "kwargs": {}}}

    def manager(seed, name):
        model = build_model(cfg, num_classes=11, device="cuda", seed=seed)
        sched, opt = build_scheduler(sched_cfg, model.parameters())
        loader = BucketedLoader(SpeechDataset(split), frame_budget=600,
                                num_buckets=2)
        return Manager(make_train_step(model, opt, "ctc",
                                       grad_accum_fold=2),
                       make_eval_step(model, "ctc"),
                       init_state(model, opt), sched,
                       CheckpointManager(str(tmp_path / name)), loader,
                       loader, max_epochs=1, check_freq=3, verbose=False,
                       grad_accum_fold=2)

    def flat(sd, prefix=""):
        out = {}
        for k, v in sd.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            elif isinstance(v, torch.Tensor):
                out[prefix + k] = v.detach().to("cpu", copy=True)
            else:
                out[prefix + k] = v
        return out

    a = manager(0, "a")
    saved = {}
    save = a.save

    def save_and_note(metric):
        name = save(metric)
        if a.global_step == 3:
            saved.update(path=a.ckpt.path(name),
                         state=flat(a.state.state_dict()))
        return name

    a.save = save_and_note
    a.run()
    assert a.global_step >= 4 and saved["state"]["fold/count"] == 1
    assert saved["state"]["model/cells.0.conv.running_mean"].device.type \
        == "cpu"
    b = manager(1, "b")
    b.resume(saved["path"])
    got = flat(b.state.state_dict())
    assert sorted(got) == sorted(saved["state"])
    for k, want in saved["state"].items():
        if isinstance(want, torch.Tensor):
            assert got[k].dtype == want.dtype and torch.equal(got[k], want), k
        else:
            assert got[k] == want, k
    assert next(b.state.model.parameters()).is_cuda
    assert b.state.fold_sums[0].is_cuda and b.global_step == 3


def _power_ok(log_mel, wav, sr, bins):
    """The f32 log-mel `log_mel` (T, bins) against a float64 numpy witness
    of `fbank.log_fbank`: in the bins within 16 nats of their frame's
    largest, returned for the caller's tolerance; in the others, the mel
    power within 1e-9 of the frame's largest (tests/test_torch_fbank.py)."""
    from cat_tpu_torch.ops import fbank
    n, hop = int(sr * 0.025), int(sr * 0.010)
    x = np.asarray(wav, np.float64)
    T = 1 + (len(x) - n) // hop
    fr = x[np.arange(T)[:, None] * hop + np.arange(n)[None, :]]
    fr = fr - fr.mean(-1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[:, :1], fr[:, :-1]], -1)
    fr = fr * fbank.povey_window(n).astype(np.float64)
    mel = (np.abs(np.fft.rfft(fr, n=512, axis=-1)) ** 2) @ \
        fbank.mel_filterbank(bins, 512, sr).astype(np.float64)
    exact = np.log(np.maximum(mel, 1e-10))
    top = exact.max(-1, keepdims=True)
    res = exact >= top - 16.0
    err = np.abs(np.exp(log_mel.astype(np.float64)) - np.exp(exact)) \
        / np.exp(top)
    assert np.where(res, 0.0, err).max() <= 1e-9
    return res


@pytest.mark.parametrize("sr,bins", [(8000, 40), (16000, 80)])
def test_log_fbank_on_the_card_matches_the_cpu(gen, sr, bins):
    """cuFFT's log-mel and CMVN against the CPU's: |Δ| <= 1e-3 +
    1e-4·|x| in the resolved bins, the power bound in the others; two
    calls on the card bit for bit."""
    from cat_tpu_torch.ops import fbank
    rng = np.random.default_rng(sr + bins)
    L = int(1.3 * sr)
    t = np.arange(L) / sr
    w = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1870 * t)
         + 0.01 * rng.standard_normal(L)).astype(np.float32)
    w[: L // 4] = 0.0
    kw = dict(num_bins=bins, sample_rate=sr, frame_length=int(sr * 0.025),
              frame_shift=int(sr * 0.010), fft_size=512)
    x = torch.from_numpy(w[None])
    card = fbank.log_fbank(x.cuda(), **kw)
    assert torch.equal(card, fbank.log_fbank(x.cuda(), **kw))
    cpu = fbank.log_fbank(x, **kw)[0].numpy()
    got = card[0].cpu().numpy()
    res = _power_ok(got, w, sr, bins)
    assert (np.abs(got - cpu) <= 1e-3 + 1e-4 * np.abs(cpu))[res].all()
    for norm_var in (False, True):
        c = fbank.cmvn(card, torch.tensor([got.shape[0]], device="cuda"),
                       norm_var=norm_var)[0].cpu().numpy()
        p = fbank.cmvn(torch.from_numpy(cpu[None]),
                       norm_var=norm_var)[0].numpy()
        assert (np.abs(c - p) <= 1e-3 + 1e-4 * np.abs(p))[res].all()


@pytest.mark.parametrize("W", [4, 17])
def test_device_beam_on_the_card_matches_the_cpu(gen, W):
    """The batched prefix beam on the card against the same function on
    the CPU: prefixes of the lanes live on the CPU identical, scores within
    1e-4 + 1e-5·|s|; two calls on the card bit for bit."""
    from cat_tpu_torch.ctc.decode_device import ctc_beam_search_device
    from cat_tpu_torch.ops.semiring import LOG_EPS
    lp = torch.log_softmax(_rnd(gen, 6, 120, 72, s=3.0), -1)
    lp[2, 10:40] = -float(np.log(72))  # tied rows
    lens = torch.tensor([120, 97, 60, 1, 33, 120], device="cuda")
    kw = dict(beam_width=W, topk=8, max_len=64, beta=0.5)
    out = ctc_beam_search_device(lp, lens, **kw)
    again = ctc_beam_search_device(lp, lens, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    cpu = ctc_beam_search_device(lp.cpu(), lens.cpu(), **kw)
    pref, plen, score = (t.cpu() for t in out)
    live = cpu[2] > LOG_EPS / 2
    assert torch.equal(score > LOG_EPS / 2, live)
    for n, k in live.nonzero().tolist():
        assert plen[n, k] == cpu[1][n, k]
        assert torch.equal(pref[n, k, :plen[n, k]], cpu[0][n, k, :plen[n, k]])
    assert ((score[live] - cpu[2][live]).abs()
            <= 1e-4 + 1e-5 * cpu[2][live].abs()).all()
