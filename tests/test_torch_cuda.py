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
order, partly by atomics.
"""
import pytest
import torch

from cat_tpu_torch.ctc.train import build_model
from cat_tpu_torch.models.layers import length_mask
from cat_tpu_torch.ops import attention, conv_module, ffn
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


@pytest.mark.parametrize("D,F,N,T", [(128, 512, 1, 1), (256, 1024, 3, 11),
                                     (384, 1536, 2, 33), (512, 2048, 2, 50)])
def test_ffn_kernel(gen, D, F, N, T):
    x = _rnd(gen, N, T, D, dtype=torch.bfloat16)
    p = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, F, s=D ** -0.5), _rnd(gen, F, s=0.1),
         _rnd(gen, F, D, s=F ** -0.5), _rnd(gen, D, s=0.1))
    before = ffn.ff_forward.launches
    got = ffn.fused_ff_residual(x, *p, alpha=1.0)
    assert ffn.ff_forward.launches == before + 1
    _close(got, ffn.ff_reference(x, *p, alpha=1.0))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,F,N,T", [(128, 512, 1, 1), (256, 1024, 3, 11),
                                     (384, 1536, 2, 33), (512, 2048, 2, 50)])
def test_ffn_backward_kernel(gen, D, F, N, T, rate):
    x = _rnd(gen, N, T, D, dtype=torch.bfloat16)
    do = _rnd(gen, N, T, D, dtype=torch.bfloat16)
    p = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, F, s=D ** -0.5), _rnd(gen, F, s=0.1),
         _rnd(gen, F, D, s=F ** -0.5), _rnd(gen, D, s=0.1))
    kw = dict(alpha=0.5, rate=rate, seed=SEED)
    _close(ffn.ff_forward(x, *p, **kw), ffn.ff_reference(x, *p, **kw))
    before = ffn.ff_backward.launches
    got = ffn.ff_backward(x, *p, do, **kw)
    assert ffn.ff_backward.launches == before + 1
    want = ffn.ff_backward_reference(x, *p, do, **kw)
    _close(got[0], want[0])
    for name, a, b in zip("gamma beta w1 b1 w2 b2".split(), got[1:], want[1:]):
        _rel(a, b, name)


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


@pytest.mark.parametrize("N,T,H,Dh", [(1, 1, 1, 64), (2, 7, 2, 16),
                                      (3, 65, 2, 32), (2, 130, 4, 64),
                                      (2, 700, 2, 128)])
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
@pytest.mark.parametrize("N,T,H,Dh", [(1, 1, 1, 64), (2, 7, 2, 16),
                                      (3, 65, 2, 32), (2, 130, 4, 64),
                                      (2, 700, 2, 128)])
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


def test_conformer_forward_matches_plain_on_the_card(gen, monkeypatch):
    kw = dict(num_cells=2, hdim=256, num_heads=4, kernel_size=15,
              dropout_rate=0.0)
    cfg = {"encoder": {"type": "ConformerNet",
                       "kwargs": dict(kw, dtype="bfloat16")}}
    model = build_model(cfg, num_classes=11, device="cuda", seed=3)
    x = _rnd(gen, 3, 130, 80)
    lengths = torch.tensor([130, 97, 40], device="cuda")
    with torch.inference_mode():
        got, got_len = model(x, lengths)
        for mod, name, fn in (
                (ffn, "fused_ff_residual", ffn.ff_reference),
                (conv_module, "fused_glu_in", conv_module.glu_in_reference),
                (conv_module, "fused_bn_out", conv_module.bn_out_reference),
                (attention, "relpos_attention",
                 attention.relpos_attention_reference)):
            monkeypatch.setattr(mod, name, fn)
        want, want_len = model(x, lengths)
    assert torch.equal(got_len, want_len)
    valid = length_mask(got_len, got.shape[1])
    assert (got - want).abs()[valid].max().item() <= 0.1
    f32 = build_model({"encoder": {"type": "ConformerNet", "kwargs": kw}},
                      num_classes=11, device="cuda")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        f32(x, lengths)
