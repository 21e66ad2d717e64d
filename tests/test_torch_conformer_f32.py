"""Port parity: `ConformerNet` at its default float32 with batch
normalisation, the conv module's dispatch, the f32 conv-module route's
wrappers and plan, and the float32 convolutions' cuDNN flags, on the CPU
against `cat_tpu` (weights carried across by `utils.from_jax`, JAX's init
perturbed by 0.05, its running statistics drawn away from 0 and 1).

- A JAX ConformerNet (2 cells, D = 128, 2 heads, kernel 3, dtype left at
  float32, dropout 0) with `CAT_TPU_FUSED_CONV_MOD=interpret`, so that its
  conv modules reach the Pallas stages of rows 14-17 in interpret mode,
  against the port's model: eval logits, training logits and updated
  running statistics within 1e-5 + 1e-4·|x|; the gradient of a fixed
  random projection of the training logits with respect to every
  parameter within 1e-4 relative norm (the depthwise conv's bias, whose
  exact gradient under batch normalisation is 0, and the key bias, 0
  under the softmax, within 1e-5 absolute on both sides: float32 noise).
- `ConvModule` at D = 144 with batch normalisation against JAX's unfused
  path (JAX fuses only at D % 128 == 0), eval and training (its running
  statistics' update too): output and input gradient within 1e-5 +
  1e-4·|x|, and no fused-stage wrapper called.
- Dispatch: a float32 CPU tensor takes the plain versions and counts no
  launch; the f32 wrappers raise on CPU and meta tensors, naming "float32
  CUDA"; the bf16 kernels still refuse float32.
- The f32 backward kernels' dW: R split into `wgrad_splits(R)` slices of
  a multiple of 16 rows, a partial product each, summed in slice order
  (`csrc/f32_tiles.cuh` `gemm_split_k`); db and the other column sums in
  64-row chunks summed in chunk order (`colsum`): emulated in PyTorch
  against the plain backward within 1e-5 relative norm (float32 sums of
  up to 9,000 rows in two orders; elementwise, a cancelling sum's small
  element differs by more).
- The float32 convolutions (the conv2d subsampling and the conv module's
  depthwise conv at float32, VGG2L's, the TDNN layers') run forward and
  backward under cuDNN's flags with `allow_tf32=False`; at bfloat16 the
  subsampling and the depthwise conv do not enter them.
"""
import contextlib
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.models import encoders as jax_encoders
from cat_tpu.models import layers as jax_layers
from cat_tpu_torch.models import get_encoder
from cat_tpu_torch.models import layers
from cat_tpu_torch.models.layers import ConvModule, length_mask
from cat_tpu_torch.ops import conv_module
from cat_tpu_torch.ops.ffn import wgrad_splits
from cat_tpu_torch.utils.from_jax import (conformer_state_dict,
                                          conv_module_state_dict)
from tests.test_torch_transducer import _perturbed

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
SUM_RTOL = 1e-5  # the f32 kernels' blocked sums against the plain ones
NOISE = 1e-5  # gradients whose exact value is 0: float32 noise
NOISE_GRADS = ("conv.depthwise.bias", "mhsa.k.bias")
KW = dict(num_cells=2, hdim=128, num_heads=2, kernel_size=3, num_classes=11,
          dropout_rate=0.0, idim=24)
LENGTHS = np.array([41, 30, 17], np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, LENGTHS.max(), KW["idim"])).astype(np.float32)
    return x * (np.arange(LENGTHS.max())[None, :, None]
                < LENGTHS[:, None, None])


def _stats(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.3 * np.abs(rng.standard_normal(a.shape))
                   ).astype(np.float32), tree)


@pytest.fixture(scope="module")
def fused_pair():
    """(JAX ConformerNet reaching the Pallas conv-module stages in
    interpret mode, its perturbed variables, the port's model)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CAT_TPU_FUSED_CONV_MOD", "interpret")
    mp.setenv("CAT_TPU_PARTITIONED", "0")
    jkw = {k: v for k, v in KW.items() if k != "idim"}
    jm = jax_encoders.ConformerNet(**jkw)
    x = _feats()
    v = jax.jit(partial(jm.init, deterministic=True))(
        jax.random.PRNGKey(0), x, LENGTHS)
    params, stats = _perturbed(v["params"], 1), _stats(v["batch_stats"], 2)
    model = get_encoder("ConformerNet")(**KW)
    model.load_state_dict(conformer_state_dict(params, stats))
    yield jm, params, stats, model
    mp.undo()


def test_float32_conformer_defaults_to_float32_and_fuses(fused_pair):
    _, _, _, model = fused_pair
    assert model.dtype == torch.float32
    assert all(c.conv.fused and c.ff1.fused for c in model.cells)


def test_float32_conformer_eval_matches_jax(fused_pair):
    jm, params, stats, model = fused_pair
    x = _feats()
    want, want_len = jax.jit(partial(jm.apply, deterministic=True))(
        {"params": params, "batch_stats": stats}, x, LENGTHS)
    model.eval()
    with torch.inference_mode():
        got, got_len = model(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_float32_conformer_training_matches_jax(fused_pair):
    """Training mode: the logits, the updated running statistics and the
    gradient of a scalar objective, with the masked batch statistics."""
    jm, params, stats, model = fused_pair
    x = _feats()
    proj = np.random.default_rng(3).standard_normal(
        (3, 9, KW["num_classes"])).astype(np.float32)

    def objective(p):
        (out, lens), new = jm.apply(
            {"params": p, "batch_stats": stats}, x, LENGTHS,
            deterministic=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(5)})
        return jnp.sum(out * proj), (out, new["batch_stats"])

    (_, (out_j, stats_j)), g_j = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    model.load_state_dict(conformer_state_dict(params, stats))
    model.train()
    model.zero_grad()
    out, _ = model(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    sd = model.state_dict()
    for k, want in conformer_state_dict(params, stats_j).items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), **TOL,
                                       err_msg=k)
    want = conformer_state_dict(g_j, stats)
    grads = dict(model.named_parameters())
    assert set(grads) <= set(want)
    for name, p in grads.items():
        got, g = p.grad.numpy(), want[name].numpy()
        if name.endswith(NOISE_GRADS):
            assert np.abs(got).max() < NOISE and np.abs(g).max() < NOISE, name
            continue
        assert _rel(got, g) < GRAD_RTOL, (name, _rel(got, g))


def _wrapped(monkeypatch):
    """Counts the calls of every fused-stage wrapper of the conv module."""
    calls = {}
    for name in ("glu_in_forward", "glu_in_backward", "bn_out_forward",
                 "bn_out_backward"):
        fn = getattr(conv_module, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(conv_module, name, counted)
    return calls


@pytest.mark.parametrize("training", [False, True])
def test_conv_module_at_d144_takes_jax_unfused_path(monkeypatch, training):
    D, T = 144, 12
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, T, D)).astype(np.float32)
    lens = np.array([12, 9, 5])
    mask = np.arange(T)[None] < lens[:, None]
    x *= mask[..., None]
    jm = jax_layers.ConvModule(D, 3, 0.0, use_batchnorm=True, residual=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x),
                         jnp.asarray(mask))
    params, stats = _perturbed(v["params"], 4), _stats(v["batch_stats"], 6)
    proj = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def call(xx):
        """The output, the updated statistics and the input gradient."""
        def f(y):
            out, new = jm.apply({"params": params, "batch_stats": stats}, y,
                                jnp.asarray(mask), deterministic=not training,
                                mutable=["batch_stats"])
            return out, new["batch_stats"]
        out, vjp, new = jax.vjp(f, xx, has_aux=True)
        return out, new, vjp(jnp.asarray(proj))[0]

    out_j, new_j, gx_j = call(jnp.asarray(x))
    calls = _wrapped(monkeypatch)
    mod = ConvModule(D, 3, use_batchnorm=True)
    assert not mod.fused
    mod.load_state_dict(conv_module_state_dict(params, stats))
    mod.train(training)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt, torch.from_numpy(mask), torch.float32)
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL)
    want = conv_module_state_dict(params, new_j)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(mod.state_dict()[k].numpy(),
                                   want[k].numpy(), **TOL, err_msg=k)
    assert calls == {}


def _glu_args(R=70, D=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc
    x = r(R, D)
    x[3] = x[2]
    x[5] = 0.0
    mask = torch.rand(R, generator=g) > 0.2
    return (x, mask, 1 + r(D, sc=0.1), r(D, sc=0.1), r(D, 2 * D, sc=D ** -0.5),
            r(2 * D, sc=0.1)), r(R, D)


def _bn_args(R=70, D=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc
    mask = torch.rand(R, generator=g) > 0.2
    return (r(R, D), r(R, D), mask, r(D, sc=0.1), 1 + r(D, sc=0.3).abs(),
            1 + r(D, sc=0.1), r(D, sc=0.1), r(D, D, sc=D ** -0.5),
            r(D, sc=0.1)), r(R, D)


def test_float32_on_the_cpu_takes_the_plain_versions():
    wrappers = (conv_module.glu_in_forward, conv_module.glu_in_backward,
                conv_module.bn_out_forward, conv_module.bn_out_backward,
                conv_module.glu_in_forward_f32,
                conv_module.glu_in_backward_f32,
                conv_module.bn_out_forward_f32,
                conv_module.bn_out_backward_f32)
    before = [w.launches for w in wrappers]
    glu, do = _glu_args()
    bn, _ = _bn_args()
    kw = dict(rate=0.1, seed=(3, 4))
    assert torch.equal(conv_module.glu_in_forward(*glu),
                       conv_module.glu_in_reference(*glu))
    for a, b in zip(conv_module.glu_in_backward(*glu, do),
                    conv_module.glu_in_backward_reference(*glu, do)):
        assert torch.equal(a, b)
    assert torch.equal(conv_module.bn_out_forward(*bn, **kw),
                       conv_module.bn_out_reference(*bn, **kw))
    for a, b in zip(conv_module.bn_out_backward(*bn, do, **kw),
                    conv_module.bn_out_backward_reference(*bn, do, **kw)):
        assert torch.equal(a, b)
    assert [w.launches for w in wrappers] == before


def test_f32_wrappers_take_float32_cuda_only():
    glu, do = _glu_args()
    bn, _ = _bn_args()
    for call in (lambda: conv_module.glu_in_forward_f32(*glu),
                 lambda: conv_module.glu_in_backward_f32(*glu, do),
                 lambda: conv_module.bn_out_forward_f32(*bn),
                 lambda: conv_module.bn_out_backward_f32(*bn, do)):
        with pytest.raises(ValueError, match="float32 CUDA"):
            call()
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    mglu, mbn, mdo = [meta(t) for t in glu], [meta(t) for t in bn], meta(do)
    for call in (lambda: conv_module.glu_in_forward_f32(*mglu),
                 lambda: conv_module.glu_in_backward_f32(*mglu, mdo),
                 lambda: conv_module.bn_out_forward_f32(*mbn),
                 lambda: conv_module.bn_out_backward_f32(*mbn, mdo)):
        with pytest.raises(ValueError, match="float32 CUDA"):
            call()
    # a float32 tensor off the CPU and the card reaches the bf16 route,
    # whose kernels refuse it
    for call in (lambda: conv_module.glu_in_forward(*mglu),
                 lambda: conv_module.bn_out_forward(*mbn)):
        with pytest.raises(ValueError, match="bfloat16 CUDA"):
            call()


def _slices(R, splits):
    """`gemm_split_k`'s slices of R: k_split rows a slice, a multiple of
    16 (csrc/f32_tiles.cuh)."""
    k_split = -(-(-(-R // splits)) // 16) * 16
    return [(z, min(R, z + k_split)) for z in range(0, R, k_split)]


def _split_product(a, b, R):
    """a^T . b summed over `wgrad_splits(R)` slices of the rows in order."""
    out = torch.zeros(a.shape[1], b.shape[1])
    for s, e in _slices(R, wgrad_splits(R)):
        out = out + a[s:e].t() @ b[s:e]
    return out


def _colsum(t):
    """`colsum`: 64-row chunk sums, then the chunks summed in order."""
    out = torch.zeros(t.shape[1])
    for s in range(0, t.shape[0], 64):
        out = out + t[s:s + 64].sum(0)
    return out


@pytest.mark.parametrize("R", [70, 1100, 9000])
def test_f32_blocked_sums_match_the_plain_backward(R):
    """The glu_in and bn_out f32 backwards' weight and column sums as the
    kernels order them (R = 9000: 16 slices of 576 rows, the last 360)."""
    D = 64
    glu, do = _glu_args(R, D, seed=R)
    x, mask, gamma, beta, w, b = glu
    m = mask.float()[:, None]
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True)
                       + conv_module.LN_EPS)
    h = (x - mean) * rstd * gamma + beta
    h2 = h @ w + b
    s = torch.sigmoid(h2[:, D:])
    da = do * m
    dh2 = torch.cat([da * s, da * h2[:, :D] * s * (1 - s)], 1)
    dh = dh2 @ w.t()
    want = conv_module.glu_in_backward_reference(*glu, do)
    got = (_colsum(dh * (x - mean) * rstd), _colsum(dh),
           _split_product(h, dh2, R), _colsum(dh2))
    for name, a, b_ in zip(("dgamma", "dbeta", "dw", "db"), got, want[1:]):
        assert _rel(a, b_) < SUM_RTOL, (name, _rel(a, b_))
    bn, do = _bn_args(R, D, seed=R + 1)
    c, x, mask, mean, var, scale, bias, w, b = bn
    kw = dict(rate=0.1, seed=(5, 6))
    rstd = torch.rsqrt(var + conv_module.BN_EPS)
    xn = (c - mean) * rstd
    y0 = xn * scale + bias
    s = torch.sigmoid(y0)
    keep = conv_module.dropout_scale(kw["seed"], 0, 1, R, D, 0.1, "cpu")[0]
    dh = do * mask.float()[:, None] * keep
    dy0 = (dh @ w.t()) * s * (1 + y0 * (1 - s))
    dbias, dscale = _colsum(dy0), _colsum(dy0 * xn)
    got = (-rstd * scale * dbias, -0.5 * scale * rstd ** 2 * dscale, dscale,
           dbias, _split_product(y0 * s, dh, R), _colsum(dh))
    want = conv_module.bn_out_backward_reference(*bn, do, **kw)
    for name, a, b_ in zip(("dmean", "dvar", "dscale", "dbias", "dw", "db"),
                           got, want[1:]):
        assert _rel(a, b_) < SUM_RTOL, (name, _rel(a, b_))


def test_wgrad_slices_cover_every_row_once():
    for R in (1, 15, 16, 513, 9000, 15776):
        sl = _slices(R, wgrad_splits(R))
        assert sl[0][0] == 0 and sl[-1][1] == R
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
        assert len(sl) <= wgrad_splits(R)


@pytest.fixture
def cudnn_flags(monkeypatch):
    """Records every entry into `torch.backends.cudnn.flags`."""
    seen = []

    @contextlib.contextmanager
    def recorder(**kw):
        seen.append(kw)
        yield

    monkeypatch.setattr(torch.backends.cudnn, "flags", recorder)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float32_convs_enter_cudnn_flags_without_tf32(cudnn_flags, dtype):
    g = torch.Generator().manual_seed(0)
    sub = layers.Conv2dSubsampling(20, 16)
    x = torch.randn(2, 23, 20, generator=g, requires_grad=True)
    out, _ = sub(x, torch.tensor([23, 17]), dtype)
    out.float().sum().backward()
    conv = ConvModule(16, 3, use_batchnorm=False)
    h = torch.randn(2, 7, 16, generator=g).to(dtype).requires_grad_(True)
    conv(h, torch.ones(2, 7, dtype=torch.bool), dtype).float().sum().backward()
    if dtype == torch.bfloat16:
        assert cudnn_flags == []
        return
    # conv_a, conv_b and the depthwise conv, each forward and backward
    assert len(cudnn_flags) == 6
    assert all(kw["allow_tf32"] is False for kw in cudnn_flags)
    cudnn_flags.clear()
    tdnn = layers.TDNNLayer(8, 8, half_context=1, dilation=3, stride=2)
    h = torch.randn(2, 8, 15, generator=g, requires_grad=True)
    out, lens = tdnn(h, torch.tensor([15, 11]))
    out.sum().backward()
    assert lens.tolist() == [8, 6]
    assert len(cudnn_flags) == 2
    assert all(kw["allow_tf32"] is False for kw in cudnn_flags)
    cudnn_flags.clear()
    vgg = layers.VGG2LSubsampling(20, 16, out_channel=8)
    out, lens = vgg(x, torch.tensor([23, 3]), torch.bfloat16)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and lens.tolist() == [5, 1]
    assert len(cudnn_flags) == 8
    assert all(kw["allow_tf32"] is False for kw in cudnn_flags)


def test_conv_f32_matches_torch_convolutions():
    """`conv_f32` is F.conv1d / F.conv2d, forward and backward."""
    g = torch.Generator().manual_seed(1)
    for x, w, kw, conv in (
            (torch.randn(2, 3, 17, 11, generator=g),
             torch.randn(5, 3, 3, 3, generator=g), dict(stride=2),
             torch.nn.functional.conv2d),
            (torch.randn(2, 4, 19, generator=g),
             torch.randn(6, 4, 3, generator=g),
             dict(stride=2, padding=3, dilation=3),
             torch.nn.functional.conv1d),
            (torch.randn(2, 4, 19, generator=g),
             torch.randn(4, 1, 5, generator=g), dict(groups=4),
             torch.nn.functional.conv1d)):
        b = torch.randn(w.shape[0], generator=g)
        args = [t.clone().requires_grad_(True) for t in (x, w, b)]
        ref = [t.clone().requires_grad_(True) for t in (x, w, b)]
        out = layers.conv_f32(*args, **kw)
        want = conv(*ref, **kw)
        proj = torch.randn(want.shape, generator=g)
        (out * proj).sum().backward()
        (want * proj).sum().backward()
        torch.testing.assert_close(out, want)
        for a, r in zip(args, ref):
            torch.testing.assert_close(a.grad, r.grad)
