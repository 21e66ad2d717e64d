"""Port parity for the multichannel front end (`cat_tpu_torch.front`)
against `cat_tpu.front`, in float32 and complex64 on the CPU.

Inputs are drawn with numpy from fixed seeds: 3 channels of random noise
over a weaker shared delayed source (well conditioned: T = 74 frames >= 4·KC
for WPE's KC = 15), N = 2 at padded lengths (2400 and 2100 samples: 74
and 64 frames), fft 64, 12 mel bins, mask nets of 8 units. The JAX
modules run as their own tests run them (`jax.jit` on the CPU; the front
end reaches no Pallas kernel). Weights are JAX's init, perturbed, carried
across by `utils.from_jax`.

- `Stft` and `BeamformerNet.spectrum` (with and without kaldi_framing),
  `LogMel`, `_spatial_cov`, `mvdr_weights`, `gev_weights`,
  `wpd_beamform`, `wpe_one_iteration`, `wpe`, `MaskNet`, `DnnWpe`,
  `BeamformerNet` in every beamformer_type, with (DNN-)WPE on and off and
  with no_enhance, `ChannelSelector` and `NeuralFilter`: within 1e-4
  relative norm; `_tap_stack` exactly.
- The gradients of a real loss of `BeamformerNet` (mvdr + DNN-WPE) with
  respect to every parameter within 1e-3 relative norm of `jax.grad`'s
  (the DNN-WPE mask net's noise head: zero in both), and the gradient
  with respect to the wave zero at the padded samples in both.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.front import beamformer as jbf
from cat_tpu.front import wpe as jwpe
from cat_tpu_torch.front import beamformer as bf
from cat_tpu_torch.front import wpe as pwpe
from cat_tpu_torch.utils.from_jax import model_state_dict
from tests.test_torch_transducer import _np_tree, _perturbed

torch.set_num_threads(2)
C, L, SR = 3, 2400, 8000
LENS = np.array([2400, 2100], np.int32)
FRONT = dict(num_bins=12, sample_rate=SR, frame_length=64, frame_shift=32,
             fft_size=64, mask_hidden=8)
F = FRONT["fft_size"] // 2 + 1
REL = 1e-4


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def waves(seed=0, n=2):
    """(N, C, L) float32: a source reaching each channel c samples later,
    plus independent noise; zero past each length."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(L + C).astype(np.float32)
    w = np.stack([src[C - c:C - c + L] for c in range(C)])[None] * 0.1
    w = w + 0.3 * rng.standard_normal((n, C, L)).astype(np.float32)
    return (w * (np.arange(L) < LENS[:n, None, None])).astype(np.float32)


def spec_and_lens(seed=0):
    """(N, C, T, F) complex64 STFT of `waves` and the frame lengths."""
    net = bf.BeamformerNet(**FRONT, no_enhance=True)
    s, fl = net.spectrum(torch.from_numpy(waves(seed)),
                         torch.from_numpy(LENS))
    return s, fl


def _jax_init(module, *args, seed=0):
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    return _perturbed(_np_tree(variables["params"]), seed + 1)


def _load(port, params):
    port.load_state_dict(model_state_dict(port, params, {}))
    return port


@pytest.mark.parametrize("kaldi", [False, True])
def test_stft_and_spectrum_match_jax(kaldi):
    w = waves()
    got = bf.Stft(64, 32, 64)(torch.from_numpy(w))
    want = jbf.Stft(64, 32, 64)(jnp.asarray(w))
    assert got.dtype == torch.complex64
    assert rel(got.numpy(), want) < REL
    net = bf.BeamformerNet(**FRONT, kaldi_framing=kaldi)
    s, fl = net.spectrum(torch.from_numpy(w), torch.from_numpy(LENS))
    ws, wfl = jbf.BeamformerNet(**FRONT, kaldi_framing=kaldi).spectrum(
        jnp.asarray(w), jnp.asarray(LENS))
    assert rel(s.numpy(), ws) < REL
    np.testing.assert_array_equal(fl.numpy(), np.asarray(wfl))
    assert fl.tolist() == [74, 64]


def test_logmel_matches_jax():
    s, _ = spec_and_lens()
    power = (s.abs() ** 2)[:, 0]
    got = bf.LogMel(12, 64, SR)(power)
    want = jbf.LogMel(12, 64, SR).apply({}, jnp.asarray(power.numpy()))
    assert rel(got.numpy(), want) < REL


def test_tap_stack_is_jax_s_exactly():
    s, _ = spec_and_lens()
    x = s.permute(0, 3, 1, 2).contiguous()            # (N, F, C, T)
    for taps, delay in ((5, 3), (2, 1), (1, 0)):
        got = pwpe._tap_stack(x, taps, delay)
        want = jwpe._tap_stack(jnp.asarray(x.numpy()), taps, delay)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _masks(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.05, 0.95, (2, 74, F)).astype(np.float32)
            for _ in range(2)]


def test_covariances_and_weights_match_jax():
    s, fl = spec_and_lens()
    ms, mn = _masks()
    js, jfl = jnp.asarray(s.numpy()), jnp.asarray(fl.numpy())
    phi_s = bf._spatial_cov(s, torch.from_numpy(ms), fl)
    phi_n = bf._spatial_cov(s, torch.from_numpy(mn), fl)
    jphi_s = jbf._spatial_cov(js, jnp.asarray(ms), jfl)
    jphi_n = jbf._spatial_cov(js, jnp.asarray(mn), jfl)
    assert rel(phi_s.numpy(), jphi_s) < REL
    assert rel(phi_n.numpy(), jphi_n) < REL
    for ref in (0, 2):
        assert rel(bf.mvdr_weights(phi_s, phi_n, ref).numpy(),
                   jbf.mvdr_weights(jphi_s, jphi_n, ref)) < REL
    assert rel(bf.gev_weights(phi_s, phi_n).numpy(),
               jbf.gev_weights(jphi_s, jphi_n)) < REL


def test_wpd_and_wpe_match_jax():
    s, fl = spec_and_lens()
    ms, _ = _masks()
    js, jfl = jnp.asarray(s.numpy()), jnp.asarray(fl.numpy())
    got = bf.wpd_beamform(s, torch.from_numpy(ms), fl, taps=2, delay=2)
    want = jax.jit(lambda a, b, c: jbf.wpd_beamform(a, b, c, taps=2,
                                                    delay=2))(
        js, jnp.asarray(ms), jfl)
    assert rel(got.numpy(), want) < REL
    power = (s.abs() ** 2).mean(1) * torch.from_numpy(ms)
    got = pwpe.wpe_one_iteration(s, power, fl)
    want = jax.jit(jwpe.wpe_one_iteration)(js, jnp.asarray(power.numpy()),
                                           jfl)
    assert rel(got.numpy(), want) < REL
    got = pwpe.wpe(s, fl, iterations=2)
    want = jax.jit(lambda a, b: jwpe.wpe(a, b, iterations=2))(js, jfl)
    assert rel(got.numpy(), want) < REL


def test_masknet_and_dnn_wpe_match_jax():
    s, fl = spec_and_lens()
    js, jfl = jnp.asarray(s.numpy()), jnp.asarray(fl.numpy())
    logp = torch.log(torch.clamp_min((s[:, 0].abs() ** 2), 1e-10))
    jlogp = jnp.asarray(logp.numpy())
    jm = jbf.MaskNet(8)
    params = _jax_init(jm, jlogp, jfl)
    port = _load(bf.MaskNet(8, 2, F), params)
    with torch.no_grad():
        got = port(logp, fl)
    want = jax.jit(jm.apply)({"params": params}, jlogp, jfl)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) < REL
    jd = jwpe.DnnWpe(mask_hidden=8, mask_flooring=True, normalization=True)
    params = _jax_init(jd, js, jfl, seed=2)
    port = _load(pwpe.DnnWpe(mask_hidden=8, mask_flooring=True,
                             normalization=True, idim=F), params)
    with torch.no_grad():
        got = port(s, fl)
    want = jax.jit(jd.apply)({"params": params}, js, jfl)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) < REL


NETS = {"mvdr": {}, "mvdr-dnn-wpe": {"use_wpe": True},
        "mvdr-wpe": {"use_wpe": True, "use_dnn_mask_for_wpe": False},
        "mpdr": {"beamformer_type": "mpdr"},
        "gev": {"beamformer_type": "gev"},
        "wpd": {"beamformer_type": "wpd", "wpe_taps": 2, "wpe_delay": 2},
        "wpd-dnn-wpe": {"beamformer_type": "wpd", "use_wpe": True,
                        "wpe_taps": 2, "wpe_delay": 2},
        "kaldi-no-enhance": {"kaldi_framing": True, "no_enhance": True}}


@pytest.fixture(scope="module")
def bf_params():
    """The parameters of a DNN-WPE BeamformerNet (`DnnWpe_0` and
    `MaskNet_0`), a superset of every other kind's."""
    return _jax_init(jbf.BeamformerNet(**FRONT, use_wpe=True),
                     jnp.asarray(waves()), jnp.asarray(LENS))


def _subset(params, kw):
    if kw.get("no_enhance"):
        return {}
    keep = ("MaskNet_0", "DnnWpe_0") if kw.get("use_wpe") and kw.get(
        "use_dnn_mask_for_wpe", True) else ("MaskNet_0",)
    return {k: params[k] for k in keep}


@pytest.mark.parametrize("name", sorted(NETS))
def test_beamformer_net_matches_jax(bf_params, name):
    kw = dict(FRONT, **NETS[name])
    w = jnp.asarray(waves(3))
    jn = jbf.BeamformerNet(**kw)
    params = _subset(bf_params, kw)
    port = _load(bf.BeamformerNet(**kw), params)
    with torch.no_grad():
        got, fl = port(torch.from_numpy(waves(3)), torch.from_numpy(LENS))
    want, wfl = jax.jit(jn.apply)({"params": params}, w, jnp.asarray(LENS))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(wfl))
    assert got.shape == (2, 74, 12)
    assert rel(got.numpy(), want) < REL
    if kw.get("no_enhance"):
        assert not list(port.parameters())


def test_channel_selector_and_neural_filter_match_jax():
    s, fl = spec_and_lens()
    js, jfl = jnp.asarray(s.numpy()), jnp.asarray(fl.numpy())
    got, gl = bf.ChannelSelector(1)(s, fl)
    want, _ = jbf.ChannelSelector(1).apply({}, js, jfl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gl is fl
    jn = jbf.NeuralFilter(8)
    params = _jax_init(jn, js, jfl)
    port = _load(bf.NeuralFilter(8, C, F), params)
    with torch.no_grad():
        got = port(s, fl)
    want = jax.jit(jn.apply)({"params": params}, js, jfl)
    assert got.dtype == torch.complex64
    assert rel(got.numpy(), want) < REL


def test_beamformer_gradients_match_jax(bf_params):
    """d(Σ r ⊙ feats over valid frames)/d(params) and d/d(wave) of
    BeamformerNet (mvdr + DNN-WPE) against jax.grad."""
    kw = dict(FRONT, use_wpe=True)
    w = waves(4)
    r = np.random.default_rng(5).standard_normal((2, 74, 12)).astype(
        np.float32)
    valid = (np.arange(74)[None, :, None]
             < np.array([74, 64])[:, None, None]).astype(np.float32)
    jn = jbf.BeamformerNet(**kw)
    params = bf_params

    def jloss(p, wave):
        feats, _ = jn.apply({"params": p}, wave, jnp.asarray(LENS))
        return jnp.sum(feats * r * valid) / 100.0

    jg, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                         jnp.asarray(w))
    port = _load(bf.BeamformerNet(**kw), params)
    wave = torch.from_numpy(w).requires_grad_()
    feats, _ = port(wave, torch.from_numpy(LENS))
    ((feats * torch.from_numpy(r * valid)).sum() / 100.0).backward()
    want = model_state_dict(port, _np_tree(jg), {})
    for name, p in port.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape,
                                                                np.float32)
        wn = want[name].numpy()
        if "dnn_wpe.mask.noise" in name:
            assert not wn.any() and not g.any(), name
            continue
        assert rel(g, wn) < 1e-3, (name, rel(g, wn))
    gw = wave.grad.numpy()
    assert rel(gw, jgw) < 1e-3
    pad = np.arange(L) >= LENS[:, None, None]
    pad = np.broadcast_to(pad, gw.shape)
    assert not gw[pad].any() and not np.asarray(jgw)[pad].any()
    assert np.isfinite(gw).all()
