"""The neural mask beamforming front end of multichannel end-to-end ASR in
PyTorch (counterpart of `cat_tpu/front/beamformer.py`).

A multichannel wave (N, C, L) -> STFT (N, C, T, F) complex64 -> optional
(DNN-)WPE dereverberation -> a BLSTM mask net on the reference channel's
log power -> speech and noise masks (N, T, F) -> spatial covariances ->
MVDR, MPDR or GEV weights (N, F, C), or the WPD convolutional beamformer
-> the beamformed STFT (N, T, F) -> log-mel (N, T, B). Every step is
differentiable. The JAX module is jnp FFTs, einsums and
`jnp.linalg.solve`, outside any Pallas kernel, so `torch.fft.rfft`,
complex64 `einsum` and batched `torch.linalg.solve` are its counterpart
here: no CUDA kernel of the port runs in the front end. The mask nets are
the port's `LSTM` (flax's `OptimizedLSTMCell`, scanned frame by frame),
computing in float32.

Every module takes its input widths as arguments (`idim` of the mask
nets, the number of channels of `NeuralFilter`), which the JAX modules
infer; the filterbank and the window are non-persistent buffers, outside
the state_dict as they are outside the JAX params.
"""
from __future__ import annotations

import torch
from torch import nn

from cat_tpu_torch.front.wpe import (DnnWpe, _tap_stack, _trace, time_mask,
                                     wpe)
from cat_tpu_torch.models.encoders import LSTM, init_weights
from cat_tpu_torch.models.layers import Dense
from cat_tpu_torch.ops.fbank import mel_filterbank, povey_window

BEAMFORMERS = ("mvdr", "mpdr", "gev", "wpd")


def _frames(wave, frame_length, frame_shift):
    """(..., L) -> (..., T, frame_length) snip-edges frames."""
    L = wave.shape[-1]
    T = 1 + (L - frame_length) // frame_shift
    idx = (torch.arange(T, device=wave.device)[:, None] * frame_shift
           + torch.arange(frame_length, device=wave.device)[None, :])
    return wave[..., idx]


class Stft(nn.Module):
    """Batched STFT: (..., L) -> (..., T, fft_size // 2 + 1) complex64,
    povey window, snip-edges framing."""

    def __init__(self, frame_length=400, frame_shift=160, fft_size=512):
        super().__init__()
        self.frame_length, self.frame_shift = frame_length, frame_shift
        self.fft_size = fft_size
        self.register_buffer("window", torch.from_numpy(
            povey_window(frame_length)), persistent=False)

    def forward(self, wave):
        frames = _frames(wave, self.frame_length, self.frame_shift)
        return torch.fft.rfft(frames * self.window, n=self.fft_size, dim=-1)

    def num_frames(self, num_samples):
        return 1 + (num_samples - self.frame_length) // self.frame_shift


class LogMel(nn.Module):
    """Power spectrum (..., T, F) -> log-mel (..., T, B), floored at
    1e-10 before the log."""

    def __init__(self, num_bins=80, fft_size=512, sample_rate=16000):
        super().__init__()
        self.register_buffer("fb", torch.from_numpy(mel_filterbank(
            num_bins, fft_size, sample_rate)), persistent=False)

    def forward(self, power):
        """In float32, or float64 for a float64 power (a witness)."""
        mel = torch.einsum("...tf,fb->...tb", power,
                           self.fb.to(power.dtype))
        return torch.log(torch.clamp_min(mel, 1e-10))


class MaskNet(nn.Module):
    """BLSTM T-F mask estimator: (N, T, idim) log power -> speech and noise
    masks (N, T, idim) in (0, 1). `lstm` is the port's `LSTM` without a
    head (num_layers bidirectional layers of `hidden`, no dropout), the
    JAX module's `LSTMStack_0`; `speech` and `noise` its Dense heads."""

    def __init__(self, hidden=256, num_layers=2, idim=257, generator=None):
        super().__init__()
        self.lstm = LSTM(hidden, num_layers, bidirectional=True,
                         dropout_rate=0.0, with_head=False, idim=idim,
                         generator=generator)
        self.speech = Dense(2 * hidden, idim)
        self.noise = Dense(2 * hidden, idim)
        init_weights(self.speech, generator)
        init_weights(self.noise, generator)

    def forward(self, log_power, lengths):
        h, _ = self.lstm(log_power, lengths)
        return (torch.sigmoid(self.speech(h, torch.float32)),
                torch.sigmoid(self.noise(h, torch.float32)))


def _spatial_cov(stft_c, mask, lengths):
    """Masked spatial covariance (N, F, C, C) of stft_c (N, C, T, F) under
    mask (N, T, F), frames past a length weighted 0."""
    T = stft_c.shape[2]
    m = torch.where(time_mask(lengths, T, stft_c.device)[..., None], mask,
                    0.0)
    x = stft_c.permute(0, 3, 2, 1)                      # (N, F, T, C)
    mw = m.permute(0, 2, 1)[..., None]                  # (N, F, T, 1)
    num = torch.einsum("nftc,nftd->nfcd", x * mw, x.conj())
    den = torch.clamp_min(mw[..., 0].sum(-1), 1e-6)     # (N, F)
    return num / den[..., None, None]


def _loaded(phi, diag_eps, floor=1e-6):
    """phi + diag_eps · max(tr(phi), floor) · I."""
    C = phi.shape[-1]
    eye = torch.eye(C, dtype=phi.dtype, device=phi.device)
    return phi + diag_eps * torch.clamp_min(
        _trace(phi).real[..., None, None], floor) * eye


def mvdr_weights(phi_s, phi_n, ref_channel=0, diag_eps=1e-5):
    """MVDR: w = (Φn⁻¹ Φs / tr(Φn⁻¹ Φs)) u_ref -> (N, F, C). With Φn the
    observed signal's covariance it is the MPDR beamformer."""
    num = torch.linalg.solve(_loaded(phi_n, diag_eps), phi_s)
    tr = _trace(num)
    tr = torch.where(tr.abs() < 1e-8, torch.full_like(tr, 1e-8), tr)
    return num[..., ref_channel] / tr[..., None]


def gev_weights(phi_s, phi_n, iterations=6, diag_eps=1e-5):
    """GEV (max-SNR): the principal generalized eigenvector of (Φs, Φn) by
    `iterations` power iterations on Φn⁻¹Φs from a vector of ones, its
    phase fixed against channel 0 -> (N, F, C)."""
    m = torch.linalg.solve(_loaded(phi_n, diag_eps), phi_s)
    v = torch.ones(m.shape[:-1], dtype=m.dtype, device=m.device)
    for _ in range(iterations):
        v = torch.einsum("nfcd,nfd->nfc", m, v)
        v = v / torch.clamp_min(torch.linalg.vector_norm(
            v, dim=-1, keepdim=True), 1e-10)
    phase = v[..., :1] / torch.clamp_min(v[..., :1].abs(), 1e-10)
    return v * phase.conj()


def wpd_beamform(spec, mask_s, lengths, taps=5, delay=3, ref_channel=0,
                 diag_eps=1e-7, eps=1e-6):
    """WPD convolutional beamformer (joint denoising and dereverberation):
    Ỹ_t = [X_t, X_{t−Δ}, …, X_{t−Δ−K+1}] ((K+1)·C a frame), R = Σ_t Ỹ_t
    Ỹ_tᴴ / φ_t with φ the masked speech power, h = R⁻¹[:, :C] Φs u_ref /
    tr(R⁻¹[:C, :C] Φs), out = hᴴ Ỹ. spec (N, C, T, F), mask_s (N, T, F)
    -> (N, T, F)."""
    N, C, T, F = spec.shape
    x = spec.permute(0, 3, 1, 2)                        # (N, F, C, T)
    tmask = time_mask(lengths, T, spec.device)          # (N, T)
    m = torch.where(tmask[..., None], mask_s, 0.0)
    mw = m.permute(0, 2, 1)                             # (N, F, T)
    xm = x * mw[:, :, None, :].to(x.dtype)
    phi = torch.einsum("nfct,nfdt->nfcd", xm, x.conj())
    den = torch.clamp_min(mw.sum(-1), eps)
    phi = phi / den[..., None, None].to(phi.dtype)
    power = torch.einsum("nfct,nfct->nft", xm, x.conj()).real / C
    u = torch.where(tmask[:, None, :], 1.0 / torch.clamp_min(power, eps),
                    0.0)
    ytil = torch.cat([x, _tap_stack(x, taps, delay)], -2)
    yw = ytil * u[:, :, None, :].to(ytil.dtype)
    R = torch.einsum("nfkt,nflt->nfkl", yw, ytil.conj())
    KC = (taps + 1) * C
    eye = torch.eye(KC, dtype=R.dtype, device=R.device)
    R = R + diag_eps * torch.clamp_min(_trace(R).real[..., None, None],
                                       eps) * eye
    inv_cols = torch.linalg.solve(R, eye[:, :C].expand(R.shape[:-2]
                                                       + (KC, C)))
    num = torch.einsum("nfkc,nfcd->nfkd", inv_cols, phi)
    tr = _trace(num[..., :C, :])
    tr = torch.where(tr.abs() < eps, torch.full_like(tr, eps), tr)
    w = num[..., ref_channel] / tr[..., None]           # (N, F, KC)
    return torch.einsum("nfk,nfkt->nft", w.conj(), ytil).permute(0, 2, 1)


class BeamformerNet(nn.Module):
    """STFT-domain neural beamforming front end: (N, C, L) wave -> (N, T,
    num_bins) log-mel features and frame lengths.

    beamformer_type "mvdr", "mpdr" (MVDR against the observed covariance),
    "gev" or "wpd"; use_wpe dereverberates first, by `DnnWpe` (a mask net
    of its own) when use_dnn_mask_for_wpe, else by blind `wpe` (at least 3
    iterations); kaldi_framing removes each frame's DC offset and
    pre-emphasizes by 0.97 before the window; no_enhance (the `noSE`
    channel selector) takes the reference channel's power as it is, with
    no mask net and no parameters."""

    def __init__(self, num_bins=80, sample_rate=16000, frame_length=400,
                 frame_shift=160, fft_size=512, mask_hidden=256,
                 ref_channel=0, beamformer_type="mvdr", use_wpe=False,
                 use_dnn_mask_for_wpe=True, wpe_taps=5, wpe_delay=3,
                 wpe_iterations=1, kaldi_framing=False, no_enhance=False,
                 generator=None):
        super().__init__()
        if beamformer_type not in BEAMFORMERS:
            raise ValueError(f"beamformer_type {beamformer_type!r} is not one "
                             f"of {BEAMFORMERS}")
        self.num_bins, self.sample_rate = num_bins, sample_rate
        self.frame_length, self.frame_shift = frame_length, frame_shift
        self.fft_size, self.ref_channel = fft_size, ref_channel
        self.beamformer_type = beamformer_type
        self.use_wpe, self.use_dnn_mask_for_wpe = use_wpe, use_dnn_mask_for_wpe
        self.wpe_taps, self.wpe_delay = wpe_taps, wpe_delay
        self.wpe_iterations = wpe_iterations
        self.kaldi_framing, self.no_enhance = kaldi_framing, no_enhance
        F = fft_size // 2 + 1
        self.register_buffer("window", torch.from_numpy(
            povey_window(frame_length)), persistent=False)
        self.logmel = LogMel(num_bins, fft_size, sample_rate)
        self.dnn_wpe = self.mask = None
        if no_enhance:
            return
        if use_wpe and use_dnn_mask_for_wpe:
            self.dnn_wpe = DnnWpe(wpe_taps, wpe_delay, wpe_iterations,
                                  mask_hidden, idim=F, generator=generator)
        self.mask = MaskNet(mask_hidden, 2, F, generator)

    def forward(self, wave, wave_lengths):
        spec, frame_lengths = self.spectrum(wave, wave_lengths)
        return self.enhance(spec, frame_lengths)

    def spectrum(self, wave, wave_lengths):
        """(N, C, L) float32 wave -> ((N, C, T, F) complex64 STFT, frame
        lengths (N,)); a float64 wave gives a complex128 STFT."""
        frames = _frames(wave, self.frame_length, self.frame_shift)
        if self.kaldi_framing:
            frames = frames - frames.mean(-1, keepdim=True)
            frames = frames - 0.97 * torch.cat([frames[..., :1],
                                                frames[..., :-1]], -1)
        spec = torch.fft.rfft(frames * self.window, n=self.fft_size, dim=-1)
        flens = 1 + (wave_lengths.to(wave.device) - self.frame_length) \
            // self.frame_shift
        return spec, flens

    def enhance(self, spec, frame_lengths):
        """(N, C, T, F) complex spectrum -> (log-mel (N, T, B), frame
        lengths); the chunked model beamforms its context windows here."""
        if self.no_enhance:
            return self.logmel(spec[:, self.ref_channel].abs() ** 2), \
                frame_lengths
        if self.use_wpe:
            if self.dnn_wpe is not None:
                spec, _ = self.dnn_wpe(spec, frame_lengths)
            else:
                spec = wpe(spec, frame_lengths, self.wpe_taps, self.wpe_delay,
                           max(self.wpe_iterations, 3))
        ref_pow = spec[:, self.ref_channel].abs() ** 2
        m_s, m_n = self.mask(torch.log(torch.clamp_min(ref_pow, 1e-10)),
                             frame_lengths)
        if self.beamformer_type == "wpd":
            bf = wpd_beamform(spec, m_s, frame_lengths, taps=self.wpe_taps,
                              delay=self.wpe_delay,
                              ref_channel=self.ref_channel)
        else:
            phi_s = _spatial_cov(spec, m_s, frame_lengths)
            phi_n = _spatial_cov(spec, torch.ones_like(m_s) if
                                 self.beamformer_type == "mpdr" else m_n,
                                 frame_lengths)
            w = (gev_weights(phi_s, phi_n) if self.beamformer_type == "gev"
                 else mvdr_weights(phi_s, phi_n, self.ref_channel))
            bf = torch.einsum("nftc,nfc->nft", spec.permute(0, 3, 2, 1),
                              w.conj()).permute(0, 2, 1)
        return self.logmel(bf.abs() ** 2), frame_lengths


class ChannelSelector(nn.Module):
    """One channel of a multichannel wave or spectrum: (N, C, ...) ->
    (N, ...)."""

    def __init__(self, chosen_channel=0):
        super().__init__()
        self.chosen_channel = chosen_channel

    def forward(self, x, lengths):
        return x[:, self.chosen_channel], lengths


class NeuralFilter(nn.Module):
    """Neural complex filter-and-sum: a 2-layer BLSTM on the stacked log
    power of the `channels` channels (C·idim inputs a frame) predicts a
    complex weight per channel and T-F bin (`filt_re`, `filt_im`); the
    output is Σ_c w*_c X_c, (N, T, F)."""

    def __init__(self, hidden=256, channels=2, idim=257, generator=None):
        super().__init__()
        self.channels, self.idim = channels, idim
        self.lstm = LSTM(hidden, 2, bidirectional=True, dropout_rate=0.0,
                         with_head=False, idim=channels * idim,
                         generator=generator)
        self.filt_re = Dense(2 * hidden, channels * idim)
        self.filt_im = Dense(2 * hidden, channels * idim)
        init_weights(self.filt_re, generator)
        init_weights(self.filt_im, generator)

    def forward(self, spec, lengths):
        N, C, T, F = spec.shape
        logp = torch.log(torch.clamp_min(spec.abs() ** 2, 1e-10))
        h, _ = self.lstm(logp.permute(0, 2, 1, 3).reshape(N, T, C * F),
                         lengths)
        wr = self.filt_re(h, torch.float32).view(N, T, C, F)
        wi = self.filt_im(h, torch.float32).view(N, T, C, F)
        w = torch.complex(wr, wi).to(spec.dtype)
        return (w.conj() * spec.permute(0, 2, 1, 3)).sum(2)
