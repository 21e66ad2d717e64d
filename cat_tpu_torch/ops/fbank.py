"""Log-mel filterbank features (counterpart of `cat_tpu/ops/fbank.py`).

Kaldi's conventions, as the JAX package keeps them: snip-edges framing
(25 ms windows every 10 ms), per-frame DC removal, pre-emphasis 0.97
inside the frame, the povey window, an `rfft` zero-padded to `fft_size`,
the HTK mel scale 1127·ln(1 + f/700) and a floor of 1e-10 before the
log. `log_fbank` and `cmvn` run on the waveform's device: on the card
the FFT is cuFFT's, through `torch.fft.rfft`. The JAX functions are plain
jnp, not Pallas kernels, so PyTorch ops are their counterpart. The
filterbank and the window are numpy, built as the JAX package builds
them; speed perturbation resamples on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def mel_filterbank(num_bins: int, fft_size: int, sample_rate: int,
                   low_freq: float = 20.0, high_freq: float | None = None):
    """(num_fft_bins, num_mel_bins) triangular filterbank matrix, numpy."""
    if high_freq is None:
        high_freq = sample_rate / 2.0

    def mel(f):
        return 1127.0 * np.log1p(f / 700.0)

    def imel(m):
        return 700.0 * (np.expm1(m / 1127.0))

    n_freqs = fft_size // 2 + 1
    freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(mel(low_freq), mel(high_freq), num_bins + 2)
    f_pts = imel(mel_pts)
    fb = np.zeros((n_freqs, num_bins), np.float32)
    for b in range(num_bins):
        l, c, r = f_pts[b], f_pts[b + 1], f_pts[b + 2]
        up = (freqs - l) / max(c - l, 1e-9)
        down = (r - freqs) / max(r - c, 1e-9)
        fb[:, b] = np.maximum(0.0, np.minimum(up, down))
    return fb


def povey_window(n: int):
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return (hann ** 0.85).astype(np.float32)


def num_frames(num_samples, frame_length=400, frame_shift=160):
    """Kaldi snip-edges frame count of an int, a numpy array or a
    tensor."""
    n = 1 + (num_samples - frame_length) // frame_shift
    if torch.is_tensor(n):
        return torch.clamp_min(n, 0)
    return np.maximum(0, n)


def log_fbank(waveform, num_bins=80, sample_rate=16000, frame_length=400,
              frame_shift=160, fft_size=512, preemph=0.97):
    """(N, num_samples) f32 waveform tensor -> (N, T, num_bins) log-mel
    features on its device, T = 1 + (num_samples - frame_length) //
    frame_shift (snip-edges). Padded batches keep their true frame counts
    with `num_frames`."""
    waveform = torch.as_tensor(waveform, dtype=torch.float32)
    frames = waveform.unfold(-1, frame_length, frame_shift)  # (N, T, W)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemph * pre
    dev = waveform.device
    frames = frames * torch.from_numpy(povey_window(frame_length)).to(dev)
    power = torch.fft.rfft(frames, n=fft_size, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filterbank(num_bins, fft_size,
                                         sample_rate)).to(dev)
    return torch.log(torch.clamp_min(power @ fb, 1e-10))


def cmvn(feats, lengths=None, norm_var=False):
    """Per-utterance cepstral mean (and optionally variance)
    normalisation. feats (N, T, F); lengths (N,) valid frame counts
    (None: every frame)."""
    if lengths is None:
        mean = feats.mean(dim=1, keepdim=True)
        var = feats.var(dim=1, unbiased=False, keepdim=True)
    else:
        lengths = torch.as_tensor(lengths, device=feats.device)
        mask = (torch.arange(feats.shape[1], device=feats.device)[None, :,
                                                                   None]
                < lengths[:, None, None])
        cnt = torch.clamp_min(lengths[:, None, None].to(feats.dtype), 1.0)
        mean = torch.where(mask, feats, 0.0).sum(1, keepdim=True) / cnt
        var = torch.where(mask, (feats - mean) ** 2, 0.0).sum(
            1, keepdim=True) / cnt
    out = feats - mean
    if norm_var:
        out = out / torch.sqrt(var + 1e-8)
    return out


def speed_perturb_resample(waveform, factor: float):
    """Linear-interpolation resampling for speed perturbation at prep time
    (factors 0.9 and 1.1 in the recipes), on the host, numpy in and
    out."""
    wav = np.asarray(waveform)
    n_out = int(round(wav.shape[-1] / factor))
    src = np.arange(n_out) * factor
    i0 = np.clip(src.astype(np.int64), 0, wav.shape[-1] - 1)
    i1 = np.clip(i0 + 1, 0, wav.shape[-1] - 1)
    frac = (src - i0).astype(wav.dtype)
    return wav[..., i0] * (1 - frac) + wav[..., i1] * frac
