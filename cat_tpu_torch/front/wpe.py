"""WPE dereverberation (weighted prediction error) in PyTorch (counterpart
of `cat_tpu/front/wpe.py`).

Per frequency bin, batched over (N, F):
  1. power estimate = mean_c |X|², optionally weighted by a DNN mask;
     inverse power u_t = 1 / max(power_t, eps), 0 past a length;
  2. delayed tap stack Ỹ_t = [X_{t−Δ}, …, X_{t−Δ−K+1}] over the C
     channels: a (K·C) vector a frame (Δ = delay, K = taps);
  3. R = Σ_t u_t Ỹ_t Ỹ_tᴴ (KC × KC), P = Σ_t u_t Ỹ_t X_tᴴ (KC × C);
  4. G = (R + diag_eps·tr(R)·I)⁻¹ P; the estimate X̂_t = X_t − Gᴴ Ỹ_t.

The JAX functions are jnp einsums and `jnp.linalg.solve`, outside any
Pallas kernel, so complex64 `einsum` and batched `torch.linalg.solve` are
their counterpart here, on whichever device the spectrum lies.
"""
from __future__ import annotations

import torch
from torch import nn


def _tap_stack(x, taps: int, delay: int):
    """x (..., C, T) complex -> (..., K·C, T): row k·C + c holds x[c]
    shifted right by delay + k frames, zeros before the signal."""
    T = x.shape[-1]
    parts = []
    for k in range(taps):
        shift = min(delay + k, T)
        zeros = x.new_zeros(x.shape[:-1] + (shift,))
        parts.append(torch.cat([zeros, x[..., :T - shift]], -1))
    return torch.cat(parts, -2)


def _trace(m):
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def time_mask(lengths, T, device):
    """(N, T) bool: frame t < lengths[n]."""
    return torch.arange(T, device=device)[None, :] < \
        lengths.to(device)[:, None]


def wpe_one_iteration(spec, power, lengths, taps: int = 5, delay: int = 3,
                      eps: float = 1e-6, diag_eps: float = 1e-7):
    """One WPE filter estimate and its application.

    spec (N, C, T, F) complex, power (N, T, F) real, lengths (N,) valid
    frames -> the dereverberated spectrum (N, C, T, F)."""
    N, C, T, F = spec.shape
    x = spec.permute(0, 3, 1, 2)                           # (N, F, C, T)
    u = 1.0 / torch.clamp_min(power, eps)
    u = torch.where(time_mask(lengths, T, spec.device)[..., None], u, 0.0)
    u = u.permute(0, 2, 1)                                 # (N, F, T)
    ytil = _tap_stack(x, taps, delay)                      # (N, F, KC, T)
    yw = ytil * u[:, :, None, :].to(ytil.dtype)
    R = torch.einsum("nfkt,nflt->nfkl", yw, ytil.conj())
    P = torch.einsum("nfkt,nfct->nfkc", yw, x.conj())
    eye = torch.eye(taps * C, dtype=R.dtype, device=R.device)
    trace = _trace(R).real[..., None, None]
    G = torch.linalg.solve(R + diag_eps * torch.clamp_min(trace, eps) * eye,
                           P)
    pred = torch.einsum("nfkc,nfkt->nfct", G.conj(), ytil)
    return (x - pred).permute(0, 2, 3, 1)                  # (N, C, T, F)


def wpe(spec, lengths, taps: int = 5, delay: int = 3, iterations: int = 3,
        eps: float = 1e-6):
    """Iterative blind WPE: each iteration re-estimates the power from the
    current estimate and filters the input spectrum again."""
    out = spec
    for _ in range(iterations):
        power = (out.abs() ** 2).mean(1)                   # (N, T, F)
        out = wpe_one_iteration(spec, power, lengths, taps, delay, eps)
    return out


class DnnWpe(nn.Module):
    """DNN-mask WPE: a BLSTM `MaskNet` on the log mean power scales the
    power estimate (floored and normalized over time when asked), then
    `iterations` WPE iterations. `idim` is the number of frequency bins
    (fft_size // 2 + 1), the port's own argument. The mask net's noise
    head is built, as in JAX, and unused."""

    def __init__(self, taps=5, delay=3, iterations=1, mask_hidden=256,
                 normalization=False, mask_flooring=False,
                 flooring_thres=1e-6, eps=1e-6, idim=257, generator=None):
        super().__init__()
        from cat_tpu_torch.front.beamformer import MaskNet

        self.taps, self.delay, self.iterations = taps, delay, iterations
        self.normalization, self.mask_flooring = normalization, mask_flooring
        self.flooring_thres, self.eps = flooring_thres, eps
        self.mask = MaskNet(mask_hidden, 2, idim, generator)

    def forward(self, spec, lengths):
        """spec (N, C, T, F) complex -> (dereverberated spec, mask (N, T,
        F))."""
        power = (spec.abs() ** 2).mean(1)
        mask, _ = self.mask(torch.log(torch.clamp_min(power, 1e-10)),
                            lengths)
        if self.mask_flooring:
            mask = torch.clamp_min(mask, self.flooring_thres)
        if self.normalization:
            mask = mask / torch.clamp_min(mask.sum(1, keepdim=True),
                                          self.eps)
        out = spec
        for _ in range(self.iterations):
            out = wpe_one_iteration(spec, power * mask, lengths, self.taps,
                                    self.delay, self.eps)
            power = (out.abs() ** 2).mean(1)
        return out, mask
