"""CUSIDE streaming: chunked encoding with a simulated future context
(counterpart of `cat_tpu/ctc/streaming.py`).

- `make_chunks`: (N, T, F) -> windows (N, C, left + chunk + right, F) by
  one gather over a fixed index grid, frames out of range zero.
- `SimuNet`: a GRU over a chunk's frames; its last state through a dense
  layer predicts the `right` frames after the chunk.
- `UnifiedEncoder`: an encoder run on whole utterances (`full_forward`)
  and on the windows of every chunk as one batch (`chunk_forward`), whose
  future frames are the simulated ones ("simu"), zeros ("none") or the
  real ones ("real"); the middle `chunk` frames' outputs of every window
  are concatenated.
- `make_unified_loss_fn`: (1 − λ)·CTC(full) + λ·CTC(chunk) + λ_simu·L1.
- `chunk_infer`: streaming inference, the chunk pass in eval mode.

The running statistics of a training step are those of the chunk pass,
taken from the statistics both passes start from (JAX keeps the chunk
pass's batch_stats): `two_passes` restores the buffers after the full
pass. The GRU is `torch.nn.GRU` with its recurrent r and z biases held
at zero (flax's `GRUCell` has none); it and the dense layer compute in
float32, as in JAX, outside any kernel of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from cat_tpu_torch.ctc.train import _restore, _weighted_mean
from cat_tpu_torch.models.layers import Dense
from cat_tpu_torch.ops.ctc import ctc_loss

FUTURES = ("simu", "none", "real")


def make_chunks(feats, chunk: int, left: int, right: int):
    """(N, T, F) -> (windows (N, C, left + chunk + right, F), C), C =
    ceil(T / chunk); window c holds frames c·chunk − left .. c·chunk +
    chunk + right − 1, zero where out of range."""
    N, T, F = feats.shape
    C = -(-T // chunk)
    win = left + chunk + right
    dev = feats.device
    idx = (torch.arange(C, device=dev)[:, None] * chunk - left
           + torch.arange(win, device=dev)[None, :])          # (C, win)
    valid = (idx >= 0) & (idx < T)
    g = feats[:, idx.clamp(0, T - 1)]                        # (N, C, win, F)
    return torch.where(valid[None, :, :, None], g, 0.0), C


class SimuNet(nn.Module):
    """GRU future-frame simulator: (B, chunk, F) -> predicted (B, right, F).
    `gru` is flax's `GRUCell` in `torch.nn.GRU`'s layout: gates (r, z, n),
    n = tanh(W_in x + b_in + r·(W_hn h + b_hn)), h' = (1 − z)·n + z·h,
    with b_hr = b_hz = 0 (their gradient is zeroed, so an optimizer
    without weight decay on a zero keeps them there)."""

    def __init__(self, feat_dim, hidden=256, right=16, generator=None):
        super().__init__()
        self.feat_dim, self.hidden, self.right = feat_dim, hidden, right
        self.gru = nn.GRU(feat_dim, hidden, batch_first=True)
        self.out = Dense(hidden, right * feat_dim)
        self.gru.bias_hh_l0.register_hook(lambda g: torch.cat(
            [torch.zeros_like(g[:2 * hidden]), g[2 * hidden:]]))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's defaults: input kernels normal of variance 1/fan_in,
        recurrent kernels orthogonal per gate, biases zero."""
        H, F = self.hidden, self.feat_dim
        g = self.gru
        g.weight_ih_l0.copy_(torch.randn(3 * H, F, generator=generator)
                             / F ** 0.5)
        for k in range(3):
            q, _ = torch.linalg.qr(torch.randn(H, H, generator=generator))
            g.weight_hh_l0[k * H:(k + 1) * H] = q
        g.bias_ih_l0.zero_()
        g.bias_hh_l0.zero_()
        self.out.kernel.copy_(torch.randn(self.out.kernel.shape,
                                          generator=generator) / H ** 0.5)
        self.out.bias.zero_()

    def forward(self, x):
        h, _ = self.gru(x.float())
        out = self.out(h[:, -1], torch.float32)
        return out.view(-1, self.right, self.feat_dim)


class UnifiedEncoder(nn.Module):
    """An encoder for joint full-context and chunked operation; `forward`
    is `full_forward`."""

    def __init__(self, encoder, simu=None, chunk=64, left=64, right=16):
        super().__init__()
        self.encoder = encoder
        self.simu = simu
        self.chunk, self.left, self.right = chunk, left, right

    def full_forward(self, feats, lengths, gen=None):
        return self.encoder(feats, lengths, gen)

    forward = full_forward

    def chunk_forward(self, feats, lengths, gen=None, future="simu"):
        """Chunked encoding -> (out (N, C·width, ·), out_lengths, simu_l1).

        Every window is encoded at its full length `win`; with r = win //
        T'_win (the encoder's subsampling), the outputs left // r ..
        left // r + chunk // r − 1 of each window are kept. out_lengths =
        min(ceil(len / r), C·width), the JAX package's formula. simu_l1
        is the mean |predicted − real| over every future frame of every
        window (the zero-padded ones after the last frame too), 0 unless
        future is "simu"; the encoder reads the prediction detached, so
        the simulator learns from its L1 alone."""
        if future not in FUTURES:
            raise ValueError(f"future {future!r} is not one of {FUTURES}")
        N, _, F = feats.shape
        windows, C = make_chunks(feats.float(), self.chunk, self.left,
                                 self.right)
        win = self.left + self.chunk + self.right
        mid = self.left + self.chunk
        simu_l1 = torch.zeros((), device=feats.device)
        if future == "none":
            windows = torch.cat([windows[:, :, :mid],
                                 torch.zeros_like(windows[:, :, mid:])], 2)
        elif future == "simu" and self.simu is not None:
            pred = self.simu(windows[:, :, self.left:mid].reshape(
                N * C, self.chunk, F))
            real = windows[:, :, mid:].reshape(N * C, self.right, F)
            simu_l1 = (pred - real).abs().mean()
            windows = torch.cat([windows[:, :, :mid], pred.detach().view(
                N, C, self.right, F)], 2)
        flat = windows.reshape(N * C, win, F)
        flat_lens = torch.full((N * C,), win, dtype=torch.long,
                               device=feats.device)
        enc, _ = self.encoder(flat, flat_lens, gen)
        r = max(win // enc.shape[1], 1) if enc.shape[1] else 1
        lo, width = self.left // r, self.chunk // r
        out = enc[:, lo:lo + width].reshape(N, C * width, enc.shape[-1])
        out_lengths = torch.clamp_max(-(-lengths.to(feats.device) // r),
                                      C * width)
        return out, out_lengths, simu_l1


def build_unified(encoder, cfg: dict, generator=None) -> UnifiedEncoder:
    """`encoder` wrapped with the config's "unified" block: chunk (64),
    left_context (chunk), right_context (16) and a SimuNet of feat_dim
    (80) and simu_hidden (256)."""
    u = cfg.get("unified", {})
    chunk = u.get("chunk", 64)
    right = u.get("right_context", 16)
    simu = SimuNet(u.get("feat_dim", 80), u.get("simu_hidden", 256), right,
                   generator=generator)
    return UnifiedEncoder(encoder, simu, chunk, u.get("left_context", chunk),
                          right)


def two_passes(model, full, chunk, train):
    """(full(), chunk()) where, in training, the running statistics after
    the call are the chunk pass's own update of the statistics both passes
    started from (JAX's `vars2 or vars1`)."""
    if not train:
        return full(), chunk()
    start = [b.detach().clone() for b in model.buffers()]
    out_full = full()
    _restore(model, start)
    return out_full, chunk()


def make_unified_loss_fn(model: UnifiedEncoder, lamb_chunk=0.5, lamb_simu=1.0,
                         future="simu"):
    """Returns loss_fn(batch, gen, train) -> (loss, (loss_full, loss_chunk,
    simu_l1)): (1 − λ)·CTC(full) + λ·CTC(chunk) + λ_simu·L1, each CTC term
    a weighted mean over the batch. The batch's features are used as they
    are (the trainer applies SpecAugment); the caller sets the mode."""

    def loss_fn(batch, gen, train):
        feats, flens = batch["feats"], batch["feat_lengths"]
        g = gen if train else None
        (f_logits, f_lens), (c_logits, c_lens, simu_l1) = two_passes(
            model, lambda: model.full_forward(feats, flens, g),
            lambda: model.chunk_forward(feats, flens, g, future), train)
        labels, llens = batch["labels"], batch["label_lengths"]
        w = batch["weight"].float()

        def ctc(logits, lens):
            lp = torch.log_softmax(logits.float(), dim=-1)
            return _weighted_mean(ctc_loss(lp, labels, lens, llens,
                                           reduction="none"), w)

        loss_full, loss_chunk = ctc(f_logits, f_lens), ctc(c_logits, c_lens)
        loss = ((1 - lamb_chunk) * loss_full + lamb_chunk * loss_chunk
                + lamb_simu * simu_l1)
        return loss, (loss_full, loss_chunk, simu_l1)

    return loss_fn


def chunk_infer(model: UnifiedEncoder, feats, lengths, future="simu"):
    """Fixed-chunk streaming inference: the chunk pass in eval mode ->
    (out, out_lengths)."""
    model.eval()
    with torch.inference_mode():
        out, out_lens, _ = model.chunk_forward(feats, lengths, None, future)
    return out, out_lens
