"""Chunk-based multichannel end-to-end CTC, ME2E-CUSIDE (counterpart of
`cat_tpu/ctc/train_me2e_chunk.py`).

The STFT's time axis is windowed with left and right context
(`ctc.streaming.make_chunks`, one gather), each window is beamformed on
its own by the front end's `enhance` and encoded as one batch of N·C
windows, and the middle chunk's outputs are concatenated. The future
frames of a window are the SimuNet's prediction from the chunk's log-mel
("simu"), zeros ("none") or the real ones ("real", an oracle for
training). chunk, left and right count STFT frames.

The objective is (1 − λ)·CTC(full) + λ·CTC(chunk) + λ_simu·L1, each CTC
term a weighted mean over the batch; the simulator's L1 target is the
real next frames' log-mel, beamformed alone without gradient. The
running statistics of a step are the chunk pass's (`two_passes`). The
step has the ME2E guard of `train_me2e` (ROADMAP.md caveat C.16).
"""
from __future__ import annotations

import torch
from torch import nn

from cat_tpu_torch.ctc.streaming import (FUTURES, SimuNet, make_chunks,
                                         two_passes)
from cat_tpu_torch.ctc.train_me2e import (batch_wave, build_parts,
                                          init_state,  # noqa: F401
                                          make_guarded_step)
from cat_tpu_torch.ops.ctc import ctc_loss
from cat_tpu_torch.utils.data_prep import check_device


class ChunkMe2eModel(nn.Module):
    """Beamformer + encoder with a full-context (`full_forward`, also
    `forward`) and a chunked (`chunk_forward`) operation."""

    def __init__(self, frontend, encoder, simu=None, chunk=64, left=64,
                 right=16):
        super().__init__()
        self.frontend = frontend
        self.encoder = encoder
        self.simu = simu
        self.chunk, self.left, self.right = chunk, left, right

    def full_forward(self, wave, wave_lengths, gen=None):
        feats, flens = self.frontend(wave, wave_lengths)
        return self.encoder(feats, flens, gen)

    forward = full_forward

    def chunk_forward(self, wave, wave_lengths, gen=None, future="simu"):
        """Chunked beamforming and encoding -> (logits (N, C·width, V),
        output lengths, simu_l1).

        Each window's spectrum beyond its chunk is zeroed unless future is
        "real"; its valid length for the masks is left + chunk, plus right
        unless future is "simu". Every window is encoded at its full length
        `win`; with r = win // T'_win, the outputs left // r .. left // r
        + chunk // r − 1 are kept, and the output lengths are min(ceil(
        frames / r), C·width), the JAX package's formula. simu_l1 (0 unless
        future is "simu") is the mean |predicted − real| log-mel over every
        future frame of every window; the encoder reads the prediction
        detached."""
        if future not in FUTURES:
            raise ValueError(f"future {future!r} is not one of {FUTURES}")
        spec, flens = self.frontend.spectrum(wave, wave_lengths)
        N, Ch, T, F = spec.shape
        flat = spec.permute(0, 2, 1, 3).reshape(N, T, Ch * F)
        windows, C = make_chunks(flat, self.chunk, self.left, self.right)
        mid = self.left + self.chunk
        if future != "real":
            windows = torch.cat([windows[:, :, :mid],
                                 torch.zeros_like(windows[:, :, mid:])], 2)
        win = mid + self.right
        dev = wave.device
        wspec = windows.reshape(N * C, win, Ch, F).permute(0, 2, 1, 3)
        use_right = 0 if future == "simu" else self.right
        wlens = torch.full((N * C,), mid + use_right, dtype=torch.long,
                           device=dev)
        feats = self.frontend.enhance(wspec, wlens)[0]     # (N·C, win, B)
        simu_l1 = torch.zeros((), device=dev)
        if future == "simu" and self.simu is not None:
            pred = self.simu(feats[:, self.left:mid])      # (N·C, right, B)
            real = make_chunks(flat, self.chunk, 0, self.right)[0]
            real = real[:, :, self.chunk:].reshape(N * C, self.right, Ch, F)
            with torch.no_grad():
                rfeats = self.frontend.enhance(
                    real.permute(0, 2, 1, 3), torch.full(
                        (N * C,), self.right, dtype=torch.long,
                        device=dev))[0]
            simu_l1 = (pred - rfeats).abs().mean()
            feats = torch.cat([feats[:, :mid], pred.detach()], 1)
        enc, _ = self.encoder(feats, torch.full((N * C,), win,
                                                dtype=torch.long, device=dev),
                              gen)
        r = max(win // max(enc.shape[1], 1), 1)
        lo, width = self.left // r, self.chunk // r
        out = enc[:, lo:lo + width].reshape(N, C * width, enc.shape[-1])
        return out, torch.clamp_max(-(-flens // r), C * width), simu_l1


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0,
                kaldi: bool = False) -> ChunkMe2eModel:
    """The `ChunkMe2eModel` of cfg's "frontend", "encoder" and "unified"
    blocks: chunk (64), left_context (chunk), right_context (16) and a
    SimuNet of the front end's num_bins and simu_hidden (128); random
    weights from `seed`, in eval mode on `device` ("cuda" by default)."""
    device = check_device(device)
    gen = torch.Generator().manual_seed(seed)
    frontend, encoder = build_parts(cfg, num_classes, gen, kaldi)
    u = cfg.get("unified", {})
    chunk = u.get("chunk", 64)
    right = u.get("right_context", 16)
    simu = SimuNet(frontend.num_bins, u.get("simu_hidden", 128), right,
                   generator=gen)
    return ChunkMe2eModel(frontend, encoder, simu, chunk,
                          u.get("left_context", chunk), right).to(
        device).eval()


def make_loss_fn(model: ChunkMe2eModel, lamb_chunk=0.5, lamb_simu=1.0,
                 future="simu", channels_last=False):
    """loss_fn(batch, gen, train) -> (loss, per-sequence joint CTC loss,
    {"utt_loss", "chunk_loss", "simu_l1"}): the per-sequence loss is
    (1 − λ)·nll_full + λ·nll_chunk; the loss its weighted mean plus
    λ_simu·simu_l1; utt_loss and chunk_loss the plain means of the two
    nll's. The caller sets the model's mode."""

    def loss_fn(batch, gen, train):
        wave, wlens = batch_wave(batch, channels_last), batch["feat_lengths"]
        g = gen if train else None
        (f_logits, f_lens), (c_logits, c_lens, simu_l1) = two_passes(
            model, lambda: model.full_forward(wave, wlens, g),
            lambda: model.chunk_forward(wave, wlens, g, future), train)
        labels, llens = batch["labels"], batch["label_lengths"]

        def nll(logits, lens):
            lp = torch.log_softmax(logits.float(), dim=-1)
            return ctc_loss(lp, labels, lens, llens, reduction="none")

        nll_full, nll_chunk = nll(f_logits, f_lens), nll(c_logits, c_lens)
        per_seq = (1.0 - lamb_chunk) * nll_full + lamb_chunk * nll_chunk
        w = batch["weight"].float()
        loss = (per_seq * w).sum() / torch.clamp_min(w.sum(), 1.0) \
            + lamb_simu * simu_l1
        return loss, per_seq, {"utt_loss": nll_full.mean(),
                               "chunk_loss": nll_chunk.mean(),
                               "simu_l1": simu_l1}

    return loss_fn


def make_train_step(model, optimizer, grad_clip=5.0, lamb_chunk=0.5,
                    lamb_simu=1.0, future="simu", channels_last=False,
                    **_unused):
    """Returns train_step(state, batch, lr, gen) -> (state, metrics "loss",
    "grad_norm", "utt_loss", "chunk_loss", "simu_l1", "skipped")."""
    return make_guarded_step(model, optimizer, make_loss_fn(
        model, lamb_chunk, lamb_simu, future, channels_last), grad_clip)


def make_eval_step(model, lamb_chunk=0.5, future="simu", channels_last=False,
                   **_unused):
    """Returns eval_step(state, batch) -> {"loss_sum", "count"} of the
    per-sequence joint loss (λ_simu = 0)."""
    loss_fn = make_loss_fn(model, lamb_chunk, 0.0, future, channels_last)

    def eval_step(state, batch):
        model.eval()
        with torch.no_grad():
            _, per_seq, _ = loss_fn(batch, None, False)
        w = batch["weight"].float()
        return {"loss_sum": (per_seq * w).sum(), "count": w.sum()}

    return eval_step


def bf_chunk_infer(model: ChunkMe2eModel, wave, wave_lengths, future="simu"):
    """Streaming inference: the chunk pass in eval mode -> (logits,
    output lengths)."""
    model.eval()
    with torch.inference_mode():
        out, out_lens, _ = model.chunk_forward(wave, wave_lengths, None,
                                               future)
    return out, out_lens
