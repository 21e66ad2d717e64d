"""Multichannel end-to-end decoding: the beamforming front end and the
encoder, then CTC search (counterpart of `cat_tpu/ctc/decode_me2e.py`).

Offline mode runs the whole utterance through the model; streaming mode
runs a chunk model's chunk pass (`train_me2e_chunk.bf_chunk_infer`). The
search is greedy at beam width <= 1, else the batched prefix beam on the
log-probs' device (`ctc/decode_device.py`).
"""
from __future__ import annotations

import time

import numpy as np
import torch


def make_me2e_decoder(model, mode="offline", beam_width=8, future="simu",
                      beta=0.0, channels_last=False):
    """Returns decode(wave (N, C, L), wave_lengths, nbest=1, max_len=128)
    -> per utterance [(score, [token ids])], best first. The wave arrives
    (N, L, C) with `channels_last` (the packed layout); numpy or tensors,
    moved to the model's device."""
    from cat_tpu_torch.ctc.decode import greedy_decode
    from cat_tpu_torch.ctc.decode_device import ctc_beam_search_device
    from cat_tpu_torch.ctc.train_me2e_chunk import bf_chunk_infer

    if mode not in ("offline", "streaming"):
        raise ValueError(f"mode {mode!r} is not 'offline' or 'streaming'")
    dev = next(model.parameters()).device

    def log_probs(wave, wlens):
        wave = torch.as_tensor(wave, dtype=torch.float32).to(dev)
        wlens = torch.as_tensor(wlens).long().to(dev)
        if channels_last:
            wave = wave.transpose(1, 2)
        if mode == "streaming":
            logits, olens = bf_chunk_infer(model, wave, wlens, future)
        else:
            model.eval()
            with torch.inference_mode():
                logits, olens = model(wave, wlens)
        return torch.log_softmax(logits.float(), -1), olens

    def decode(wave, wave_lengths, nbest=1, max_len=128):
        lp, olens = log_probs(wave, wave_lengths)
        if beam_width <= 1:
            return [[(0.0, list(s))] for s in greedy_decode(lp, olens)]
        prefixes, plens, scores = ctc_beam_search_device(
            lp, olens, beam_width=beam_width, max_len=max_len, beta=beta)
        prefixes, plens = prefixes.cpu().numpy(), plens.cpu().numpy()
        scores = scores.cpu().numpy()
        return [[(float(scores[n, k]),
                  [int(t) for t in prefixes[n, k, :plens[n, k]]])
                 for k in range(min(nbest, prefixes.shape[1]))]
                for n in range(prefixes.shape[0])]

    decode.log_probs = log_probs
    return decode


def decode_scp(model, utterances, tokenizer, mode="offline", beam_width=8,
               future="simu", batch_size=4, sample_rate=16000):
    """Decode a list of (uid, wave (C, L)) pairs, shortest first in batches
    of `batch_size` -> ({uid: text}, real-time factor)."""
    dec = make_me2e_decoder(model, mode, beam_width, future)
    hyps, audio_s = {}, 0.0
    t0 = time.time()
    order = sorted(range(len(utterances)),
                   key=lambda i: utterances[i][1].shape[-1])
    for s in range(0, len(order), batch_size):
        idxs = order[s:s + batch_size]
        C = utterances[idxs[0]][1].shape[0]
        L = max(utterances[i][1].shape[-1] for i in idxs)
        wave = np.zeros((len(idxs), C, L), np.float32)
        lens = np.zeros((len(idxs),), np.int64)
        for j, i in enumerate(idxs):
            w = utterances[i][1]
            wave[j, :, :w.shape[-1]] = w
            lens[j] = w.shape[-1]
            audio_s += w.shape[-1] / sample_rate
        res = dec(wave, lens)
        for j, i in enumerate(idxs):
            hyps[utterances[i][0]] = tokenizer.decode(res[j][0][1])
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return hyps, (time.time() - t0) / max(audio_s, 1e-6)
