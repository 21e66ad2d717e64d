"""JSA-SPG cascade decoding: speech -> phonemes -> graphemes (counterpart
of `cat_tpu/ctc/decode_jsa.py`).

`JsaCascadeDecoder` takes an utterance's S2P phoneme n-best (num_z
sequences by prefix beam), runs each through P2G (repeated `upsample`
times) and ranks the grapheme sequences of the P2G n-bests by the summed
scores: marginalised over the phoneme n-best (log-sum-exp) or the best
path. The forwards run on the models' device (the card: the S2P kernels
in bf16, P2G's f32 routes), one utterance at a time; the beams run on
the host, as in JAX. `times` accumulates the seconds of each: "device"
(the forwards, up to the log-probabilities on the host) and "host" (the
beams).
"""
from __future__ import annotations

import math
import time
from collections import defaultdict

import numpy as np
import torch

from cat_tpu_torch.ctc.decode import prefix_beam_search


def _lae(a, b):
    if a <= -1e29:
        return b
    if b <= -1e29:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


class JsaCascadeDecoder:
    """S2P -> P2G cascade with marginalisation over the phoneme n-best;
    s2p and p2g are the port's models, in eval mode."""

    def __init__(self, s2p, p2g, upsample=2, s2p_beam=8, p2g_beam=8,
                 num_z=4):
        self.s2p, self.p2g = s2p, p2g
        self.upsample = upsample
        self.s2p_beam = s2p_beam
        self.p2g_beam = p2g_beam
        self.num_z = num_z
        self.times = {"device": 0.0, "host": 0.0}

    def _log_probs(self, net, x, length):
        """(T', V) numpy log-probabilities and T' of one input."""
        t0 = time.perf_counter()
        dev = next(net.parameters()).device
        with torch.no_grad():
            logits, olen = net(x.to(dev), torch.tensor([length], device=dev))
            lp = torch.log_softmax(logits.float(), -1)[0].cpu().numpy()
        self.times["device"] += time.perf_counter() - t0
        return lp, int(olen[0])

    def _beam(self, lp, length, width):
        t0 = time.perf_counter()
        out = prefix_beam_search(lp, length, beam_width=width,
                                 nbest=self.num_z)
        self.times["host"] += time.perf_counter() - t0
        return out

    def decode_s2p(self, feats, flens):
        """Phoneme n-best of one utterance: [(score, ids)]."""
        x = torch.tensor(feats[None], dtype=torch.float32)
        return self._beam(*self._log_probs(self.s2p, x, flens),
                          self.s2p_beam)

    def decode(self, feats, flens, marginalize=True):
        """The grapheme hypotheses of one utterance, best first: [(score,
        ids)]. marginalize: score(y) = logsumexp_z [s2p(z|x) + p2g(y|z)]
        over the phoneme n-best; otherwise the best path."""
        y_scores: dict = defaultdict(lambda: -1e30)
        for z_score, z in self.decode_s2p(feats, flens):
            if not z:
                continue
            z_up = torch.from_numpy(np.repeat(np.asarray(z, np.int64),
                                              self.upsample)[None])
            for y_score, y in self._beam(*self._log_probs(
                    self.p2g, z_up, z_up.shape[1]), self.p2g_beam):
                total = z_score + y_score
                key = tuple(y)
                if marginalize:
                    y_scores[key] = _lae(y_scores[key], total)
                else:
                    y_scores[key] = max(y_scores[key], total)
        ranked = sorted(y_scores.items(), key=lambda kv: -kv[1])
        return [(s, list(y)) for y, s in ranked]
