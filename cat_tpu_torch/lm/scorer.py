"""Neural-LM fusion scorer: log10 p(token | context) (counterpart of
`cat_tpu/lm/scorer.py`).

The host beam searches (the CTC prefix beam, `RNNTBeamDecoder`) ask for
logp(context, token) at every expansion. One LM forward on the LM's
device for each distinct context gives the whole next-token distribution,
which is memoised, so the tokens of one context cost one forward and one
row copied to the host. `forwards` counts the forwards (the cache
misses). The search is host-paced by design: one small forward and one
copy per context.
"""
from __future__ import annotations

import math

import torch

LN10 = math.log(10.0)


class NeuralLMScorer:
    """A causal LM of `lm.train.build_model` (model(tokens, lengths) ->
    (logits, lengths); id 0 = <s>) as a fusion scorer."""

    def __init__(self, model, bos=0, max_cache=100000):
        self.model = model.eval()
        self.bos = bos
        self.max_cache = max_cache
        self.forwards = 0
        self._cache = {}
        self._dev = next(model.parameters()).device

    def dist(self, context):
        """log10 of the next-token distribution after `context` (a tuple of
        token ids), a float32 numpy row."""
        ctx = tuple(int(t) for t in context)
        hit = self._cache.get(ctx)
        if hit is not None:
            return hit
        seq = torch.tensor([(self.bos,) + ctx], device=self._dev)
        with torch.inference_mode():
            logits, _ = self.model(seq, torch.tensor([seq.shape[1]],
                                                     device=self._dev))
            lp = torch.log_softmax(logits[0, -1].float(), -1)
        self.forwards += 1
        row = lp.cpu().numpy() / LN10
        if len(self._cache) < self.max_cache:
            self._cache[ctx] = row
        return row

    def logp(self, context, tok):
        """log10 p(tok | context): the interface of `fst.ngram.NGramLM`
        and `rnnt.decode.CombinedLM`."""
        return float(self.dist(context)[int(tok)])
