"""Neural LM trainer (counterpart of `cat_tpu/lm/train.py`).

The model is a decoder of the zoo with its LM head (`LSTMPredictor`,
`Embedding`, `CausalTransformer`); id 0 = <s> is both BOS and EOS.
`LmLoader` makes the JAX package's batches, seed for seed: inputs
[<s>, w1..wn], targets [w1..wn, </s>]. The loss is the token-mean
cross-entropy over the valid positions; a train step clips the global
gradient norm at 5 and steps the optimizer at the scheduler's lr
(`ctc/train.py` `make_step`, whose NaN/Inf guard it shares); the eval
step returns the summed token NLL and the token count, so the Manager's
dev metric is the ln-perplexity a token. `sentence_nll` scores whole
sentences in batches of similar length (no shape buckets: they only
bound XLA's compiles in the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

from cat_tpu_torch import models
from cat_tpu_torch.ctc.train import init_state, make_step  # noqa: F401
from cat_tpu_torch.utils.data import make_buckets
from cat_tpu_torch.utils.data_prep import check_device


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0):
    """cfg: {"decoder": {"type", "kwargs"}}; the LM head is switched on
    with num_classes outputs (vocab_size defaults to num_classes). Random
    weights from a generator seeded with `seed`; the model in eval mode on
    `device` (default "cuda")."""
    device = check_device(device)
    dec_cfg = cfg["decoder"]
    kw = dict(dec_cfg.get("kwargs", {}))
    kw.setdefault("vocab_size", num_classes)
    kw["num_classes"] = num_classes
    kw["with_head"] = True
    model = models.get_decoder(dec_cfg["type"])(
        **kw, generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


class LmLoader:
    """Bucketed batches over a `CorpusDataset`: (N, U) int32 token ids with
    lengths and unit weights; inputs get <s> prepended, targets get </s>
    (= 0) appended. The JAX package's batches, seed for seed."""

    def __init__(self, dataset, token_budget=8000, num_buckets=4,
                 max_len=512, shuffle=True, seed=0):
        self.ds = dataset
        n = len(dataset)
        self.lens = np.asarray([min(dataset.token_length(i) + 1, max_len)
                                for i in range(n)])
        self.indices = np.arange(n)
        self.buckets = make_buckets(self.lens, num_buckets, min_len=8)
        self.batch_sizes = [max(token_budget // e, 1) for e in self.buckets]
        self.shuffle = shuffle
        self.seed = seed
        self.max_len = max_len

    def bucket_of(self, L):
        for b, e in enumerate(self.buckets):
            if L <= e:
                return b
        return len(self.buckets) - 1

    def _collate(self, idxs, b):
        B, U = len(idxs), self.buckets[b]
        inputs = np.zeros((B, U), np.int32)
        targets = np.zeros((B, U), np.int32)
        lens = np.zeros((B,), np.int32)
        for j, i in enumerate(idxs):
            ids = np.asarray(self.ds[i])[: U - 1]
            L = len(ids) + 1
            inputs[j, 1:L] = ids          # [<s>, w1..wn]
            targets[j, :L - 1] = ids      # [w1..wn, </s> = 0]
            lens[j] = L
        return dict(tokens=inputs, targets=targets, lengths=lens,
                    weight=np.ones((B,), np.float32))

    def epoch(self, epoch_idx):
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = self.indices.copy()
        if self.shuffle:
            rng.shuffle(order)
        pools = [[] for _ in self.buckets]
        for i in order:
            b = self.bucket_of(self.lens[i])
            pools[b].append(i)
            if len(pools[b]) == self.batch_sizes[b]:
                yield self._collate(pools[b], b)
                pools[b] = []
        for b, pool in enumerate(pools):
            if pool:
                yield self._collate(pool, b)

    def __iter__(self):
        return self.epoch(0)


def token_nll(model, tokens, targets, lengths, gen=None):
    """(per-sequence NLL in nats (N,), valid-token count): the LM's
    log-softmax at the targets, summed over positions < length."""
    logits, _ = model(tokens, lengths, gen)
    lp = torch.log_softmax(logits.float(), -1)
    nll = -lp.gather(-1, targets.long()[..., None])[..., 0]
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
            < lengths[:, None])
    return torch.where(mask, nll, 0.0).sum(1), mask.sum()


def make_loss_fn(model):
    """loss_fn(batch, gen, train) -> (token-mean NLL, per-sequence NLL,
    {}): batch "tokens", "targets", "lengths" on the model's device."""

    def loss_fn(batch, gen, train):
        per_seq, count = token_nll(model, batch["tokens"], batch["targets"],
                                   batch["lengths"], gen if train else None)
        return per_seq.sum() / torch.clamp_min(count, 1), per_seq, {}

    return loss_fn


def make_train_step(model, optimizer, grad_clip=5.0):
    """train_step(state, batch, lr, gen) -> (state, {"loss", "grad_norm",
    "skipped"}), updating the model and the optimizer in place."""
    return make_step(model, optimizer, make_loss_fn(model), grad_clip)


def make_eval_step(model):
    """eval_step(state, batch) -> {"loss_sum": summed token NLL, "count":
    tokens}."""

    def eval_step(state, batch):
        model.eval()
        with torch.no_grad():
            per_seq, count = token_nll(model, batch["tokens"],
                                       batch["targets"], batch["lengths"])
        return {"loss_sum": per_seq.sum(), "count": count}

    return eval_step


def sentence_nll(model, id_sequences, batch_size=16, max_len=512):
    """Each sentence's NLL in nats (float64 numpy (n,)): <s> + ids
    (truncated to max_len - 1) scored with </s> at the end, in batches of
    sentences of similar length on the model's device."""
    dev = next(model.parameters()).device
    results = np.zeros(len(id_sequences), np.float64)
    order = np.argsort([len(s) for s in id_sequences], kind="stable")
    model.eval()
    for start in range(0, len(order), batch_size):
        idxs = order[start:start + batch_size]
        U = min(max(2, max(len(id_sequences[i]) for i in idxs) + 1),
                max_len)
        B = len(idxs)
        tokens = np.zeros((B, U), np.int64)
        targets = np.zeros((B, U), np.int64)
        lens = np.zeros((B,), np.int64)
        for j, i in enumerate(idxs):
            ids = np.asarray(id_sequences[i][: U - 1], np.int64)
            L = len(ids) + 1
            tokens[j, 1:L] = ids
            targets[j, :L - 1] = ids
            lens[j] = L
        to = lambda a: torch.from_numpy(a).to(dev)
        with torch.inference_mode():
            nll, _ = token_nll(model, to(tokens), to(targets), to(lens))
        results[idxs] = nll.double().cpu().numpy()
    return results


def perplexity(model, id_sequences):
    """exp(total NLL / tokens), each sentence counting its </s>."""
    nll = sentence_nll(model, id_sequences)
    tokens = sum(len(s) + 1 for s in id_sequences)
    return float(np.exp(nll.sum() / max(tokens, 1)))


def load_exp(expdir, device=None):
    """(LM, tokenizer) of a trained LM experiment of either package: the
    model of its config.json with the weights of its best checkpoint, on
    `device` (default "cuda"), in eval mode."""
    import os

    from cat_tpu_torch.pipeline.asr import load_json
    from cat_tpu_torch.utils import tokenizer as tknz
    from cat_tpu_torch.utils.checkpoint import CheckpointManager, model_weights

    hyper = load_json(os.path.join(expdir, "hyper-p.json"))
    config = load_json(os.path.join(expdir, "config.json"))
    tok = tknz.load(os.path.join(
        expdir, hyper["tokenizer"].get("file", "tokenizer.tknz")))
    model = build_model(config, num_classes=tok.vocab_size, device=device)
    ckpt = CheckpointManager(os.path.join(expdir, "check"))
    best = ckpt.best()
    if best is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt.dir}")
    model.load_state_dict(model_weights(model, ckpt.path(best)))
    return model, tok
