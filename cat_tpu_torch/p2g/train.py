"""LLM-P2G training and decoding (counterpart of `cat_tpu/p2g/train.py`).

`P2GSeq2Seq` maps phoneme ids to grapheme logits: an `EmbeddingEncoder`
without a head (float32, no batch normalisation, kernel 15; on the card
its feed-forward and attention run the f32 kernels) under a causal
`TransformerDecoder` with cross attention (plain PyTorch products; its
feed-forward's output dropout is the Philox `layers.Dropout`, a launch of
`csrc/dropout.cu` on the card).

Losses, per sequence: "ce" is the summed token NLL (with label smoothing
in training when it is set); "tkm" and "skm" run the model once over the
N·K candidates and take -log Σ_k softmax_k(s_k / t_weight)·p(y | x_k),
with s_k the candidates' scores ("skm" is "tkm"'s loss: its candidates
are sampled offline). A train step takes the weight-mean of the batch,
clips the global gradient norm at grad_clip (scale grad_clip / (norm +
1e-6)), sets the lr and steps the optimizer. It has no NaN/Inf guard,
as the JAX step has none (ROADMAP.md §C). bos = eos = 0, the
tokenizers' reserved id. Every random draw (the dropout seeds) comes from
the CPU `torch.Generator` passed to the step.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cat_tpu_torch.ctc.train import (_weighted_mean, global_grad_norm,
                                     init_state)  # noqa: F401
from cat_tpu_torch.models.decoders import TransformerDecoder
from cat_tpu_torch.models.encoders import EmbeddingEncoder
from cat_tpu_torch.utils.data_prep import check_device
from cat_tpu_torch.utils.scheduler import set_lr


class P2GSeq2Seq(nn.Module):
    """Encoder-decoder P2G: phoneme tokens -> grapheme logits."""

    def __init__(self, src_vocab, tgt_vocab, hdim=256, enc_layers=4,
                 dec_layers=4, num_heads=4, ff_dim=1024, dropout_rate=0.1,
                 generator=None):
        super().__init__()
        self.encoder = EmbeddingEncoder(
            vocab_size=src_vocab, num_cells=enc_layers, hdim=hdim,
            num_heads=num_heads, dropout_rate=dropout_rate, with_head=False,
            generator=generator)
        self.decoder = TransformerDecoder(
            vocab_size=tgt_vocab, hdim=hdim, num_layers=dec_layers,
            num_heads=num_heads, ff_dim=ff_dim, num_classes=tgt_vocab,
            dropout_rate=dropout_rate, causal=True, generator=generator)

    def encode(self, src, src_lens, gen=None):
        return self.encoder(src, src_lens, gen)[0]

    def decode(self, tgt_in, tgt_lens, memory, memory_lengths, gen=None):
        return self.decoder(tgt_in, tgt_lens, memory, memory_lengths, gen)[0]

    def forward(self, src, src_lens, tgt_in, tgt_lens, gen=None):
        return self.decode(tgt_in, tgt_lens, self.encode(src, src_lens, gen),
                           src_lens, gen)


def build_model(cfg: dict, src_vocab: int, tgt_vocab: int, device=None,
                seed: int = 0):
    """The `P2GSeq2Seq` of cfg["p2g"]["kwargs"], random weights from a
    generator seeded with `seed`, in eval mode on `device` (default
    "cuda")."""
    device = check_device(device)
    kw = dict(cfg.get("p2g", {}).get("kwargs", {}))
    model = P2GSeq2Seq(src_vocab, tgt_vocab, **kw,
                       generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def seq_logp(logits, tgt_out, tgt_lens):
    """Σ_u log p(y_u) over the first tgt_lens positions: (N, U, V) -> (N,)."""
    lp = torch.log_softmax(logits.float(), -1)
    tok = lp.gather(-1, tgt_out.long()[..., None])[..., 0]
    mask = (torch.arange(tgt_out.shape[-1], device=tok.device)[None, :]
            < tgt_lens[:, None])
    return torch.where(mask, tok, 0.0).sum(-1)


def _encode_cands(model, cands, cand_lens, gen=None):
    """(memory, lengths) of the N·K candidates (N, K, Tp) as one batch."""
    N, K, Tp = cands.shape
    lens = cand_lens.reshape(N * K)
    return model.encode(cands.reshape(N * K, Tp), lens, gen), lens


def _marginal_nll(model, memory, mem_lens, cand_scores, tgt_in, tgt_out,
                  tgt_lens, gen, t_weight):
    """-log Σ_k w_k p(y | x_k) from the candidates' memory: each of the
    N·K rows decodes its utterance's target."""
    N, K = cand_scores.shape
    rep = lambda a: a.repeat_interleave(K, dim=0)
    logits = model.decode(rep(tgt_in), rep(tgt_lens), memory, mem_lens, gen)
    lps = seq_logp(logits, rep(tgt_out), rep(tgt_lens)).view(N, K)
    logw = torch.log_softmax(cand_scores.float() / t_weight, -1)
    return -torch.logsumexp(logw + lps, -1)


def tkm_loss(model, cands, cand_lens, cand_scores, tgt_in, tgt_out, tgt_lens,
             gen=None, t_weight: float = 1.0):
    """-log Σ_k w_k p(y | x_k) per sequence, w = softmax(cand_scores /
    t_weight) over K: cands (N, K, Tp), cand_lens and cand_scores (N, K)
    (a padding candidate scores -1e30), tgt_* (N, U). The model runs once
    over the N·K candidates, each with its utterance's target."""
    memory, lens = _encode_cands(model, cands, cand_lens, gen)
    return _marginal_nll(model, memory, lens, cand_scores, tgt_in, tgt_out,
                         tgt_lens, gen, t_weight)


def batch_to_step(batch, bos=0, eos=0):
    """`Seq2SeqBatch` -> the step's dict of numpy arrays: tgt_in = [bos,
    y], tgt_out = [y, eos], tgt_lens + 1, the candidates when the batch
    has them (the `Manager`'s batch_transform of the P2G task)."""
    B = batch.tgt.shape[0]
    tgt_in = np.concatenate([np.full((B, 1), bos, np.int32), batch.tgt], 1)
    tgt_out = np.concatenate([batch.tgt, np.zeros((B, 1), np.int32)], 1)
    if eos != 0:
        tgt_out[np.arange(B), batch.tgt_lens] = eos
    d = dict(src=batch.src, src_lens=batch.src_lens, tgt_in=tgt_in,
             tgt_out=tgt_out, tgt_lens=batch.tgt_lens + 1,
             weight=batch.weight)
    if batch.cands is not None:
        d.update(cands=batch.cands, cand_lens=batch.cand_lens,
                 cand_scores=batch.cand_scores)
    return d


def make_per_seq_fn(model, mode="ce", t_weight=1.0, label_smoothing=0.0):
    """per_seq(batch, gen, train) -> (N,) NLL of mode "ce", "tkm" or "skm";
    the label smoothing applies in training only. The caller sets the
    model's mode."""

    def per_seq(batch, gen, train):
        gen = gen if train else None
        if mode in ("tkm", "skm"):
            return tkm_loss(model, batch["cands"], batch["cand_lens"],
                            batch["cand_scores"], batch["tgt_in"],
                            batch["tgt_out"], batch["tgt_lens"], gen,
                            t_weight)
        logits = model(batch["src"], batch["src_lens"], batch["tgt_in"],
                       batch["tgt_lens"], gen)
        if train and label_smoothing > 0:
            V = logits.shape[-1]
            lp = torch.log_softmax(logits.float(), -1)
            tok = lp.gather(-1, batch["tgt_out"].long()[..., None])[..., 0]
            nll = -((1 - label_smoothing) * tok
                    + label_smoothing / V * lp.sum(-1))
            mask = (torch.arange(nll.shape[1], device=nll.device)[None, :]
                    < batch["tgt_lens"][:, None])
            return torch.where(mask, nll, 0.0).sum(-1)
        return -seq_logp(logits, batch["tgt_out"], batch["tgt_lens"])

    return per_seq


def make_train_step(model, optimizer, mode="ce", t_weight=1.0,
                    label_smoothing=0.0, grad_clip=5.0):
    """train_step(state, batch, lr, gen) -> (state, {"loss", "grad_norm"}),
    updating the model and the optimizer in place; batch as
    `batch_to_step` makes it, on the model's device."""
    per_seq_fn = make_per_seq_fn(model, mode, t_weight, label_smoothing)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state, batch, lr, gen):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = _weighted_mean(per_seq_fn(batch, gen, True), batch["weight"])
        loss.backward()
        gnorm = global_grad_norm(params)
        if grad_clip > 0:
            scale = torch.clamp_max(grad_clip / (gnorm + 1e-6), 1.0)
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        set_lr(optimizer, lr)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_eval_step(model, mode="ce", t_weight=1.0):
    """eval_step(state, batch) -> {"loss_sum": Σ w·NLL, "count": Σ w}."""
    per_seq_fn = make_per_seq_fn(model, mode, t_weight)

    def eval_step(state, batch):
        model.eval()
        with torch.no_grad():
            per_seq = per_seq_fn(batch, None, False)
        w = batch["weight"]
        return {"loss_sum": (per_seq * w).sum(), "count": w.sum()}

    return eval_step


def danp_expand(utterances, nbest, k=None):
    """DANP: one training example per (noisy phoneme hypothesis,
    transcript). utterances: (uid, grapheme ids) pairs; nbest: {uid:
    [(score, phoneme ids)]}. Returns [(uid, phoneme ids, grapheme ids)]
    over each utterance's best k hypotheses (all of them when k is
    None)."""
    out = []
    for uid, gids in utterances:
        hyps = nbest.get(uid, [])
        if k is not None:
            hyps = sorted(hyps, key=lambda x: -x[0])[:k]
        for _, pids in hyps:
            out.append((uid, list(pids), list(gids)))
    return out


@torch.inference_mode()
def greedy_generate(model, src, src_lens, bos=0, eos=0, max_len=64):
    """Greedy decoding of a batch (the model in eval mode): the source
    encoded once; step u decodes the whole buffer [bos, y_1 .. y_max_len]
    without a length mask and takes the argmax at u; a row is done at eos
    and emits eos after it. Returns (tokens (N, max_len), lengths: the
    index of the first eos, or max_len)."""
    model.eval()
    memory = model.encode(src, src_lens)
    N = src.shape[0]
    tokens = torch.full((N, max_len + 1), bos, dtype=torch.long,
                        device=src.device)
    done = torch.zeros(N, dtype=torch.bool, device=src.device)
    for u in range(max_len):
        logits = model.decode(tokens[:, :-1], None, memory, src_lens)
        nxt = torch.where(done, eos, logits[:, u].argmax(-1))
        done |= nxt == eos
        tokens[:, u + 1] = nxt
        if bool(done.all()):  # every later step emits eos
            tokens[:, u + 2:] = eos
            break
    out = tokens[:, 1:]
    is_eos = out == eos
    lengths = torch.where(is_eos.any(1), is_eos.int().argmax(1),
                          torch.full_like(done, max_len, dtype=torch.long))
    return out, lengths


@torch.inference_mode()
def marginalized_rescore(model, cands, cand_lens, cand_scores, hyps,
                         hyp_lens, bos=0, t_weight=1.0):
    """TKM decoding's rescoring: each grapheme hypothesis y_j (hyps (N, J,
    U), no bos) scored by log Σ_k w_k p(y_j | x_k) over the candidates ->
    (N, J). The candidates are encoded once for every j."""
    model.eval()
    N, J, U = hyps.shape
    tgt_in = torch.cat([torch.full((N, J, 1), bos, dtype=hyps.dtype,
                                   device=hyps.device), hyps[..., :-1]], -1)
    memory, lens = _encode_cands(model, cands, cand_lens)
    return torch.stack([-_marginal_nll(model, memory, lens, cand_scores,
                                       tgt_in[:, j], hyps[:, j],
                                       hyp_lens[:, j], None, t_weight)
                        for j in range(J)], 1)


def marginalized_decode(model, cands, cand_lens, cand_scores, max_len=64,
                        t_weight=1.0):
    """TKM decoding: a greedy hypothesis from each of the K candidates (all
    N·K in one batch), each rescored by `marginalized_rescore`. Returns
    (hyps (N, K, max_len), their lengths (N, K), scores (N, K)); an
    utterance's decoding is its best-scored hypothesis."""
    N, K, Tp = cands.shape
    hyps, lens = greedy_generate(model, cands.reshape(N * K, Tp),
                                 cand_lens.reshape(N * K), max_len=max_len)
    hyps, lens = hyps.view(N, K, -1), lens.view(N, K)
    return hyps, lens, marginalized_rescore(model, cands, cand_lens,
                                            cand_scores, hyps, lens,
                                            t_weight=t_weight)
