"""JSA-SPG: joint speech-phoneme-grapheme training with MIS sampling
(counterpart of `cat_tpu/ctc/train_jsa.py`).

Three CTC models in one `JsaModel`: S2P (speech -> phonemes z), P2G
(phonemes -> graphemes y) and G2P (graphemes -> phonemes, the proposal
q(z|y)). A train step draws each utterance's z by Metropolis
independence sampling (`JsaTrainer.sample_z`): a proposal from the G2P
n-best (`ctc/decode.py prefix_beam_search`, the host beam over one
forward on the device), weighed by log p_s2p(z|x) + log p_p2g(y|z) -
log q(z) against the utterance's cached sample, accepted or not with a
numpy `default_rng(0)`, as the JAX trainer seeds it, so that both packages
make the same draws from the same scores. With supervised phonemes
(`supervised_z`, uid -> ids) an utterance takes them instead. Token inputs
are repeated `upsample` times (CTC needs input longer than output). Then
the three CTC losses, each the weight-masked mean over the batch, summed;
one Adam over all three models, the global-norm clip min(1, 5 / (|g| +
1e-6)) and the scheduler's lr. As in JAX there is no NaN/Inf guard, and
the sampler's cache is not checkpointed: a resumed run starts with an
empty cache.

The forwards run on the models' device: on the card the S2P conformer
takes the bf16 kernels, the token encoders (`EmbeddingEncoder`) the f32
routes of the FF and attention kernels, every CTC loss the CTC kernels;
the sampler's forwards run in eval mode, one utterance at a time. Dropout
seeds come from the caller's `torch.Generator`.

Where the JAX trainer keeps only the models' params (its TrainState has no
batch_stats), so that a batch-normalised S2P (jsa-spg's ConformerNet)
raises in its eval forward there, the port's S2P keeps its running
statistics, updated in the train step as in the ASR trainer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch
from torch import nn

from cat_tpu_torch import models
from cat_tpu_torch.ctc.decode import greedy_decode, prefix_beam_search
from cat_tpu_torch.ctc.train import global_grad_norm
from cat_tpu_torch.ops.ctc import ctc_loss
from cat_tpu_torch.utils.manager import TrainState
from cat_tpu_torch.utils.scheduler import set_lr

GRAD_CLIP = 5.0


class JsaModel(nn.Module):
    """The three models of JSA-SPG, so that the port's `TrainState`,
    `Manager`, checkpoints and averaging take them as one module."""

    def __init__(self, s2p, p2g, g2p):
        super().__init__()
        self.s2p, self.p2g, self.g2p = s2p, p2g, g2p


def build_models(cfg: dict, num_phonemes: int, num_graphemes: int,
                 feat_dim: int = 80, generator=None):
    """(s2p, p2g, g2p) of cfg {"s2p": {encoder}, "p2g": ..., "g2p": ...}:
    S2P classifies phonemes over `feat_dim` features, P2G maps phonemes to
    graphemes, G2P graphemes to phonemes. Random weights from
    `generator`, on the CPU."""
    def make(key, **kw):
        spec = cfg[key]
        kwargs = dict(spec.get("kwargs", {}), **kw)
        return models.get_encoder(spec["type"])(**kwargs,
                                                generator=generator)

    s2p_kw = {"num_classes": num_phonemes}
    if "idim" not in cfg["s2p"].get("kwargs", {}):
        s2p_kw["idim"] = int(feat_dim)
    return (make("s2p", **s2p_kw),
            make("p2g", vocab_size=num_phonemes, num_classes=num_graphemes),
            make("g2p", vocab_size=num_graphemes, num_classes=num_phonemes))


def build_model(cfg: dict, num_phonemes: int, num_graphemes: int,
                feat_dim: int = 80, device=None, seed: int = 0) -> JsaModel:
    """The `JsaModel` of cfg, weights random from a generator seeded with
    `seed`, in eval mode on `device` (default "cuda", which raises when
    CUDA is missing: pass device="cpu" for the plain path)."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator().manual_seed(seed)
    model = JsaModel(*build_models(cfg, num_phonemes, num_graphemes,
                                   feat_dim, gen))
    return model.to(device).eval()


@dataclass
class JsaState:
    """Host-side sampler state: each utterance's accepted z and its log
    importance weight, and the counts of proposals and acceptances."""

    cache: Dict[str, tuple] = field(default_factory=dict)
    accepted: int = 0
    proposed: int = 0

    @property
    def acceptance_rate(self):
        return self.accepted / max(self.proposed, 1)


def _wmean(per_seq, w):
    return (per_seq * w).sum() / torch.clamp_min(w.sum(), 1.0)


def log_probs(net, x, lengths, gen=None):
    """f32 log-softmax (N, T', V) and output lengths of net's forward (in
    training mode the dropout seeds come from gen)."""
    logits, olens = net(x, lengths, gen)
    return torch.log_softmax(logits.float(), -1), olens


def clip_scale(gnorm):
    """The JAX step's clipping factor min(1, 5 / (|g| + 1e-6))."""
    return torch.clamp_max(GRAD_CLIP / (gnorm + 1e-6), 1.0)


class JsaTrainer:
    """The three models, their optimizer and the MIS sampler."""

    def __init__(self, model: JsaModel, optimizer, num_phonemes,
                 num_graphemes, num_samples=4, beam_width=8, upsample=2):
        self.model = model
        self.s2p, self.p2g, self.g2p = model.s2p, model.p2g, model.g2p
        self.optimizer = optimizer
        self.K = num_samples
        self.beam_width = beam_width
        self.num_phonemes = num_phonemes
        self.num_graphemes = num_graphemes
        self.upsample = upsample
        self.sampler = JsaState()
        self._np_rng = np.random.default_rng(0)
        self.params = [p for p in model.parameters() if p.requires_grad]

    @property
    def device(self):
        return next(self.model.parameters()).device

    def _ids(self, seqs):
        """Token id sequences -> ((1 or N, U) int64, lengths) tensors."""
        return (torch.as_tensor(np.asarray(seqs, np.int64),
                                device=self.device),
                torch.tensor([len(s) for s in seqs], device=self.device))

    # ---------------- sampling (eval mode, no grad) ----------------

    def _score_z(self, feats, flens, y, z):
        """log p_s2p(z|x) + log p_p2g(y|z) for one utterance."""
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(feats[None])).to(dev)
        lp_s, ol_s = log_probs(self.s2p, x, torch.tensor([flens],
                                                         device=dev))
        z_ids, z_len = self._ids([z])
        ll_s = -float(ctc_loss(lp_s, z_ids, ol_s, z_len,
                               reduction="none")[0])
        z_up = np.repeat(np.asarray(z, np.int64), self.upsample)
        lp_p, ol_p = log_probs(self.p2g, *self._ids([z_up]))
        y_ids, y_len = self._ids([y])
        ll_p = -float(ctc_loss(lp_p, y_ids, ol_p, y_len,
                               reduction="none")[0])
        return ll_s + ll_p

    def sample_z(self, uid, feats, flens, y):
        """MIS: propose from the G2P n-best, accept or reject against the
        cached sample."""
        y_up = np.repeat(np.asarray(y, np.int64), self.upsample)
        lp, olen = log_probs(self.g2p, *self._ids([y_up]))
        nbest = prefix_beam_search(lp[0].cpu().numpy(), int(olen[0]),
                                   beam_width=self.beam_width, nbest=self.K)
        cands = [list(pre) for _, pre in nbest if len(pre) > 0]
        if not cands:
            cands = [[int(v) for v in
                      self._np_rng.integers(1, self.num_phonemes,
                                            max(len(y), 1))]]
        scores = np.asarray([s for s, pre in nbest if len(pre) > 0]
                            or [0.0])
        q = np.exp(scores - scores.max())
        q = q / q.sum()
        k = int(self._np_rng.choice(len(cands), p=q))
        z_new = cands[k]
        logw_new = self._score_z(feats, flens, y, z_new) \
            - float(np.log(q[k]))
        self.sampler.proposed += 1
        cached = self.sampler.cache.get(uid)
        if cached is None:
            self.sampler.cache[uid] = (z_new, logw_new)
            self.sampler.accepted += 1
            return z_new
        z_old, logw_old = cached
        if np.log(self._np_rng.random() + 1e-12) < logw_new - logw_old:
            self.sampler.cache[uid] = (z_new, logw_new)
            self.sampler.accepted += 1
            return z_new
        return z_old

    def draw_z(self, batch, supervised_z=None):
        """Each row's z: [1] for a padding row, the supervised phonemes
        where given, else a MIS sample."""
        self.model.eval()
        zs = []
        with torch.no_grad():
            for j in range(batch.feats.shape[0]):
                uid = (batch.uids[j % len(batch.uids)] if batch.uids
                       else str(j))
                if batch.weight[j] == 0:
                    zs.append([1])
                    continue
                y = batch.labels[j, :batch.label_lengths[j]]
                if supervised_z and uid in supervised_z:
                    zs.append(list(supervised_z[uid]))
                else:
                    zs.append(self.sample_z(
                        uid, batch.feats[j, :batch.feat_lengths[j]],
                        int(batch.feat_lengths[j]), y))
        return zs

    # ---------------- the step ----------------

    def device_batch(self, batch, zs):
        """The step's tensors on the models' device: speech, graphemes y,
        phonemes z and both repeated `upsample` times, weights."""
        B = len(zs)
        zmax = max(max(len(z) for z in zs), 1)
        z_arr = np.zeros((B, zmax), np.int64)
        z_len = np.zeros((B,), np.int64)
        for j, z in enumerate(zs):
            z_arr[j, :len(z)] = z
            z_len[j] = len(z)
        up = self.upsample
        t = lambda a, dt=None: torch.as_tensor(np.asarray(a, dt),
                                               device=self.device)
        return dict(feats=t(batch.feats, np.float32),
                    feat_lengths=t(batch.feat_lengths, np.int64),
                    y=t(batch.labels, np.int64),
                    y_lengths=t(batch.label_lengths, np.int64),
                    z=t(z_arr), z_lengths=t(z_len),
                    z_up=t(np.repeat(z_arr, up, axis=1)),
                    z_up_lengths=t(z_len * up),
                    y_up=t(np.repeat(batch.labels, up, axis=1), np.int64),
                    y_up_lengths=t(np.asarray(batch.label_lengths,
                                              np.int64) * up),
                    weight=t(batch.weight, np.float32))

    def loss_fn(self, b, gen=None):
        """(total, (s2p, p2g, g2p)) of the three CTC losses, each the
        weight-masked mean over the batch."""
        w = b["weight"]

        def ctc(net, x, xl, labels, ll):
            lp, ol = log_probs(net, x, xl, gen)
            return _wmean(ctc_loss(lp, labels, ol, ll, reduction="none"), w)

        l_s2p = ctc(self.s2p, b["feats"], b["feat_lengths"], b["z"],
                    b["z_lengths"])
        l_p2g = ctc(self.p2g, b["z_up"], b["z_up_lengths"], b["y"],
                    b["y_lengths"])
        l_g2p = ctc(self.g2p, b["y_up"], b["y_up_lengths"], b["z"],
                    b["z_lengths"])
        return l_s2p + l_p2g + l_g2p, (l_s2p, l_p2g, l_g2p)

    def train_step(self, batch, gen=None, supervised_z=None, lr=None):
        """One step on a loader `Batch` (numpy, with uids): the z draw,
        the losses in training mode, the clipped gradient and Adam at lr
        (1e-3 when None). Returns float metrics "loss", "loss_s2p",
        "loss_p2g", "loss_g2p" and "acceptance_rate"."""
        b = self.device_batch(batch, self.draw_z(batch, supervised_z))
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        total, parts = self.loss_fn(b, gen)
        total.backward()
        scale = clip_scale(global_grad_norm(self.params))
        for p in self.params:
            if p.grad is not None:
                p.grad.mul_(scale)
        set_lr(self.optimizer, 1e-3 if lr is None else lr)
        self.optimizer.step()
        metrics = {"loss": total.item(), "loss_s2p": parts[0].item(),
                   "loss_p2g": parts[1].item(), "loss_g2p": parts[2].item()}
        metrics["acceptance_rate"] = self.sampler.acceptance_rate
        return metrics



def manager_steps(trainer: JsaTrainer, supervised_z=None):
    """(state, train_step, eval_step) for the `Manager`, which passes the
    loader's `Batch` as it is (batch_transform and put_batch the
    identity: the sampler needs the uids). eval_step's dev loss is
    -log p(ẑ|x) - log p(y|ẑ) at the greedy S2P phonemes ẑ (an empty ẑ
    taken as [1]), as in JAX."""

    def train_step(state, batch, lr, gen):
        metrics = trainer.train_step(batch, gen, supervised_z, lr)
        state.step += 1
        return state, metrics

    def eval_step(state, batch):
        trainer.model.eval()
        with torch.no_grad():
            dev = trainer.device
            feats = torch.from_numpy(np.asarray(batch.feats,
                                                np.float32)).to(dev)
            flens = torch.as_tensor(np.asarray(batch.feat_lengths,
                                               np.int64), device=dev)
            lp, ol = log_probs(trainer.s2p, feats, flens)
            zs = [z if z else [1] for z in greedy_decode(lp, ol)]
            b = trainer.device_batch(batch, zs)
            per_s2p = ctc_loss(lp, b["z"], ol, b["z_lengths"],
                               reduction="none")
            lp_p, ol_p = log_probs(trainer.p2g, b["z_up"], b["z_up_lengths"])
            per_p2g = ctc_loss(lp_p, b["y"], ol_p, b["y_lengths"],
                               reduction="none")
            w = b["weight"]
            return {"loss_sum": ((per_s2p + per_p2g) * w).sum(),
                    "count": w.sum()}

    state = TrainState(model=trainer.model, optimizer=trainer.optimizer)
    return state, train_step, eval_step
