"""Trans-dimensional random field (TRF) LMs trained by noise-contrastive
estimation (counterpart of the part of `cat_tpu/lm/trf.py` that
`lm/train_trf.py` and the LM pipeline reach).

- `TRFNCE`: an energy network `udlying_nn` (a decoder of the zoo) with
  one of five energy functions (sumtargetlogit, sumtokenlogit,
  hidden2scalar, logsumexplogit, maxlogit), per-length normalisers ζ
  (`zeta`, ζ_0 = 0, initial slope log V) and a neural noise LM
  `noise_model`; φ(x) = −E(x) − ζ_|x|.
- `hist_length`: the Laplace-smoothed length prior π.
- `make_noise_sampler`: ancestral sampling from the noise LM on its
  device, lengths from π, every draw from an explicit CPU
  `torch.Generator` (the uniforms are drawn in bulk and moved once; a
  token is the inverse CDF of its step's distribution at one uniform).
  The draws cannot match `jax.random`'s.
- `make_trf_loss`: NCE (frozen noise) and dynamic NCE (the α-mixture on
  both sides plus the noise LM's ML term), the weights p1 and p0 and the
  noise side detached, as the JAX package stops their gradients. The
  noise samples may be passed in.
- `rebm_score` (log p_n − E) and `trf_score` (φ + log π) for rescoring.

The noise LM stays in eval mode (the JAX package runs it deterministic).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
from torch import nn

from cat_tpu_torch import models
from cat_tpu_torch.models.layers import Dense

EPS = 1e-30
ENERGY_FUNCS = ("sumtargetlogit", "sumtokenlogit", "hidden2scalar",
                "logsumexplogit", "maxlogit")


def hist_length(lengths, max_len: int = 200):
    """Laplace-smoothed length histogram π, float32 (max(max_len, longest
    + 1),); π[0] = 0."""
    max_len = int(max(max_len, np.max(lengths) + 1))
    hist = np.zeros(max_len, np.float64)
    for length in lengths:
        hist[int(length)] += 1
    hist[0] = 0.0
    hist[1:] += 1.0
    hist /= hist.sum() + max_len
    return hist.astype(np.float32)


def _masked(x, lengths):
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths[:, None])
    return torch.where(mask, x, 0.0)


@contextmanager
def _deterministic(module):
    """The module in eval mode (no dropout) for the block."""
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


class TRFNCE(nn.Module):
    """TRF energy model and neural noise LM in one module. ebm, noise:
    decoder-zoo configs {"type", "kwargs"}; the noise LM needs `step` and
    `init_state` (an `LSTMPredictor` has them)."""

    def __init__(self, vocab_size, ebm=None, noise=None,
                 energy_func="sumtargetlogit", max_len=200, zeta_factor=0.0,
                 generator=None):
        super().__init__()
        if energy_func not in ENERGY_FUNCS:
            raise ValueError(energy_func)
        self.energy_func = energy_func
        self.max_len = max_len
        ecfg = ebm or {"type": "LSTMPredictor", "kwargs": {}}
        ekw = dict(ecfg.get("kwargs", {}))
        ekw.setdefault("vocab_size", vocab_size)
        if energy_func == "hidden2scalar":
            ekw["with_head"] = False
        else:
            ekw.setdefault("num_classes", vocab_size)
            ekw["with_head"] = True
        self.udlying_nn = models.get_decoder(ecfg["type"])(
            **ekw, generator=generator)
        self.energy_lin = None
        if energy_func == "hidden2scalar":
            self.energy_lin = Dense(self.udlying_nn.hdim, 1)
            with torch.no_grad():
                k = self.energy_lin.kernel
                k.copy_(torch.randn(k.shape, generator=generator)
                        / k.shape[0] ** 0.5)
        ncfg = noise or {"type": "LSTMPredictor", "kwargs": {"hdim": 128}}
        nkw = dict(ncfg.get("kwargs", {}))
        nkw.setdefault("vocab_size", vocab_size)
        nkw.setdefault("num_classes", vocab_size)
        nkw["with_head"] = True
        self.noise_model = models.get_decoder(ncfg["type"])(
            **nkw, generator=generator)
        slope = zeta_factor or math.log(vocab_size)
        zeta = slope * torch.arange(-1.0, max_len - 1.0)
        zeta[0] = 0.0
        self.zeta = nn.Parameter(zeta)
        self.noise_model.eval()

    def train(self, mode=True):
        super().train(mode)
        self.noise_model.eval()
        return self

    def energy(self, tokens, targets, lengths, gen=None):
        """E(x) per sequence (N,). tokens [<s>, w1..wn], targets [w1..wn,
        </s>] (the `lm.train.LmLoader` convention); gen: the dropout seeds
        of the energy network in training mode, None: deterministic."""
        if gen is None:
            with _deterministic(self.udlying_nn):
                out, _ = self.udlying_nn(tokens, lengths)
        else:
            out, _ = self.udlying_nn(tokens, lengths, gen)
        if self.energy_func == "hidden2scalar":
            e = self.energy_lin(out, torch.float32)[..., 0]
            return _masked(e, lengths).sum(1)
        logits = out.float()
        if self.energy_func in ("sumtargetlogit", "sumtokenlogit"):
            idx = targets if self.energy_func == "sumtargetlogit" else tokens
            w = logits.gather(-1, idx.long()[..., None])[..., 0]
            return -_masked(w, lengths).sum(1)
        if self.energy_func == "logsumexplogit":
            return -torch.logsumexp(logits[:, 0, :], -1)
        return -logits[:, 0, :].max(-1).values

    def phi(self, tokens, targets, lengths, gen=None):
        """φ(x) = −E(x) − ζ_|x|."""
        e = self.energy(tokens, targets, lengths, gen)
        return -e - self.zeta[lengths.long().clamp(0, self.max_len - 1)]

    def noise_nll(self, tokens, targets, lengths):
        """The noise LM's NLL in nats per sequence (N,)."""
        logits, _ = self.noise_model(tokens, lengths)
        lp = torch.log_softmax(logits.float(), -1)
        ll = lp.gather(-1, targets.long()[..., None])[..., 0]
        return -_masked(ll, lengths).sum(1)


def _log_pi(pi, device):
    return torch.log(torch.as_tensor(np.asarray(pi, np.float32),
                                     device=device) + EPS)


def _at_length(log_pi, lengths):
    return log_pi[lengths.long().clamp(0, log_pi.shape[0] - 1)]


def _inverse_cdf(probs, u):
    """Index of the first cumulative probability above u·total, row by
    row: a draw from each row of `probs` (N, V) at the uniforms u (N,)."""
    cdf = probs.cumsum(-1)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    return idx[:, 0].clamp_max(probs.shape[-1] - 1)


def make_noise_sampler(model: TRFNCE, num: int, max_len: int, pi_noise,
                       greedy: bool = False):
    """Returns sample(gen) -> (tokens (num, max_len) with <s> at [:, 0],
    targets, lengths in [1, max_len - 1], log_pn = the drawn tokens'
    log-probs + log π[length]) on the noise LM's device, without
    gradients: lengths ~ π, then the noise LM's steps, one token a step
    (argmax when greedy)."""

    def sample(gen):
        dev = next(model.parameters()).device
        log_pi = _log_pi(pi_noise, dev)
        u_len = torch.rand(num, generator=gen)
        u_tok = torch.rand(max_len - 1, num, generator=gen).to(dev)
        lens = _inverse_cdf(torch.softmax(log_pi.cpu(), -1)[None].expand(
            num, -1), u_len).clamp(1, max_len - 1).to(dev)
        noise = model.noise_model
        toks, lps = [], []
        with torch.no_grad():
            st = noise.init_state(num, dev)
            prev = torch.zeros(num, dtype=torch.long, device=dev)
            for i in range(max_len - 1):
                out, st = noise.step(prev, st)
                lp = torch.log_softmax(out.float(), -1)
                prev = (lp.argmax(-1) if greedy
                        else _inverse_cdf(lp.exp(), u_tok[i]))
                toks.append(prev)
                lps.append(lp.gather(-1, prev[:, None])[:, 0])
        toks, lps = torch.stack(toks, 1), torch.stack(lps, 1)
        # step i draws the (i+1)-th input token, valid while i + 1 < length
        valid = (torch.arange(1, max_len, device=dev)[None, :]
                 < lens[:, None])
        body = torch.where(valid, toks, 0)
        zero = torch.zeros(num, 1, dtype=torch.long, device=dev)
        tokens = torch.cat([zero, body], 1)
        targets = torch.cat([body, zero], 1)
        log_pn = torch.where(valid, lps, 0.0).sum(1) + _at_length(log_pi,
                                                                  lens)
        return tokens, targets, lens, log_pn

    return sample


def make_trf_loss(model: TRFNCE, pi, method: str = "nce",
                  noise_rate: float = 1.0, alpha: float = 0.25,
                  max_len: int = 64, greedy_sampling: bool = False):
    """NCE / dynamic NCE loss. Returns loss_fn(batch, gen, samples=None)
    -> (loss, metrics): batch "tokens", "targets", "lengths" on the
    model's device; gen the CPU generator of the noise draws and of the
    energy network's dropout (None: deterministic); samples, optional,
    the noise sets as `make_noise_sampler` returns them: {"noise": ...}
    for NCE, {"data": ..., "noise": ...} for DNCE (the α-mixture's share
    of the data side first), drawn from gen in that order when absent."""
    log_nu = math.log(max(noise_rate, EPS))

    def draw(samples, key, n, gen):
        if samples is not None:
            return samples[key]
        return make_noise_sampler(model, n, max_len, pi,
                                  greedy_sampling)(gen)

    def loss_fn(batch, gen, samples=None):
        tokens, targets = batch["tokens"], batch["targets"]
        lengths = batch["lengths"]
        B = tokens.shape[0]
        log_pi = _log_pi(pi, tokens.device)

        def log_pm_of(tok, tar, lens, g=None):
            ph = model.phi(tok, tar, lens, g)
            return ph + _at_length(log_pi, lens), ph

        log_pm, phi = log_pm_of(tokens, targets, lengths, gen)
        noise_nll = model.noise_nll(tokens, targets, lengths)
        log_pn = -noise_nll

        if method == "nce":
            log_pn = log_pn.detach()
            ntok, ntar, nlen, log_pn_noise = draw(
                samples, "noise", max(int(B * noise_rate), 1), gen)
            log_pm_noise, phi_noise = log_pm_of(ntok, ntar, nlen)
            p1 = torch.sigmoid(log_nu - log_pm + log_pn).detach()
            p0 = torch.sigmoid(-log_nu + log_pm_noise
                               - log_pn_noise).detach()
            loss_data = -(p1 * phi).mean()
            loss_noise = noise_rate * (p0 * phi_noise).mean()
            metrics = {
                "loss_data": loss_data, "loss_noise": loss_noise,
                "acc_data": (p1 < 0.5).float().mean(),
                "acc_noise": (p0 < 0.5).float().mean(),
                "loss_true": (-torch.log1p(-p1 + EPS).mean()
                              - noise_rate * torch.log1p(-p0 + EPS).mean()),
            }
            return loss_data + loss_noise, metrics
        if method != "dnce":
            raise ValueError(method)

        a = float(alpha)
        loss_noisem_ml = noise_nll.sum() / max(int(lengths.sum()), 1)
        log_pn_sg = log_pn.detach()
        n_in_data = int(B * (1.0 - a) / a) if a < 1.0 else 0
        if n_in_data > 0:
            dtok, dtar, dlen, d_log_pn = draw(samples, "data", n_in_data,
                                              gen)
            d_log_pm, d_phi = log_pm_of(dtok, dtar, dlen)
            log_pn_all = torch.cat([log_pn_sg, d_log_pn])
            phi_all = torch.cat([phi, d_phi])
            log_pm_all = torch.logaddexp(
                math.log(a) + torch.cat([log_pm, d_log_pm]),
                math.log1p(-a) + log_pn_all)
        else:
            log_pm_all, log_pn_all, phi_all = log_pm, log_pn_sg, phi
        p1 = torch.sigmoid(log_nu - log_pm_all + log_pn_all).detach()
        loss_data = -(p1 * phi_all).sum() / B * a

        ntok, ntar, nlen, log_pn_noise = draw(
            samples, "noise", max(int(B * noise_rate / a), 1), gen)
        log_pm_noise, phi_noise = log_pm_of(ntok, ntar, nlen)
        if a < 1.0:
            log_pm_noise = torch.logaddexp(math.log(a) + log_pm_noise,
                                           math.log1p(-a) + log_pn_noise)
        p0 = torch.sigmoid(log_pm_noise - log_pn_noise - log_nu).detach()
        loss_noise = (p0 * phi_noise).sum() / B * a
        metrics = {
            "loss_data": loss_data, "loss_noise": loss_noise,
            "loss_noise_kl": loss_noisem_ml,
            "acc_data": (p1 < 0.5).float().mean(),
            "acc_noise": (p0 < 0.5).float().mean(),
            "ppl_noiseM_data": torch.exp(loss_noisem_ml),
        }
        return loss_data + loss_noise + loss_noisem_ml, metrics

    return loss_fn


def rebm_score(model: TRFNCE, tokens, targets, lengths):
    """Residual-EBM score log p_n(x) − E(x) per sequence."""
    return (-model.noise_nll(tokens, targets, lengths)
            - model.energy(tokens, targets, lengths))


def trf_score(model: TRFNCE, pi, tokens, targets, lengths):
    """The TRF log-score φ(x) + log π_|x| (normalised up to a constant)
    per sequence."""
    return (model.phi(tokens, targets, lengths)
            + _at_length(_log_pi(pi, tokens.device), lengths))
