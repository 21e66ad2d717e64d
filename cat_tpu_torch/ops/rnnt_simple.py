"""The fused "simple" RNN-T loss of the additive `LogAdd` joiner
(counterpart of `cat_tpu/ops/rnnt_simple.py`): logit[t, u, v] = f[t, v] +
g[u, v], so the (N, T, U+1, V) lattice is never built:

  logZ[t, u]     = LSE_v(f[t, v] + g[u, v])   (one exp-domain product)
  blank_lp[t, u] = f[t, 0] + g[u, 0] - logZ[t, u]
  label_lp[t, u] = f[t, y_{u+1}] + g[u, y_{u+1}] - logZ[t, u]

and the lattice recursions run on (T, N, U+1) tables only, through the
same two kernels as `rnnt_loss` (`ops/rnnt.py` `forward_alphas`,
`backward_betas`). The gradients with respect to f and g are the
posteriors scattered at the blank and label columns minus two
posterior-weighted softmax products. The products are plain batched
matrix products (`torch.matmul`, as the JAX package leaves them to XLA).
"""
from __future__ import annotations

import torch

from cat_tpu_torch.ops import rnnt
from cat_tpu_torch.ops.semiring import LOG_EPS


def _exp_factors(f, g):
    """(ef, eg, mf, mg): f and g exponentiated after subtracting their
    maxima over v, and those maxima (N, T, 1), (N, U+1, 1)."""
    mf = f.amax(-1, keepdim=True)
    mg = g.amax(-1, keepdim=True)
    return torch.exp(f - mf), torch.exp(g - mg), mf, mg


def _log_matmul_z(ef, eg, mf, mg):
    """logZ (N, T, U+1) = LSE_v(f[n, t, v] + g[n, u, v])."""
    z = torch.matmul(ef, eg.transpose(1, 2))
    return mf + mg.transpose(1, 2) + torch.log(torch.clamp_min(z, 1e-37))


def _tables(f, g, logz, labels, input_lengths, label_lengths):
    """(blank_eff, label_eff, blank_raw, label_raw), each (T, N, U+1)."""
    N, T, _ = f.shape
    U1 = g.shape[1]
    dev = f.device
    idx = rnnt._label_index(labels)                       # (N, U+1)
    blank_raw = f[:, :, :1] + g[:, None, :, 0] - logz
    fy = torch.gather(f, 2, idx[:, None, :].expand(N, T, U1))
    gy = torch.gather(g, 2, idx[:, :, None])[..., 0]
    label_raw = fy + gy[:, None, :] - logz
    frame_valid = (torch.arange(T, device=dev)[None, :, None]
                   < input_lengths[:, None, None])
    u_valid = (torch.arange(U1, device=dev)[None, None, :]
               < label_lengths[:, None, None])
    blank_eff = torch.where(frame_valid, blank_raw, 0.0)
    label_eff = torch.where(frame_valid & u_valid, label_raw, LOG_EPS)
    tr = lambda x: x.transpose(0, 1).contiguous()
    return tr(blank_eff), tr(label_eff), tr(blank_raw), tr(label_raw)


class _RNNTNllSimple(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, labels, input_lengths, label_lengths):
        ef, eg, mf, mg = _exp_factors(f, g)
        logz = _log_matmul_z(ef, eg, mf, mg)
        tables = _tables(f, g, logz, labels, input_lengths, label_lengths)
        alphas = rnnt.forward_alphas(tables[0], tables[1])
        ll = rnnt._final_ll(alphas, tables[0], label_lengths)
        ctx.save_for_backward(f, g, logz, *tables, alphas, ll, labels,
                              input_lengths, label_lengths)
        return -ll

    @staticmethod
    def backward(ctx, gcot):
        (f, g, logz, blank_eff, label_eff, blank_raw, label_raw, alphas, ll,
         labels, input_lengths, label_lengths) = ctx.saved_tensors
        pos_blank, pos_label = rnnt.posteriors(
            blank_eff, label_eff, blank_raw, label_raw, alphas, ll,
            input_lengths, label_lengths, gcot)                # (N, T, U+1)
        ef, eg, mf, mg = _exp_factors(f, g)
        # p[t, u, v] = ef[t, v]·eg[u, v]·exp(mf[t] + mg[u] - logZ[t, u]):
        # the per-axis max shifts folded into one (t, u) scale
        qs = (pos_blank + pos_label) * torch.exp(
            mf + mg.transpose(1, 2) - logz)
        grad_f = ef * torch.matmul(qs, eg)
        grad_g = eg * torch.matmul(qs.transpose(1, 2), ef)
        idx = rnnt._label_index(labels)
        N, T, U1 = pos_label.shape
        grad_f[..., 0] -= pos_blank.sum(2)
        grad_f.scatter_add_(2, idx[:, None, :].expand(N, T, U1), -pos_label)
        grad_g[..., 0] -= pos_blank.sum(1)
        grad_g.scatter_add_(2, idx[:, :, None], -pos_label.sum(1)[..., None])
        return grad_f, grad_g, None, None, None


def rnnt_loss_simple(f, g, labels, input_lengths, label_lengths,
                     reduction="mean"):
    """Fused additive-joiner RNN-T loss.

    f (N, T, V) encoder projections and g (N, U+1, V) predictor
    projections (g[:, 0] for <bos>), both unnormalised f32; labels,
    input_lengths, label_lengths as `rnnt_loss`. Differentiable in f and
    g."""
    nll = _RNNTNllSimple.apply(f, g, labels.long(), input_lengths.long(),
                               label_lengths.long())
    return rnnt._reduce(nll, reduction)
