"""The monotonic (RNA / CTC-topology) transducer loss (counterpart of
`cat_tpu/ops/rnnt_rna.py`): every emission, label or blank, consumes one
encoder frame. The forward variable over (t, u):

  alpha[t+1, u]   ⊕= alpha[t, u] + lp[t, u, blank]
  alpha[t+1, u+1] ⊕= alpha[t, u] + lp[t, u, y_{u+1}]
  ll = alpha[T, U]

A row depends on the previous row only, so a frame is two shifted adds
and a log-add-exp over (N, U+1). The JAX package computes it with a
`lax.scan` outside any Pallas kernel; this is the same scan in plain
PyTorch, one step a frame, differentiated by autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cat_tpu_torch.ops.semiring import LOG_EPS, safe_logaddexp


def rnnt_loss_rna(log_probs, labels, input_lengths, label_lengths, blank=0,
                  reduction="mean"):
    """Monotonic transducer NLL. log_probs (N, T, U+1, V) f32 joiner
    log-softmax outputs, labels (N, U), lengths (N,). Needs T_n >= U_n
    (one frame a label); an infeasible utterance's NLL is about
    -LOG_EPS."""
    N, T, U1, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.long()
    input_lengths = input_lengths.to(dev).long()
    label_lengths = label_lengths.to(dev).long()
    blank_raw = log_probs[..., blank]                          # (N, T, U1)
    lab_idx = F.pad(labels, (0, 1))                            # (N, U1)
    label_raw = torch.gather(
        log_probs, 3, lab_idx[:, None, :, None].expand(N, T, U1, 1))[..., 0]
    frame_valid = (torch.arange(T, device=dev)[None, :, None]
                   < input_lengths[:, None, None])
    u_valid = (torch.arange(U1, device=dev)[None, None, :]
               < label_lengths[:, None, None])
    blank_eff = torch.where(frame_valid, blank_raw, 0.0)
    label_eff = torch.where(frame_valid & u_valid, label_raw, LOG_EPS)

    alpha = torch.full((N, U1), LOG_EPS, device=dev, dtype=log_probs.dtype)
    alpha = torch.cat([torch.zeros_like(alpha[:, :1]), alpha[:, 1:]], 1)
    edge = torch.full_like(alpha[:, :1], LOG_EPS)
    for t in range(T):
        stay = alpha + blank_eff[:, t]
        adv = torch.cat([edge, (alpha + label_eff[:, t])[:, :-1]], 1)
        alpha = torch.clamp_min(safe_logaddexp(stay, adv), LOG_EPS)
    nll = -alpha.gather(1, label_lengths[:, None])[:, 0]
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    raise ValueError(f"bad reduction {reduction}")
