"""SpecAugment frequency and time masking (counterpart of
`cat_tpu/ops/specaug.py`), with mask drawing split from mask applying.

`draw_masks` draws the mask starts and widths from an explicit CPU
`torch.Generator`, with the JAX package's distributions: frequency widths
uniform on [0, min(width, F)], starts uniform on [0, max(F - width, 1));
time widths uniform on [0, cap_n] with the adaptive cap
cap_n = min(time_mask_width, floor(time_mask_ratio * length_n)), starts
uniform on [0, max(length_n - width, 1)). `apply_masks` zeroes the masked
bins and frames; the tests hand both packages the same masks. The time
masks alone (`draw_time_masks`, `mask_time`) also mask an RNN-T
predictor's output (`rnnt/train.py`). Time warp
(off in every recipe's crf configuration) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch


def _starts(gen, limit, widths):
    u = torch.rand(widths.shape, generator=gen)
    return (u * torch.clamp_min(limit[:, None] - widths, 1)).long()


def draw_masks(gen, lengths, num_feats, num_freq_masks=2, freq_mask_width=27,
               num_time_masks=2, time_mask_width=100, time_mask_ratio=0.2):
    """Mask (start, width) tables drawn from `gen`: a dict of (N, M) int64
    CPU tensors "freq_starts", "freq_widths", "time_starts",
    "time_widths"."""
    lengths = lengths.detach().cpu().long()
    N = lengths.shape[0]
    fw = min(freq_mask_width, num_feats)
    freq_widths = torch.randint(0, fw + 1, (N, num_freq_masks), generator=gen)
    freq_starts = _starts(gen, torch.full((N,), num_feats), freq_widths)
    time_starts, time_widths = draw_time_masks(
        gen, lengths, num_time_masks, time_mask_width, time_mask_ratio)
    return {"freq_starts": freq_starts, "freq_widths": freq_widths,
            "time_starts": time_starts, "time_widths": time_widths}


def draw_time_masks(gen, lengths, num_masks, max_width, ratio):
    """(starts, widths), (N, num_masks) int64 CPU tensors, of adaptive time
    masks (`_mask_time_adaptive` of the JAX package): widths uniform on
    [0, min(max_width, floor(ratio * length_n))], starts uniform on
    [0, max(length_n - width, 1))."""
    lengths = lengths.detach().cpu().long()
    cap = torch.clamp_max((lengths.float() * ratio).long(), int(max_width))
    widths = (torch.rand((lengths.shape[0], num_masks), generator=gen)
              * (cap[:, None] + 1)).long()
    return _starts(gen, lengths, widths), widths


def _band(starts, widths, L, device):
    """(N, L) bool: True inside any [start, start + width)."""
    pos = torch.arange(L, device=device)[None, None, :]
    s = starts.to(device)[:, :, None]
    w = widths.to(device)[:, :, None]
    return ((pos >= s) & (pos < s + w)).any(dim=1)


def mask_time(x, starts, widths):
    """x (N, T, ...) with the frames inside any [start, start + width)
    zeroed."""
    tm = _band(starts, widths, x.shape[1], x.device)
    return x.masked_fill(tm.view(*tm.shape, *([1] * (x.dim() - 2))), 0.0)


def apply_masks(feats, masks):
    """feats (N, T, F) with the masked frequency bins and frames zeroed."""
    N, T, F = feats.shape
    fm = _band(masks["freq_starts"], masks["freq_widths"], F, feats.device)
    tm = _band(masks["time_starts"], masks["time_widths"], T, feats.device)
    drop = fm[:, None, :] | tm[:, :, None]
    return feats.masked_fill(drop, 0.0)


def specaug(gen, feats, lengths, **cfg):
    """SpecAugment of feats (N, T, F) with masks drawn from `gen`."""
    return apply_masks(feats, draw_masks(gen, lengths, feats.shape[-1], **cfg))
