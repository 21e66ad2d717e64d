"""Log-semiring helpers shared by the CTC and CRF losses (counterpart of
`cat_tpu/ops/semiring.py`).

A finite stand-in for log(0), LOG_EPS, keeps (-inf) - (-inf) NaNs out of
the recursions; values at or below LOG_EPS / 2 count as exact zeros.
"""
from __future__ import annotations

import torch

LOG_EPS = -1e30


def safe_logaddexp(a, b):
    """logaddexp that treats values <= LOG_EPS/2 as exact zeros (no NaNs)."""
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    out = mx + torch.log1p(torch.exp(mn - mx))
    return out.masked_fill(mx <= LOG_EPS / 2, LOG_EPS)


def logaddexp3(a, b, c):
    """Three-way logaddexp via a single max."""
    mx = torch.maximum(torch.maximum(a, b), c)
    out = mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx)
                         + torch.exp(c - mx))
    return out.masked_fill(mx <= LOG_EPS / 2, LOG_EPS)
