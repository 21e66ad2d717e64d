"""Fused conformer feed-forward module, forward only (eval).

    out = x + alpha * (SiLU(LN(x) . W1 + b1) . W2 + b2)

with LN eps 1e-6, bf16 operands and f32 sums.

Replaces the TPU kernel `_ff_fwd_kernel` of `cat_tpu/ops/ffn_pallas.py`
(`pallas_call` in `_fwd`, reached through `fused_ff_residual`) at rate 0.
The CUDA kernel is `cat_tpu_torch/csrc/ffn_fwd.cu`; `ff_reference` is its
plain PyTorch version.

What bounds it on the H100: at the main path's shape (R = 8 x 599 rows,
D = 512, F = 2048) the two products are 4·R·D·F = 20.1 GFLOP, 20 us at
the 989 TFLOP/s bf16 peak, while the bytes it must move (x and out, W1
and W2 in bf16) are 14 MB, 4.2 us at 3.35 TB/s: operations bound it. The
design keeps the (R, F) hidden activation out of device memory: each
block of 32 rows walks F in chunks of 64 through shared memory and sums
into an f32 accumulator held in registers, so the only traffic besides x
and out is the weights, read from L2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cat_tpu_torch import _build

LN_EPS = 1e-6
_DIMS = (128, 256, 384, 512)


def ff_reference(x, gamma, beta, w1, b1, w2, b2, alpha=0.5):
    """Plain PyTorch version: the same arithmetic, products of operands
    rounded to x.dtype and summed in f32."""
    dt = x.dtype
    xf = x.float()
    h = F.layer_norm(xf, (x.shape[-1],), gamma.float(), beta.float(), LN_EPS)
    h1 = h.to(dt).float() @ w1.to(dt).float() + b1.float()
    h2 = F.silu(h1).to(dt).float() @ w2.to(dt).float() + b2.float()
    return (xf + alpha * h2).to(dt)


def fused_ff_residual(x, gamma, beta, w1, b1, w2, b2, alpha=0.5):
    """x (..., D); gamma, beta, b2 (D,); w1 (D, F); b1 (F,); w2 (F, D).

    A CPU tensor takes `ff_reference`. A CUDA tensor launches the kernel,
    which takes bf16 x with D in (128, 256, 384, 512) and F a multiple of 64;
    weights are cast to bf16 and vectors to f32 as the kernel reads them.
    Anything else raises.
    """
    if x.device.type == "cpu":
        return ff_reference(x, gamma, beta, w1, b1, w2, b2, alpha)
    D = x.shape[-1]
    Fh = w1.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"fused_ff_residual: the kernel takes bfloat16 CUDA "
                         f"activations, got {x.dtype} on {x.device}")
    if D not in _DIMS or Fh % 64 or tuple(w1.shape) != (D, Fh) \
            or tuple(w2.shape) != (Fh, D) or b1.numel() != Fh \
            or gamma.numel() != D or beta.numel() != D or b2.numel() != D:
        raise ValueError(f"fused_ff_residual: unsupported shapes x "
                         f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    xr = x.reshape(-1, D).contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    args = [xr, gamma.to(f32).contiguous(), beta.to(f32).contiguous(),
            w1.to(bf).contiguous(), b1.to(f32).contiguous(),
            w2.to(bf).contiguous(), b2.to(f32).contiguous()]
    for t in args:
        if t.device != x.device or t.data_ptr() % 32:
            raise ValueError("fused_ff_residual: operands must lie on x's "
                             "device, 32-byte aligned")
    out = torch.empty_like(xr)
    err = _build.load("ffn_fwd", {"ffn_fwd": (8, 3, 1)}).ffn_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(), xr.shape[0], D, Fh,
        float(alpha), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ffn_fwd")
    fused_ff_residual.launches += 1
    return out.view(x.shape)


fused_ff_residual.launches = 0
