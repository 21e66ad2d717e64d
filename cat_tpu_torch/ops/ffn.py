"""Fused conformer feed-forward module, forward and backward.

    out = x + alpha * drop1(drop0(SiLU(LN(x) . W1 + b1)) . W2 + b2)

with LN eps 1e-6, bf16 operands and f32 sums; the dropouts are the
Philox masks of `ops/dropout.py` (stream 0 on the (R, F) hidden, stream 1
on the (R, D) output), identities at rate 0.

Replaces the TPU kernels `_ff_fwd_kernel` and `_ff_bwd_kernel` of
`cat_tpu/ops/ffn_pallas.py` (`pallas_call` in `_fwd` and `_bwd`, under
the custom VJP `_ff_core`). `fused_ff_residual` is one
`torch.autograd.Function`: its forward calls `ff_forward` and its
backward `ff_backward`, which launch the CUDA kernels
`cat_tpu_torch/csrc/ffn_fwd.cu` and `ffn_bwd.cu` on a CUDA tensor and take
the plain versions `ff_reference` and `ff_backward_reference` on a CPU
tensor. Each of the two counts its kernel launches.

What bounds them on the H100: the forward is 4·R·D·F operations (0.054
ms over the 12,664 valid rows of the training batch, R = 15,776, D = 512,
F = 2048, at the 989 TFLOP/s bf16 peak), the backward 10·R·D·F (0.134
ms). Both run as stages inside one C call, the products on the Hopper
GEMM mainloop of `csrc/hopper_gemm.cuh` (TMA and wgmma) with the
elementwise work fused into their epilogues, and both sum in a fixed order
without atomics, so two calls on the same inputs give the same bits. The
forward is three launches (see ffn_fwd.cu): a LayerNorm row pass to h, the
up product h . W1 with bias, SiLU and dropout in its epilogue to the (R,
F) hidden a1, and the down product a1 . W2 with bias, dropout and the
residual in its epilogue. h and a1 go through device memory as bf16
scratch (about 0.21 GB a call at the training batch, 0.063 ms at 3.35
TB/s), which the TPU kernel keeps in VMEM. The backward recomputes the
forward from x, as the TPU kernel does, in six launches (see ffn_bwd.cu):
two row passes (LayerNorm and dropout in, LayerNorm backward out) around
three products (the SiLU and dropout backward in the first one's
epilogue, the weight gradients split over rows), and a pass that sums
every partial in a fixed order (about 0.58 GB of scratch traffic, 0.17 ms
at 3.35 TB/s).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cat_tpu_torch import _build
from cat_tpu_torch.ops.dropout import dropout_scale, kernel_args

LN_EPS = 1e-6
_DIMS = (128, 256, 384, 512)
# the C entries of csrc/ffn_fwd.cu and ffn_bwd.cu: (pointers, ints, floats)
_FWD = {"ffn_fwd": (10, 6, 2)}
_BWD = {"ffn_bwd": (19, 7, 2), "ffn_bwd_workspace": (0, 3, 0)}


def _masks(seed, rate, R, D, Fh, device):
    """f32 dropout factors (R, F) for the hidden, (R, D) for the output."""
    if rate <= 0.0:
        return 1.0, 1.0
    return (dropout_scale(seed, 0, 1, R, Fh, rate, device)[0],
            dropout_scale(seed, 1, 1, R, D, rate, device)[0])


def ff_reference(x, gamma, beta, w1, b1, w2, b2, alpha=0.5, rate=0.0,
                 seed=None):
    """Plain PyTorch version of the forward: the same arithmetic, products
    of operands rounded to x.dtype and summed in f32."""
    dt = x.dtype
    D = x.shape[-1]
    Fh = w1.shape[-1]
    xf = x.reshape(-1, D).float()
    k1, k2 = _masks(seed, rate, xf.shape[0], D, Fh, x.device)
    h = F.layer_norm(xf, (D,), gamma.float(), beta.float(), LN_EPS)
    h1 = h.to(dt).float() @ w1.to(dt).float() + b1.float()
    a1 = F.silu(h1) * k1
    h2 = (a1.to(dt).float() @ w2.to(dt).float() + b2.float()) * k2
    return (xf + alpha * h2).to(dt).view(x.shape)


def ff_backward_reference(x, gamma, beta, w1, b1, w2, b2, dout, alpha=0.5,
                          rate=0.0, seed=None):
    """Plain PyTorch version of the backward: recomputes the forward from
    x and follows `_ff_bwd_kernel` (rounding to x.dtype where it does, f32
    sums). Returns (dx in x.dtype, dgamma, dbeta, dw1, db1, dw2, db2 in
    f32)."""
    dt = x.dtype
    D = x.shape[-1]
    Fh = w1.shape[-1]
    xr = x.reshape(-1, D).float()
    do = dout.reshape(-1, D).float()
    k1, k2 = _masks(seed, rate, xr.shape[0], D, Fh, x.device)
    g = gamma.float()
    mean = xr.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xr - mean) ** 2).mean(-1, keepdim=True) + LN_EPS)
    xhat = (xr - mean) * rstd
    h = (xhat * g + beta.float()).to(dt).float()
    w1d, w2d = w1.to(dt).float(), w2.to(dt).float()
    h1 = h @ w1d + b1.float()
    sig = torch.sigmoid(h1)
    a1 = (h1 * sig * k1).to(dt).float()
    dh2 = alpha * do * k2
    db2 = dh2.sum(0)
    dh2 = dh2.to(dt).float()
    dw2 = a1.t() @ dh2
    dh1 = (dh2 @ w2d.t()) * k1 * sig * (1.0 + h1 * (1.0 - sig))
    db1 = dh1.sum(0)
    dh1 = dh1.to(dt).float()
    dw1 = h.t() @ dh1
    dh = dh1 @ w1d.t()
    dgamma = (dh * xhat).sum(0)
    dbeta = dh.sum(0)
    dxh = dh * g
    dx = do + rstd * (dxh - dxh.mean(-1, keepdim=True)
                      - xhat * (dxh * xhat).mean(-1, keepdim=True))
    return dx.to(dt).view(x.shape), dgamma, dbeta, dw1, db1, dw2, db2


def _check(x, gamma, beta, w1, b1, w2, b2):
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


def _operands(x, gamma, beta, w1, b1, w2, b2):
    """The kernels' operands: rows bf16, weights bf16, vectors f32."""
    D = x.shape[-1]
    bf, f32 = torch.bfloat16, torch.float32
    args = [x.reshape(-1, D).contiguous(), gamma.to(f32).contiguous(),
            beta.to(f32).contiguous(), w1.to(bf).contiguous(),
            b1.to(f32).contiguous(), w2.to(bf).contiguous()]
    args.append(b2.to(f32).contiguous())
    for t in args:
        if t.device != x.device or t.data_ptr() % 32:
            raise ValueError("fused_ff_residual: operands must lie on x's "
                             "device, 32-byte aligned")
    return args


def ff_forward(x, gamma, beta, w1, b1, w2, b2, alpha=0.5, rate=0.0,
               seed=None):
    """The forward of `fused_ff_residual`, outside autograd. A CPU tensor
    takes `ff_reference`. A CUDA tensor launches the kernel, which takes
    bf16 x with D in (128, 256, 384, 512) and F a multiple of 64; weights
    are cast to bf16 and vectors to f32 as the kernel reads them. Anything
    else raises."""
    if x.device.type == "cpu":
        return ff_reference(x, gamma, beta, w1, b1, w2, b2, alpha, rate,
                            seed)
    _check(x, gamma, beta, w1, b1, w2, b2)
    args = _operands(x, gamma, beta, w1, b1, w2, b2)
    drop, inv = kernel_args(rate, seed)
    xr = args[0]
    R, D = xr.shape
    out, h = torch.empty_like(xr), torch.empty_like(xr)
    a1 = torch.empty(R, w1.shape[-1], dtype=torch.bfloat16, device=x.device)
    err = _build.load("ffn_fwd", _FWD).ffn_fwd(
        *(t.data_ptr() for t in (*args, out, h, a1)), R, D, w1.shape[-1],
        *drop, float(alpha), inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ffn_fwd")
    ff_forward.launches += 1
    return out.view(x.shape)


def ff_backward(x, gamma, beta, w1, b1, w2, b2, dout, alpha=0.5, rate=0.0,
                seed=None):
    """The backward of `fused_ff_residual`: (dx, dgamma, dbeta, dw1, db1,
    dw2, db2). A CPU tensor takes `ff_backward_reference`; a CUDA tensor
    launches `ffn_bwd.cu` (the shapes of `ff_forward`) or raises."""
    if x.device.type == "cpu":
        return ff_backward_reference(x, gamma, beta, w1, b1, w2, b2, dout,
                                     alpha, rate, seed)
    _check(x, gamma, beta, w1, b1, w2, b2)
    xr, g, b, w1b, b1f, w2b = _operands(x, gamma, beta, w1, b1, w2,
                                        b2)[:-1]  # b2 unused
    drop, inv = kernel_args(rate, seed)
    R, D = xr.shape
    Fh = w1.shape[-1]
    do = dout.reshape(R, D).to(torch.bfloat16).contiguous()
    if do.data_ptr() % 32:
        raise ValueError("fused_ff_residual: dout must be 32-byte aligned")
    bf, f32 = torch.bfloat16, torch.float32
    new = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device=x.device)
    dx, h, dh2 = new(R, D), new(R, D), new(R, D)
    a1, dh1 = new(R, Fh), new(R, Fh)
    dg, db, dw1, db1, dw2, db2 = (new(D, dt=f32), new(D, dt=f32),
                                  new(D, Fh, dt=f32), new(Fh, dt=f32),
                                  new(Fh, D, dt=f32), new(D, dt=f32))
    lib = _build.load("ffn_bwd", _BWD)
    units = lib.ffn_bwd_workspace(R, D, Fh, None)
    ws = new(units * 64, dt=f32)
    outs = [dx, h, dh2, a1, dh1, dg, db, dw1, db1, dw2, db2, ws]
    err = lib.ffn_bwd(
        *(t.data_ptr() for t in (xr, g, b, w1b, b1f, w2b, do, *outs)),
        R, D, Fh, *drop, units, float(alpha), inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ffn_bwd")
    ff_backward.launches += 1
    return dx.view(x.shape), dg, db, dw1, db1, dw2, db2


ff_forward.launches = 0
ff_backward.launches = 0


class _FusedFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, alpha, rate, seed):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.cfg = (alpha, rate, seed)
        return ff_forward(x, gamma, beta, w1, b1, w2, b2, alpha, rate, seed)

    @staticmethod
    def backward(ctx, dout):
        x, gamma, beta, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dg, db, dw1, db1, dw2, db2 = ff_backward(
            x, gamma, beta, w1, b1, w2, b2, dout, *ctx.cfg)
        return (dx, dg.to(gamma.dtype), db.to(beta.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), None, None, None)


def fused_ff_residual(x, gamma, beta, w1, b1, w2, b2, alpha=0.5, rate=0.0,
                      seed=None):
    """x (..., D); gamma, beta, b2 (D,); w1 (D, F); b1 (F,); w2 (F, D);
    seed: two 32-bit words (`ops.dropout.draw_seed`), needed when
    rate > 0. Differentiable in every tensor argument."""
    return _FusedFF.apply(x, gamma, beta, w1, b1, w2, b2, alpha, rate, seed)
