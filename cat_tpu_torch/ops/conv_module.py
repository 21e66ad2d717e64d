"""The conformer convolution module's two fused stages, forward and
backward.

    glu_in:  out = mask * GLU(LN(x) . W + b)                     W (D, 2D)
    bn_out:  out = x + mask * drop(SiLU(BN(c)) . W + b)          W (D, D)

with LN eps 1e-6 and BN(c) = (c - mean) * rsqrt(var + 1e-5) * scale + bias,
over the running statistics in eval and the masked batch statistics in
training (the caller passes either); bf16 operands, f32 sums; the dropout
is the Philox mask of `ops/dropout.py` (stream 0, by row and column). The
depthwise conv between the stages stays `F.conv1d`.

Replaces the TPU kernels `_glu_in_fwd_kernel`, `_glu_in_bwd_kernel`,
`_bn_out_fwd_kernel` and `_bn_out_bwd_kernel` of
`cat_tpu/ops/conv_module_pallas.py` (under the custom VJPs `_glu_in_core`
and `_bn_out_core`). `fused_glu_in` and `fused_bn_out` are
`torch.autograd.Function`s; their forwards call `glu_in_forward` and
`bn_out_forward` (CUDA kernels in `cat_tpu_torch/csrc/conv_module_fwd.cu`)
and their backwards `glu_in_backward` and `bn_out_backward`
(`conv_module_bwd.cu`). On a CPU tensor each takes its plain version
(`glu_in_reference`, `glu_in_backward_reference`, `bn_out_reference`,
`bn_out_backward_reference`); each counts its kernel launches. The
bn_out backward also returns d(mean) and d(var), so that autograd
completes the batch statistics -> conv output chain outside the kernel,
as the TPU kernel does; dx of bn_out is dO itself (the residual).

What bounds the forwards on the H100, at the serving batch's R = 8 x 599
rows and D = 512: glu_in does 4·R·D² = 5.0 GFLOP (5.1 us at 989 TFLOP/s)
against 10.9 MB (3.3 us at 3.35 TB/s); bn_out does 2·R·D² = 2.5 GFLOP
(2.5 us) against 15.2 MB (4.5 us). The designs read each input once and
write the output once: the normalised rows of a 32-row block stay in
shared memory as bf16 while the output is produced 64 columns at a time.
The backwards (see conv_module_bwd.cu) recompute the forward from the
inputs and write bf16 scratch only for the weight gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cat_tpu_torch import _build
from cat_tpu_torch.ops.dropout import dropout_scale, kernel_args

LN_EPS = 1e-6
BN_EPS = 1e-5
_DIMS = (128, 256, 384, 512)
_FWD = {"glu_in_fwd": (7, 2, 0), "bn_out_fwd": (10, 5, 1)}
_BWD = {"glu_in_bwd": (14, 2, 0), "bn_out_bwd": (17, 5, 1)}


def glu_in_reference(x, mask, gamma, beta, w, b):
    """Plain PyTorch version of the glu_in forward."""
    dt = x.dtype
    D = x.shape[-1]
    h = F.layer_norm(x.float(), (D,), gamma.float(), beta.float(), LN_EPS)
    h2 = h.to(dt).float() @ w.to(dt).float() + b.float()
    out = h2[..., :D] * torch.sigmoid(h2[..., D:])
    return (out * mask[..., None].float()).to(dt)


def glu_in_backward_reference(x, mask, gamma, beta, w, b, dout):
    """Plain PyTorch version of the glu_in backward, following
    `_glu_in_bwd_kernel`. Returns (dx in x.dtype, dgamma, dbeta, dw, db in
    f32)."""
    dt = x.dtype
    D = x.shape[-1]
    xr = x.reshape(-1, D).float()
    m = mask.reshape(-1, 1).float()
    g = gamma.float()
    mean = xr.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xr - mean) ** 2).mean(-1, keepdim=True) + LN_EPS)
    xhat = (xr - mean) * rstd
    h = (xhat * g + beta.float()).to(dt).float()
    wd = w.to(dt).float()
    h2 = h @ wd + b.float()
    u, gate = h2[:, :D], h2[:, D:]
    sig = torch.sigmoid(gate)
    da = dout.reshape(-1, D).float() * m
    dh2 = torch.cat([da * sig, da * u * sig * (1.0 - sig)], dim=1)
    db = dh2.sum(0)
    dh2 = dh2.to(dt).float()
    dw = h.t() @ dh2
    dh = dh2 @ wd.t()
    dgamma = (dh * xhat).sum(0)
    dbeta = dh.sum(0)
    dxh = dh * g
    dx = rstd * (dxh - dxh.mean(-1, keepdim=True)
                 - xhat * (dxh * xhat).mean(-1, keepdim=True))
    return dx.to(dt).view(x.shape), dgamma, dbeta, dw, db


def _bn_parts(conv, x, mean, var, scale, bias, rate, seed):
    D = x.shape[-1]
    c = conv.reshape(-1, D).float()
    rstd = torch.rsqrt(var.float() + BN_EPS)
    xn = (c - mean.float()) * rstd
    y0 = xn * scale.float() + bias.float()
    k = 1.0 if rate <= 0.0 else dropout_scale(seed, 0, 1, c.shape[0], D, rate,
                                              x.device)[0]
    return c, rstd, xn, y0, k


def bn_out_reference(conv, x, mask, mean, var, scale, bias, w, b, rate=0.0,
                     seed=None):
    """Plain PyTorch version of the bn_out forward."""
    dt = x.dtype
    D = x.shape[-1]
    _, _, _, y0, k = _bn_parts(conv, x, mean, var, scale, bias, rate, seed)
    h = (F.silu(y0).to(dt).float() @ w.to(dt).float() + b.float()) * k
    out = x.reshape(-1, D).float() + mask.reshape(-1, 1).float() * h
    return out.to(dt).view(x.shape)


def bn_out_backward_reference(conv, x, mask, mean, var, scale, bias, w, b,
                              dout, rate=0.0, seed=None):
    """Plain PyTorch version of the bn_out backward, following
    `_bn_out_bwd_kernel`. Returns (dconv in x.dtype, dmean, dvar, dscale,
    dbias, dw, db in f32); dx is dout."""
    dt = x.dtype
    D = x.shape[-1]
    c, rstd, xn, y0, k = _bn_parts(conv, x, mean, var, scale, bias, rate,
                                   seed)
    sig = torch.sigmoid(y0)
    y = (y0 * sig).to(dt).float()
    dh = dout.reshape(-1, D).float() * mask.reshape(-1, 1).float() * k
    db = dh.sum(0)
    dh = dh.to(dt).float()
    dw = y.t() @ dh
    dy0 = (dh @ w.to(dt).float().t()) * sig * (1.0 + y0 * (1.0 - sig))
    dscale = (dy0 * xn).sum(0)
    dbias = dy0.sum(0)
    dxn = dy0 * scale.float()
    dconv = (dxn * rstd).to(dt).view(x.shape)
    dmean = (-dxn * rstd).sum(0)
    dvar = (dxn * (c - mean.float())).sum(0) * (-0.5) * rstd ** 3
    return dconv, dmean, dvar, dscale, dbias, dw, db


def _check_activations(name, x):
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16 CUDA "
                         f"activations, got {x.dtype} on {x.device}")
    if x.shape[-1] not in _DIMS:
        raise ValueError(f"{name}: unsupported width D={x.shape[-1]}")


def _check_operands(name, x, tensors):
    for t in tensors:
        if t.device != x.device or t.data_ptr() % 32:
            raise ValueError(f"{name}: operands must lie on x's device, "
                             "32-byte aligned")


def _glu_operands(x, mask, gamma, beta, w, b):
    _check_activations("fused_glu_in", x)
    D = x.shape[-1]
    if tuple(w.shape) != (D, 2 * D) or b.numel() != 2 * D \
            or tuple(mask.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"fused_glu_in: unsupported shapes x "
                         f"{tuple(x.shape)}, mask {tuple(mask.shape)}, "
                         f"w {tuple(w.shape)}")
    R = x.numel() // D
    f32 = torch.float32
    args = [x.reshape(R, D).contiguous(), mask.reshape(R).to(f32).contiguous(),
            gamma.to(f32).contiguous(), beta.to(f32).contiguous(),
            w.to(torch.bfloat16).contiguous(), b.to(f32).contiguous()]
    _check_operands("fused_glu_in", x, args)
    return args, R, D


def glu_in_forward(x, mask, gamma, beta, w, b):
    """x (..., D); mask (...) bool, 1 where the frame is valid; gamma, beta
    (D,); w (D, 2D); b (2D,). Returns mask * GLU(LN(x) . w + b).

    A CPU tensor takes `glu_in_reference`; a CUDA tensor launches the
    kernel (bf16 x, D in 128/256/384/512) or raises."""
    if x.device.type == "cpu":
        return glu_in_reference(x, mask, gamma, beta, w, b)
    args, R, D = _glu_operands(x, mask, gamma, beta, w, b)
    out = torch.empty_like(args[0])
    err = _build.load("conv_module_fwd", _FWD).glu_in_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(), R, D,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "glu_in_fwd")
    glu_in_forward.launches += 1
    return out.view(x.shape)


def glu_in_backward(x, mask, gamma, beta, w, b, dout):
    """(dx, dgamma, dbeta, dw, db) of `fused_glu_in`. A CPU tensor takes
    `glu_in_backward_reference`; a CUDA tensor launches
    `conv_module_bwd.cu` (the shapes of `glu_in_forward`) or raises."""
    if x.device.type == "cpu":
        return glu_in_backward_reference(x, mask, gamma, beta, w, b, dout)
    args, R, D = _glu_operands(x, mask, gamma, beta, w, b)
    do = dout.reshape(R, D).to(torch.bfloat16).contiguous()
    new = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=x.device)
    zeros = lambda *s: torch.zeros(*s, dtype=torch.float32, device=x.device)
    dx, h, dh2 = new(R, D), new(R, D), new(R, 2 * D)
    dg, dbe, dw, db = zeros(D), zeros(D), zeros(D, 2 * D), zeros(2 * D)
    err = _build.load("conv_module_bwd", _BWD).glu_in_bwd(
        *(t.data_ptr() for t in args), do.data_ptr(),
        *(t.data_ptr() for t in (dx, h, dh2, dg, dbe, dw, db)), R, D,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "glu_in_bwd")
    glu_in_backward.launches += 1
    return dx.view(x.shape), dg, dbe, dw, db


def _bn_operands(conv, x, mask, mean, var, scale, bias, w, b):
    _check_activations("fused_bn_out", x)
    D = x.shape[-1]
    if conv.dtype != x.dtype or tuple(conv.shape) != tuple(x.shape) \
            or tuple(w.shape) != (D, D) \
            or tuple(mask.shape) != tuple(x.shape[:-1]) \
            or any(t.numel() != D for t in (mean, var, scale, bias, b)):
        raise ValueError(f"fused_bn_out: unsupported operands conv "
                         f"{conv.dtype} {tuple(conv.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    R = x.numel() // D
    f32 = torch.float32
    args = [conv.reshape(R, D).contiguous(), x.reshape(R, D).contiguous(),
            mask.reshape(R).to(f32).contiguous()]
    args += [t.detach().to(f32).contiguous()
             for t in (mean, var, scale, bias)]
    args += [w.to(torch.bfloat16).contiguous(), b.to(f32).contiguous()]
    _check_operands("fused_bn_out", x, args)
    return args, R, D


def bn_out_forward(conv, x, mask, mean, var, scale, bias, w, b, rate=0.0,
                   seed=None):
    """conv, x (..., D); mask (...) bool; mean, var, scale, bias, b (D,);
    w (D, D). Returns x + mask * drop(SiLU(BN(conv)) . w + b).

    A CPU tensor takes `bn_out_reference`; a CUDA tensor launches the
    kernel (bf16 x, D in 128/256/384/512) or raises."""
    if x.device.type == "cpu":
        return bn_out_reference(conv, x, mask, mean, var, scale, bias, w, b,
                                rate, seed)
    args, R, D = _bn_operands(conv, x, mask, mean, var, scale, bias, w, b)
    drop, inv = kernel_args(rate, seed)
    out = torch.empty_like(args[1])
    err = _build.load("conv_module_fwd", _FWD).bn_out_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(), R, D, *drop, inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_out_fwd")
    bn_out_forward.launches += 1
    return out.view(x.shape)


def bn_out_backward(conv, x, mask, mean, var, scale, bias, w, b, dout,
                    rate=0.0, seed=None):
    """(dconv, dmean, dvar, dscale, dbias, dw, db) of `fused_bn_out`. A
    CPU tensor takes `bn_out_backward_reference`; a CUDA tensor launches
    `conv_module_bwd.cu` (the shapes of `bn_out_forward`) or raises."""
    if x.device.type == "cpu":
        return bn_out_backward_reference(conv, x, mask, mean, var, scale,
                                         bias, w, b, dout, rate, seed)
    args, R, D = _bn_operands(conv, x, mask, mean, var, scale, bias, w, b)
    drop, inv = kernel_args(rate, seed)
    c, _, m, mu, vr, sc, bi, wb, _ = args
    do = dout.reshape(R, D).to(torch.bfloat16).contiguous()
    new = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=x.device)
    zeros = lambda *s: torch.zeros(*s, dtype=torch.float32, device=x.device)
    dc, y, dh = new(R, D), new(R, D), new(R, D)
    dmu, dvar, dsc, dbi, dw, db = (zeros(D), zeros(D), zeros(D), zeros(D),
                                   zeros(D, D), zeros(D))
    err = _build.load("conv_module_bwd", _BWD).bn_out_bwd(
        *(t.data_ptr() for t in (c, m, mu, vr, sc, bi, wb, do)),
        *(t.data_ptr() for t in (dc, y, dh, dmu, dvar, dsc, dbi, dw, db)),
        R, D, *drop, inv, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_out_bwd")
    bn_out_backward.launches += 1
    return dc.view(x.shape), dmu, dvar, dsc, dbi, dw, db


for _f in (glu_in_forward, glu_in_backward, bn_out_forward, bn_out_backward):
    _f.launches = 0


class _GluIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, gamma, beta, w, b):
        ctx.save_for_backward(x, mask, gamma, beta, w, b)
        return glu_in_forward(x, mask, gamma, beta, w, b)

    @staticmethod
    def backward(ctx, dout):
        x, mask, gamma, beta, w, b = ctx.saved_tensors
        dx, dg, dbe, dw, db = glu_in_backward(x, mask, gamma, beta, w, b,
                                              dout)
        return (dx, None, dg.to(gamma.dtype), dbe.to(beta.dtype),
                dw.to(w.dtype), db.to(b.dtype))


class _BnOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, conv, x, mask, mean, var, scale, bias, w, b, rate,
                seed):
        ctx.save_for_backward(conv, x, mask, mean, var, scale, bias, w, b)
        ctx.cfg = (rate, seed)
        return bn_out_forward(conv, x, mask, mean, var, scale, bias, w, b,
                              rate, seed)

    @staticmethod
    def backward(ctx, dout):
        conv, x, mask, mean, var, scale, bias, w, b = ctx.saved_tensors
        dc, dmu, dvar, dsc, dbi, dw, db = bn_out_backward(
            conv, x, mask, mean, var, scale, bias, w, b, dout, *ctx.cfg)
        return (dc.to(conv.dtype), dout, None, dmu.to(mean.dtype),
                dvar.to(var.dtype), dsc.to(scale.dtype), dbi.to(bias.dtype),
                dw.to(w.dtype), db.to(b.dtype), None, None)


def fused_glu_in(x, mask, gamma, beta, w, b):
    """mask * GLU(LN(x) . w + b); differentiable in x, gamma, beta, w, b.
    Shapes as `glu_in_forward`."""
    return _GluIn.apply(x, mask, gamma, beta, w, b)


def fused_bn_out(conv, x, mask, mean, var, scale, bias, w, b, rate=0.0,
                 seed=None):
    """x + mask * drop(SiLU(BN(conv)) . w + b); differentiable in conv, x,
    mean, var, scale, bias, w and b. Shapes as `bn_out_forward`; seed: two
    32-bit words, needed when rate > 0."""
    return _BnOut.apply(conv, x, mask, mean, var, scale, bias, w, b, rate,
                        seed)
