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
`bn_out_forward` and their backwards `glu_in_backward` and
`bn_out_backward`: CUDA kernels in `cat_tpu_torch/csrc/glu_in.cu` and
`bn_out.cu` (both directions each). On a CPU tensor each takes its plain
version (`glu_in_reference`, `glu_in_backward_reference`,
`bn_out_reference`, `bn_out_backward_reference`); each counts its kernel
launches. The bn_out backward also returns d(mean) and d(var), so that
autograd completes the batch statistics -> conv output chain outside the
kernel, as the TPU kernel does; dx of bn_out is dO itself (the residual).

What bounds them on the H100, at the training batch's R = 15,776 rows
(12,664 valid) and D = 512: the glu_in forward does 4·R·D² operations
(0.0134 ms over the valid rows at 989 TFLOP/s), its backward 12·R·D²
(0.040 ms); bn_out 2·R·D² forward (bound by its 39 MB of rows, 0.0118
ms) and 4·R·D² backward (0.0134 ms). All four run as stages inside one C
call each, the products on the Hopper GEMM mainloop of
`csrc/hopper_gemm.cuh` (TMA and wgmma) with the elementwise work fused
into the epilogues, and sum in a fixed order without atomics, so two
calls on the same inputs give the same bits and every gradient output is
written whole (see glu_in.cu and bn_out.cu). glu_in: the forward is a
LayerNorm row pass to bf16 scratch h, then the product h . W with bias,
GLU and mask in its epilogue; the backward recomputes h and the product,
whose epilogue writes dh2 = [du | dg] as bf16 scratch, then dh = dh2 .
W^T, the LayerNorm backward, dW = h^T . dh2 split over rows into an f32
workspace (`glu_in_bwd_workspace`), and a pass that sums every partial.
bn_out: the forward is a BN + SiLU row pass to bf16 scratch y, then the
product y . W with bias, dropout, mask and residual in its epilogue; the
backward is a row pass (y, dh = drop(dO · mask) and the db partials),
dy = dh . W^T with the SiLU and BN backward and the dscale and dbias
partials in its epilogue, dW = y^T . dh split over rows into an f32
workspace, and a pass that sums every partial; `bn_out_plan` chooses the
split and sizes the workspace.

Float32 (a ConformerNet at its default dtype) takes its own route, the TPU
kernels' arithmetic at f32: `glu_in_forward_f32`, `glu_in_backward_f32`,
`bn_out_forward_f32` and `bn_out_backward_f32` launch
`csrc/conv_module_f32.cu`, full float32 products on the CUDA cores (no
TF32) in the same stages, any D that is a multiple of 32, with the same
Philox mask; each counts its launches. `glu_in_forward` and the other
three dispatch by device and dtype: a CPU tensor takes the plain version
(which follows x.dtype), a CUDA bf16 tensor the bf16 kernels, a CUDA f32
tensor the f32 ones; anything else raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cat_tpu_torch import _build
from cat_tpu_torch.ops.dropout import dropout_scale, kernel_args
from cat_tpu_torch.ops.ffn import wgrad_splits

LN_EPS = 1e-6
BN_EPS = 1e-5
_DIMS = (128, 256, 384, 512)
# the C entries of csrc/glu_in.cu and bn_out.cu: (pointers, ints, floats)
_GLU = {"glu_in_fwd": (8, 2, 0), "glu_in_bwd": (15, 3, 0),
        "glu_in_bwd_workspace": (0, 2, 0)}
_BN = {"bn_out_fwd": (11, 5, 1), "bn_out_bwd": (18, 8, 1)}
# and of csrc/conv_module_f32.cu
_F32 = {"glu_in_f32_fwd": (8, 2, 0), "glu_in_f32_bwd": (13, 3, 0),
        "glu_in_f32_bwd_workspace": (0, 3, 0), "bn_out_f32_fwd": (11, 5, 1),
        "bn_out_f32_bwd": (16, 6, 1), "bn_out_f32_bwd_workspace": (0, 3, 0)}
# rows of a column-partial block of the bn_out backward (its row pass's
# blocks and its down product's tiles) and of a block of K in its wgrad
# product; at most this many splits of R in that product, which are
# chosen to fill the 132 SMs of an H100 SXM once
BN_ROWS = 64
BN_MAX_SPLITS = 16
SMS = 132


class BnOutPlan(NamedTuple):
    """The bn_out backward's launch plan for R rows of width D."""
    blocks: int     # 64-row blocks of R: column partials and wgrad's K
    splits: int     # splits of R in the wgrad product
    per: int        # blocks a split (the last may have fewer)
    ws_floats: int  # f32 workspace: 3 column partials, weight partials


def bn_out_plan(R: int, D: int) -> BnOutPlan:
    """The wgrad split: as many splits as fill the SMs once with the
    (D/128)² output tiles of 128 x 128, at most BN_MAX_SPLITS, none
    empty; the workspace holds the db, sum dy0 and sum dy0·xn partials of
    every block, then one (D, D) partial a split when R is split.
    `csrc/bn_out.cu` refuses a plan whose splits do not cover every block
    exactly once or whose workspace is short."""
    blocks = -(-R // BN_ROWS)
    tiles = (D // 128) ** 2
    splits = 1
    if blocks > 1:
        s = max(1, min(BN_MAX_SPLITS, SMS // tiles, blocks))
        splits = -(-blocks // -(-blocks // s))
    per = -(-blocks // splits)
    ws = 3 * blocks * D + (splits * D * D if splits > 1 else 0)
    return BnOutPlan(blocks, splits, per, ws)


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


def _check_glu(x, mask, w, b):
    D = x.shape[-1]
    if tuple(w.shape) != (D, 2 * D) or b.numel() != 2 * D \
            or tuple(mask.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"fused_glu_in: unsupported shapes x "
                         f"{tuple(x.shape)}, mask {tuple(mask.shape)}, "
                         f"w {tuple(w.shape)}")


def _check_bn(conv, x, mask, mean, var, scale, bias, w, b):
    D = x.shape[-1]
    if conv.dtype != x.dtype or tuple(conv.shape) != tuple(x.shape) \
            or tuple(w.shape) != (D, D) \
            or tuple(mask.shape) != tuple(x.shape[:-1]) \
            or any(t.numel() != D for t in (mean, var, scale, bias, b)):
        raise ValueError(f"fused_bn_out: unsupported operands conv "
                         f"{conv.dtype} {tuple(conv.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")


def _glu_operands(x, mask, gamma, beta, w, b):
    _check_activations("fused_glu_in", x)
    _check_glu(x, mask, w, b)
    D = x.shape[-1]
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

    A CPU tensor takes `glu_in_reference`, a CUDA f32 tensor
    `glu_in_forward_f32`; a CUDA bf16 tensor launches the kernel (D in
    128/256/384/512); anything else raises."""
    if x.device.type == "cpu":
        return glu_in_reference(x, mask, gamma, beta, w, b)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return glu_in_forward_f32(x, mask, gamma, beta, w, b)
    args, R, D = _glu_operands(x, mask, gamma, beta, w, b)
    out, h = torch.empty_like(args[0]), torch.empty_like(args[0])
    err = _build.load("glu_in", _GLU).glu_in_fwd(
        *(t.data_ptr() for t in (*args, out, h)), R, D,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "glu_in_fwd")
    glu_in_forward.launches += 1
    return out.view(x.shape)


def glu_in_backward(x, mask, gamma, beta, w, b, dout):
    """(dx, dgamma, dbeta, dw, db) of `fused_glu_in`. A CPU tensor takes
    `glu_in_backward_reference`, a CUDA f32 tensor `glu_in_backward_f32`;
    a CUDA bf16 tensor launches `glu_in.cu` (the shapes of
    `glu_in_forward`); anything else raises. Every output is written
    whole by the kernels."""
    if x.device.type == "cpu":
        return glu_in_backward_reference(x, mask, gamma, beta, w, b, dout)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return glu_in_backward_f32(x, mask, gamma, beta, w, b, dout)
    args, R, D = _glu_operands(x, mask, gamma, beta, w, b)
    do = dout.reshape(R, D).to(torch.bfloat16).contiguous()
    _check_operands("fused_glu_in", x, [do])
    bf, f32 = torch.bfloat16, torch.float32
    new = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device=x.device)
    lib = _build.load("glu_in", _GLU)
    units = lib.glu_in_bwd_workspace(R, D, None)
    dx, h, dh2 = new(R, D), new(R, D), new(R, 2 * D)
    dg, dbe, dw, db = (new(D, dt=f32), new(D, dt=f32), new(D, 2 * D, dt=f32),
                       new(2 * D, dt=f32))
    ws = new(units * 64, dt=f32)
    err = lib.glu_in_bwd(
        *(t.data_ptr() for t in (*args, do, dx, h, dh2, dg, dbe, dw, db, ws)),
        R, D, units, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "glu_in_bwd")
    glu_in_backward.launches += 1
    return dx.view(x.shape), dg, dbe, dw, db


def _bn_operands(conv, x, mask, mean, var, scale, bias, w, b):
    _check_activations("fused_bn_out", x)
    _check_bn(conv, x, mask, mean, var, scale, bias, w, b)
    D = x.shape[-1]
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

    A CPU tensor takes `bn_out_reference`, a CUDA f32 tensor
    `bn_out_forward_f32`; a CUDA bf16 tensor launches the kernel (D in
    128/256/384/512); anything else raises."""
    if x.device.type == "cpu":
        return bn_out_reference(conv, x, mask, mean, var, scale, bias, w, b,
                                rate, seed)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return bn_out_forward_f32(conv, x, mask, mean, var, scale, bias, w, b,
                                  rate, seed)
    args, R, D = _bn_operands(conv, x, mask, mean, var, scale, bias, w, b)
    drop, inv = kernel_args(rate, seed)
    out, y = torch.empty_like(args[1]), torch.empty_like(args[1])
    err = _build.load("bn_out", _BN).bn_out_fwd(
        *(t.data_ptr() for t in (*args, out, y)), R, D, *drop, inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_out_fwd")
    bn_out_forward.launches += 1
    return out.view(x.shape)


def bn_out_backward(conv, x, mask, mean, var, scale, bias, w, b, dout,
                    rate=0.0, seed=None):
    """(dconv, dmean, dvar, dscale, dbias, dw, db) of `fused_bn_out`. A
    CPU tensor takes `bn_out_backward_reference`, a CUDA f32 tensor
    `bn_out_backward_f32`; a CUDA bf16 tensor launches `bn_out.cu` (the
    shapes of `bn_out_forward`, the plan of `bn_out_plan`); anything else
    raises. Every output is written whole by the kernels."""
    if x.device.type == "cpu":
        return bn_out_backward_reference(conv, x, mask, mean, var, scale,
                                         bias, w, b, dout, rate, seed)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return bn_out_backward_f32(conv, x, mask, mean, var, scale, bias, w,
                                   b, dout, rate, seed)
    args, R, D = _bn_operands(conv, x, mask, mean, var, scale, bias, w, b)
    drop, inv = kernel_args(rate, seed)
    c, _, m, mu, vr, sc, bi, wb, _ = args
    do = dout.reshape(R, D).to(torch.bfloat16).contiguous()
    _check_operands("fused_bn_out", x, [do])
    plan = bn_out_plan(R, D)
    bf, f32 = torch.bfloat16, torch.float32
    new = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device=x.device)
    dc, y, dh = new(R, D), new(R, D), new(R, D)
    dmu, dvar, dsc, dbi, dw, db = (new(D, dt=f32), new(D, dt=f32),
                                   new(D, dt=f32), new(D, dt=f32),
                                   new(D, D, dt=f32), new(D, dt=f32))
    ws = new(plan.ws_floats, dt=f32)
    err = _build.load("bn_out", _BN).bn_out_bwd(
        *(t.data_ptr() for t in (c, m, mu, vr, sc, bi, wb, do)),
        *(t.data_ptr() for t in (dc, y, dh, dmu, dvar, dsc, dbi, dw, db, ws)),
        R, D, plan.splits, plan.per, plan.ws_floats // 64, *drop, inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_out_bwd")
    bn_out_backward.launches += 1
    return dc.view(x.shape), dmu, dvar, dsc, dbi, dw, db


def _f32_operands(name, x, tensors):
    """`tensors` as contiguous f32 on x's device; raises unless x is a
    float32 CUDA tensor whose width is a multiple of 32."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 CUDA "
                         f"activations, got {x.dtype} on {x.device}")
    if x.shape[-1] % 32:
        raise ValueError(f"{name}: unsupported width D={x.shape[-1]}: the "
                         "f32 kernels take D a multiple of 32")
    args = [t.detach().float().contiguous() for t in tensors]
    if any(t.device != x.device for t in args):
        raise ValueError(f"{name}: operands must lie on x's device")
    return args


def glu_in_forward_f32(x, mask, gamma, beta, w, b):
    """The float32 glu_in forward: a CUDA f32 tensor launches
    `csrc/conv_module_f32.cu` (the shapes of `glu_in_forward`, D a
    multiple of 32, every product a full f32 FMA); anything else raises.
    `glu_in_forward` sends a CPU tensor to the plain version."""
    D = x.shape[-1]
    R = x.numel() // D
    args = _f32_operands("glu_in_forward_f32", x,
                         (x.reshape(R, D), mask.reshape(R), gamma, beta, w, b))
    _check_glu(x, mask, w, b)
    out, h = torch.empty_like(args[0]), torch.empty_like(args[0])
    err = _build.load("conv_module_f32", _F32).glu_in_f32_fwd(
        *(t.data_ptr() for t in (*args, out, h)), R, D,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "glu_in_f32_fwd")
    glu_in_forward_f32.launches += 1
    return out.view(x.shape)


def glu_in_backward_f32(x, mask, gamma, beta, w, b, dout):
    """The float32 glu_in backward, (dx, dgamma, dbeta, dw, db) in f32: a
    CUDA f32 tensor launches `csrc/conv_module_f32.cu`, which recomputes
    the forward from x and sums dW over `wgrad_splits(R)` slices of the
    rows in order; anything else raises."""
    D = x.shape[-1]
    R = x.numel() // D
    args = _f32_operands("glu_in_backward_f32", x,
                         (x.reshape(R, D), mask.reshape(R), gamma, beta, w, b,
                          dout.reshape(R, D)))
    _check_glu(x, mask, w, b)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=x.device)
    outs = [new(R, D), new(D), new(D), new(D, 2 * D), new(2 * D)]
    lib = _build.load("conv_module_f32", _F32)
    splits = wgrad_splits(R)
    ws = new(max(lib.glu_in_f32_bwd_workspace(R, D, splits, None), 1) * 64)
    err = lib.glu_in_f32_bwd(*(t.data_ptr() for t in (*args, *outs, ws)),
                             R, D, splits,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "glu_in_f32_bwd")
    glu_in_backward_f32.launches += 1
    dx, *grads = outs
    return (dx.view(x.shape), *grads)


def _bn_f32_operands(name, conv, x, mask, mean, var, scale, bias, w, b):
    D = x.shape[-1]
    R = x.numel() // D
    args = _f32_operands(name, x, (conv.reshape(R, D), x.reshape(R, D),
                                   mask.reshape(R), mean, var, scale, bias,
                                   w, b))
    _check_bn(conv, x, mask, mean, var, scale, bias, w, b)
    return args, R, D


def bn_out_forward_f32(conv, x, mask, mean, var, scale, bias, w, b,
                       rate=0.0, seed=None):
    """The float32 bn_out forward: a CUDA f32 tensor launches
    `csrc/conv_module_f32.cu` (the shapes of `bn_out_forward`, D a
    multiple of 32); anything else raises. `bn_out_forward` sends a CPU
    tensor to the plain version."""
    args, R, D = _bn_f32_operands("bn_out_forward_f32", conv, x, mask, mean,
                                  var, scale, bias, w, b)
    drop, inv = kernel_args(rate, seed)
    out, y = torch.empty_like(args[1]), torch.empty_like(args[1])
    err = _build.load("conv_module_f32", _F32).bn_out_f32_fwd(
        *(t.data_ptr() for t in (*args, out, y)), R, D, *drop, inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_out_f32_fwd")
    bn_out_forward_f32.launches += 1
    return out.view(x.shape)


def bn_out_backward_f32(conv, x, mask, mean, var, scale, bias, w, b, dout,
                        rate=0.0, seed=None):
    """The float32 bn_out backward, (dconv, dmean, dvar, dscale, dbias, dw,
    db) in f32: a CUDA f32 tensor launches `csrc/conv_module_f32.cu`, which
    sums dW over `wgrad_splits(R)` slices of the rows in order; anything
    else raises."""
    args, R, D = _bn_f32_operands("bn_out_backward_f32", conv, x, mask,
                                  mean, var, scale, bias, w, b)
    c, _, m, mu, vr, sc, bi, wf, _ = args
    do = dout.reshape(R, D).float().contiguous()
    drop, inv = kernel_args(rate, seed)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=x.device)
    outs = [new(R, D), new(D), new(D), new(D), new(D), new(D, D), new(D)]
    lib = _build.load("conv_module_f32", _F32)
    splits = wgrad_splits(R)
    ws = new(max(lib.bn_out_f32_bwd_workspace(R, D, splits, None), 1) * 64)
    err = lib.bn_out_f32_bwd(
        *(t.data_ptr() for t in (c, m, mu, vr, sc, bi, wf, do, *outs, ws)),
        R, D, *drop, splits, inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_out_f32_bwd")
    bn_out_backward_f32.launches += 1
    dc, *grads = outs
    return (dc.view(x.shape), *grads)


for _f in (glu_in_forward, glu_in_backward, bn_out_forward, bn_out_backward,
           glu_in_forward_f32, glu_in_backward_f32, bn_out_forward_f32,
           bn_out_backward_f32):
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
