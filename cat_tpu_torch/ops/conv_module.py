"""The conformer convolution module's two fused stages, forward only (eval).

    glu_in:  out = mask * GLU(LN(x) . W + b)                 W (D, 2D)
    bn_out:  out = x + mask * (SiLU(BN(c)) . W + b)          W (D, D)

with LN eps 1e-6 and BN(c) = (c - mean) * rsqrt(var + 1e-5) * scale + bias
over the running statistics; bf16 operands, f32 sums. The depthwise conv
between them stays `F.conv1d`.

Replaces the TPU kernels `_glu_in_fwd_kernel` and `_bn_out_fwd_kernel` of
`cat_tpu/ops/conv_module_pallas.py` (`pallas_call` in `_glu_in_pallas` and
`_bn_out_pallas`, reached through `fused_glu_in` and `fused_bn_out`) at
rate 0. Both CUDA kernels are in `cat_tpu_torch/csrc/conv_module_fwd.cu`;
`glu_in_reference` and `bn_out_reference` are their plain versions.

What bounds them on the H100, at the main path's R = 8 x 599 rows and
D = 512: glu_in does 4·R·D² = 5.0 GFLOP (5.1 us at 989 TFLOP/s) against
2·R·D·2 + 2·D² · 2 bytes = 10.9 MB (3.3 us at 3.35 TB/s); bn_out does
2·R·D² = 2.5 GFLOP (2.5 us) against 3·R·D·2 + D²·2 = 15.2 MB (4.5 us).
So glu_in is bound by operations and bn_out by bytes, both close to the
line. The design reads each input once and writes the output once: the
normalised rows of a 32-row block stay in shared memory as bf16 while
the output is produced 64 columns at a time, the epilogue (GLU and mask,
or bias, mask and residual) applied before each chunk is stored.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cat_tpu_torch import _build

LN_EPS = 1e-6
BN_EPS = 1e-5
_DIMS = (128, 256, 384, 512)
_ENTRIES = {"glu_in_fwd": (7, 2, 0), "bn_out_fwd": (10, 2, 0)}


def glu_in_reference(x, mask, gamma, beta, w, b):
    """Plain PyTorch version of `fused_glu_in`."""
    dt = x.dtype
    D = x.shape[-1]
    h = F.layer_norm(x.float(), (D,), gamma.float(), beta.float(), LN_EPS)
    h2 = h.to(dt).float() @ w.to(dt).float() + b.float()
    out = h2[..., :D] * torch.sigmoid(h2[..., D:])
    return (out * mask[..., None].float()).to(dt)


def bn_out_reference(conv, x, mask, mean, var, scale, bias, w, b):
    """Plain PyTorch version of `fused_bn_out`."""
    dt = x.dtype
    y = (conv.float() - mean.float()) * torch.rsqrt(var.float() + BN_EPS)
    y = F.silu(y * scale.float() + bias.float())
    h = y.to(dt).float() @ w.to(dt).float() + b.float()
    return (x.float() + mask[..., None].float() * h).to(dt)


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


def fused_glu_in(x, mask, gamma, beta, w, b):
    """x (..., D); mask (...) bool, 1 where the frame is valid; gamma, beta
    (D,); w (D, 2D); b (2D,). Returns mask * GLU(LN(x) . w + b).

    A CPU tensor takes `glu_in_reference`; a CUDA tensor launches the
    kernel (bf16 x, D in 128/256/384/512) or raises."""
    if x.device.type == "cpu":
        return glu_in_reference(x, mask, gamma, beta, w, b)
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
    out = torch.empty_like(args[0])
    err = _build.load("conv_module_fwd", _ENTRIES).glu_in_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(), R, D,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "glu_in_fwd")
    fused_glu_in.launches += 1
    return out.view(x.shape)


def fused_bn_out(conv, x, mask, mean, var, scale, bias, w, b):
    """conv, x (..., D); mask (...) bool; mean, var, scale, bias, b (D,);
    w (D, D). Returns x + mask * (SiLU(BN(conv)) . w + b).

    A CPU tensor takes `bn_out_reference`; a CUDA tensor launches the
    kernel (bf16 x, D in 128/256/384/512) or raises."""
    if x.device.type == "cpu":
        return bn_out_reference(conv, x, mask, mean, var, scale, bias, w, b)
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
    f32, bf = torch.float32, torch.bfloat16
    args = [conv.reshape(R, D).contiguous(), x.reshape(R, D).contiguous(),
            mask.reshape(R).to(f32).contiguous()]
    args += [t.to(f32).contiguous() for t in (mean, var, scale, bias)]
    args += [w.to(bf).contiguous(), b.to(f32).contiguous()]
    _check_operands("fused_bn_out", x, args)
    out = torch.empty_like(args[1])
    err = _build.load("conv_module_fwd", _ENTRIES).bn_out_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(), R, D,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_out_fwd")
    fused_bn_out.launches += 1
    return out.view(x.shape)


fused_glu_in.launches = 0
fused_bn_out.launches = 0
