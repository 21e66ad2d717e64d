"""Conformer building blocks in PyTorch, eval mode, length-mask aware.

Counterparts of `cat_tpu/models/layers.py`. Every module takes padded
(N, T, ...) tensors plus lengths and masks internally. Parameters are
kept in float32 in the JAX package's layouts (a dense kernel is (in,
out)); a module computes in `dtype` (the config's "float32" or
"bfloat16"), casting weights as it reads them, while layer norms and
softmaxes run in float32. The fused stages call the kernels of
`cat_tpu_torch.ops`, which pick the CUDA kernel or the plain version from
the device of their input.

Left out of this slice (a later one, see ROADMAP.md): training (dropout,
batch statistics), the subsampling's `time_chunk`, the causal conv and
attention context windows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.ops import attention, conv_module, ffn

LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


def length_mask(lengths, T):
    """(N,) lengths -> (N, T) bool mask."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def rel_positional_encoding(T, d_model, dtype=torch.float32, device=None):
    """Relative sinusoid table p[m], m in [0, 2T-1), distance d = T-1-m;
    built in float64, then cast."""
    f64 = torch.float64
    d = torch.arange(T - 1, -T, -1, dtype=f64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=f64, device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(2 * T - 1, d_model, dtype=f64, device=device)
    pe[:, 0::2] = torch.sin(d * div)
    pe[:, 1::2] = torch.cos(d * div)
    return pe.to(dtype)


class Dense(nn.Module):
    """y = x . kernel + bias, computed in `dtype`; kernel (in, out)."""

    def __init__(self, din, dout, bias=True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(din, dout))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x, dtype):
        y = x.to(dtype) @ self.kernel.to(dtype)
        return y if self.bias is None else y + self.bias.to(dtype)


def _layer_norm(d):
    return nn.LayerNorm(d, eps=LN_EPS)


class Conv2dSubsampling(nn.Module):
    """Two VALID 3x3 stride-2 convs with ReLU, then a projection of the
    (freq, channel) features: (N, T, idim) -> (N, T', odim)."""

    def __init__(self, idim, odim, time_chunk=0):
        super().__init__()
        if time_chunk:
            raise NotImplementedError("Conv2dSubsampling time_chunk is not "
                                      "ported yet; see ROADMAP.md")
        self.conv_a = nn.Conv2d(1, odim, 3, stride=2)
        self.conv_b = nn.Conv2d(odim, odim, 3, stride=2)
        freq = ((idim - 3) // 2 + 1 - 3) // 2 + 1
        self.proj = Dense(freq * odim, odim)

    def forward(self, x, lengths, dtype):
        h = x[:, None].to(dtype)                       # (N, 1, T, F)
        h = F.relu(F.conv2d(h, self.conv_a.weight.to(dtype),
                            self.conv_a.bias.to(dtype), stride=2))
        h = F.relu(F.conv2d(h, self.conv_b.weight.to(dtype),
                            self.conv_b.bias.to(dtype), stride=2))
        N, C, Tp, Fp = h.shape
        # the JAX projection contracts (freq, channel) in that order
        h = h.permute(0, 2, 3, 1).reshape(N, Tp, Fp * C)
        out_lengths = torch.clamp(((lengths - 1) // 2 - 1) // 2, min=1)
        return self.proj(h, dtype), out_lengths


class RelPositionMultiHeadAttention(nn.Module):
    """Transformer-XL relative-position multi-head self-attention."""

    def __init__(self, num_heads, d_model, context=(-1, -1)):
        super().__init__()
        if tuple(context) != (-1, -1):
            raise NotImplementedError("attention context windows are not "
                                      "ported yet; see ROADMAP.md")
        self.num_heads = num_heads
        self.q = Dense(d_model, d_model)
        self.k = Dense(d_model, d_model)
        self.v = Dense(d_model, d_model)
        self.pos = Dense(d_model, d_model, bias=False)
        dh = d_model // num_heads
        self.u_bias = nn.Parameter(torch.zeros(num_heads, dh))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, dh))
        self.out = Dense(d_model, d_model)

    def forward(self, x, lengths, dtype):
        N, T, D = x.shape
        H = self.num_heads
        heads = (N, T, H, D // H)
        q = self.q(x, dtype).view(heads)
        k = self.k(x, dtype).view(heads)
        v = self.v(x, dtype).view(heads)
        pe = rel_positional_encoding(T, D, dtype, x.device)
        p = self.pos(pe, dtype).view(2 * T - 1, H, D // H)
        o = attention.relpos_attention(q, k, v, p, self.u_bias.to(dtype),
                                       self.v_bias.to(dtype), lengths)
        o = o.reshape(N, T, D) * length_mask(lengths, T)[..., None].to(dtype)
        return self.out(o, dtype)


class FFModule(nn.Module):
    """x + alpha * FF(x): LN -> Dense(4D) -> SiLU -> Dense(D), fused."""

    def __init__(self, d_model, expansion=4, residual_alpha=0.5):
        super().__init__()
        self.norm = _layer_norm(d_model)
        self.fc1 = Dense(d_model, d_model * expansion)
        self.fc2 = Dense(d_model * expansion, d_model)
        self.alpha = residual_alpha

    def forward(self, x):
        return ffn.fused_ff_residual(
            x, self.norm.weight, self.norm.bias, self.fc1.kernel,
            self.fc1.bias, self.fc2.kernel, self.fc2.bias, alpha=self.alpha)


class ConvModule(nn.Module):
    """x + (pointwise-GLU -> depthwise conv -> BN (running statistics) ->
    SiLU -> pointwise), the residual folded in."""

    def __init__(self, d_model, kernel_size=32, causal=False):
        super().__init__()
        if causal:
            raise NotImplementedError("the causal conv module is not ported "
                                      "yet; see ROADMAP.md")
        self.kernel_size = kernel_size
        self.norm = _layer_norm(d_model)
        self.pw_in = Dense(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel_size,
                                   groups=d_model)
        self.bn_scale = nn.Parameter(torch.ones(d_model))
        self.bn_bias = nn.Parameter(torch.zeros(d_model))
        self.register_buffer("running_mean", torch.zeros(d_model))
        self.register_buffer("running_var", torch.ones(d_model))
        self.pw_out = Dense(d_model, d_model)

    def forward(self, x, mask, dtype):
        h = conv_module.fused_glu_in(x, mask, self.norm.weight, self.norm.bias,
                                     self.pw_in.kernel, self.pw_in.bias)
        k = self.kernel_size
        # asymmetric "same" padding, as the JAX module: (k-1)//2 left
        h = F.pad(h.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
        c = F.conv1d(h, self.depthwise.weight.to(dtype),
                     self.depthwise.bias.to(dtype), groups=x.shape[-1])
        return conv_module.fused_bn_out(
            c.transpose(1, 2), x, mask, self.running_mean, self.running_var,
            self.bn_scale, self.bn_bias, self.pw_out.kernel, self.pw_out.bias)


class ConformerCell(nn.Module):
    """FF/2 -> MHSA -> Conv -> FF/2 -> LN, residual stream in `dtype`."""

    def __init__(self, d_model, num_heads, kernel_size=32, ff_expansion=4):
        super().__init__()
        self.ff1 = FFModule(d_model, ff_expansion)
        self.norm_mhsa = _layer_norm(d_model)
        self.mhsa = RelPositionMultiHeadAttention(num_heads, d_model)
        self.conv = ConvModule(d_model, kernel_size)
        self.ff2 = FFModule(d_model, ff_expansion)
        self.norm_out = _layer_norm(d_model)

    def forward(self, x, lengths):
        dtype = x.dtype
        mask = length_mask(lengths, x.shape[1])
        x = self.ff1(x)
        h = self.norm_mhsa(x.float()).to(dtype)
        x = x + self.mhsa(h, lengths, dtype)
        x = self.conv(x, mask, dtype)
        x = self.ff2(x)
        x = self.norm_out(x.float()).to(dtype)
        return x * mask[..., None].to(dtype)
