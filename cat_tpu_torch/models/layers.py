"""Conformer building blocks in PyTorch, length-mask aware.

Counterparts of `cat_tpu/models/layers.py`. Every module takes padded
(N, T, ...) tensors plus lengths and masks internally. Parameters are
kept in float32 in the JAX package's layouts (a dense kernel is (in,
out)); a module computes in `dtype` (the config's "float32" or
"bfloat16"), casting weights as it reads them, while layer norms and
softmaxes run in float32. The fused stages call the kernels of
`cat_tpu_torch.ops`, which pick the CUDA kernel or the plain version from
the device of their input.

Training mode (`module.train()`) follows the JAX modules with
`deterministic=False`: dropout in the FF modules, on the attention
probabilities, after the conv module's output projection and after the
subsampling, and the conv module's masked batch statistics with the
running statistics updated as 0.9·old + 0.1·batch. Every dropout draws
two 32-bit seed words from the `torch.Generator` handed down from the
caller (`gen`), so a step is a function of that generator; the masks are
the Philox masks of `cat_tpu_torch.ops.dropout`.

The streaming options of the JAX modules: the subsampling's
`time_chunk` (the convolutions over overlapping input chunks, the same
output), the causal conv module (the depthwise conv padded (k - 1, 0);
the fused entry and exit stages are unchanged) and attention context
windows (a band of keys around each query). With a window the attention
takes the plain PyTorch version with the band mask on any device, as the
JAX module takes its unfused attention whenever a window is set; without
one, the fused kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.ops import attention, conv_module, ffn
from cat_tpu_torch.ops import dropout as dropout_op
from cat_tpu_torch.ops.dropout import draw_seed

LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)
BN_MOMENTUM = 0.9


def drop_args(module, rate, gen):
    """(rate, seed) of one dropout site: rate 0 in eval mode, else two
    seed words drawn from `gen`."""
    if not module.training or rate <= 0.0:
        return 0.0, None
    if gen is None:
        raise ValueError("training with dropout needs a torch.Generator "
                         "(gen) for the dropout seeds")
    return float(rate), draw_seed(gen)


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


class Dropout(nn.Module):
    """Dropout with the Philox mask (`ops/dropout.py`, stream 0 over the
    rows of the flattened leading dims): the JAX `Dropout` module's fused
    branch (`fused_dropout`, the TPU default). The identity, launching
    nothing, at rate 0 and in eval mode."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, gen=None):
        return dropout_op.dropout(x, *drop_args(self, self.rate, gen))


class Conv2dSubsampling(nn.Module):
    """Two VALID 3x3 stride-2 convs with ReLU, then a projection of the
    (freq, channel) features: (N, T, idim) -> (N, T', odim).

    time_chunk Oc > 0 runs the stack over input chunks of 4·Oc + 3 rows
    every 4·Oc rows (output row k reads input rows 4k .. 4k + 6), Oc
    output rows each, the input zero-padded to the last chunk's end, when
    T > 4·Oc + 3: the unchunked output up to rounding, with the transient
    of the first conv bounded by the chunk."""

    def __init__(self, idim, odim, time_chunk=0):
        super().__init__()
        self.time_chunk = time_chunk
        self.conv_a = nn.Conv2d(1, odim, 3, stride=2)
        self.conv_b = nn.Conv2d(odim, odim, 3, stride=2)
        freq = ((idim - 3) // 2 + 1 - 3) // 2 + 1
        self.proj = Dense(freq * odim, odim)

    def _stack(self, h, dtype):
        """(N, 1, Ti, F) -> (N, To, odim)."""
        h = F.relu(F.conv2d(h, self.conv_a.weight.to(dtype),
                            self.conv_a.bias.to(dtype), stride=2))
        h = F.relu(F.conv2d(h, self.conv_b.weight.to(dtype),
                            self.conv_b.bias.to(dtype), stride=2))
        N, C, Tp, Fp = h.shape
        # the JAX projection contracts (freq, channel) in that order
        h = h.permute(0, 2, 3, 1).reshape(N, Tp, Fp * C)
        return self.proj(h, dtype)

    def forward(self, x, lengths, dtype):
        h = x[:, None].to(dtype)                       # (N, 1, T, F)
        T, Oc = h.shape[2], self.time_chunk
        if Oc <= 0 or T <= 4 * Oc + 3:
            out = self._stack(h, dtype)
        else:
            T2 = ((T - 3) // 2 + 1 - 3) // 2 + 1
            K = -(-T2 // Oc)
            Ic = 4 * Oc + 3
            h = F.pad(h, (0, 0, 0, max(0, 4 * (K - 1) * Oc + Ic - T)))
            out = torch.cat([self._stack(h[:, :, 4 * k * Oc:4 * k * Oc + Ic],
                                         dtype) for k in range(K)], 1)[:, :T2]
        out_lengths = torch.clamp(((lengths - 1) // 2 - 1) // 2, min=1)
        return out, out_lengths


class RelPositionMultiHeadAttention(nn.Module):
    """Transformer-XL relative-position multi-head self-attention.
    context (left, right): each query attends to the keys at most `left`
    frames before it and `right` after it (-1: unbounded); a window takes
    the plain `relpos_attention_reference` with the band, the fused kernel
    none."""

    def __init__(self, num_heads, d_model, context=(-1, -1), dropout_rate=0.0):
        super().__init__()
        self.context = tuple(context)
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.q = Dense(d_model, d_model)
        self.k = Dense(d_model, d_model)
        self.v = Dense(d_model, d_model)
        self.pos = Dense(d_model, d_model, bias=False)
        dh = d_model // num_heads
        self.u_bias = nn.Parameter(torch.zeros(num_heads, dh))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, dh))
        self.out = Dense(d_model, d_model)

    def forward(self, x, lengths, dtype, gen=None):
        N, T, D = x.shape
        H = self.num_heads
        heads = (N, T, H, D // H)
        q = self.q(x, dtype).view(heads)
        k = self.k(x, dtype).view(heads)
        v = self.v(x, dtype).view(heads)
        pe = rel_positional_encoding(T, D, dtype, x.device)
        p = self.pos(pe, dtype).view(2 * T - 1, H, D // H)
        rate, seed = drop_args(self, self.dropout_rate, gen)
        args = (q, k, v, p, self.u_bias.to(dtype), self.v_bias.to(dtype),
                lengths)
        if self.context == (-1, -1):
            o = attention.relpos_attention(*args, rate=rate, seed=seed)
        else:  # the JAX module's unfused path, on any device
            o = attention.relpos_attention_reference(
                *args, rate=rate, seed=seed, context=self.context)
        o = o.reshape(N, T, D) * length_mask(lengths, T)[..., None].to(dtype)
        return self.out(o, dtype)


class FFModule(nn.Module):
    """x + alpha * FF(x): LN -> Dense(4D) -> SiLU -> Dense(D), fused."""

    def __init__(self, d_model, expansion=4, residual_alpha=0.5,
                 dropout_rate=0.0):
        super().__init__()
        self.norm = _layer_norm(d_model)
        self.fc1 = Dense(d_model, d_model * expansion)
        self.fc2 = Dense(d_model * expansion, d_model)
        self.alpha = residual_alpha
        self.dropout_rate = dropout_rate

    def forward(self, x, gen=None):
        rate, seed = drop_args(self, self.dropout_rate, gen)
        return ffn.fused_ff_residual(
            x, self.norm.weight, self.norm.bias, self.fc1.kernel,
            self.fc1.bias, self.fc2.kernel, self.fc2.bias, alpha=self.alpha,
            rate=rate, seed=seed)


class ConvModule(nn.Module):
    """x + (pointwise-GLU -> depthwise conv -> BN -> SiLU -> pointwise ->
    dropout), the residual folded in. BN normalises by the running
    statistics in eval and by the masked batch statistics in training."""

    def __init__(self, d_model, kernel_size=32, causal=False,
                 dropout_rate=0.0):
        super().__init__()
        self.causal = causal
        self.kernel_size = kernel_size
        self.dropout_rate = dropout_rate
        self.norm = _layer_norm(d_model)
        self.pw_in = Dense(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel_size,
                                   groups=d_model)
        self.bn_scale = nn.Parameter(torch.ones(d_model))
        self.bn_bias = nn.Parameter(torch.zeros(d_model))
        self.register_buffer("running_mean", torch.zeros(d_model))
        self.register_buffer("running_var", torch.ones(d_model))
        self.pw_out = Dense(d_model, d_model)

    def forward(self, x, mask, dtype, gen=None):
        h = conv_module.fused_glu_in(x, mask, self.norm.weight, self.norm.bias,
                                     self.pw_in.kernel, self.pw_in.bias)
        k = self.kernel_size
        # causal: every frame sees the k - 1 before it; otherwise the
        # asymmetric "same" padding of the JAX module, (k-1)//2 left
        left = k - 1 if self.causal else (k - 1) // 2
        h = F.pad(h.transpose(1, 2), (left, k - 1 - left))
        c = F.conv1d(h, self.depthwise.weight.to(dtype),
                     self.depthwise.bias.to(dtype),
                     groups=x.shape[-1]).transpose(1, 2)
        mean, var = self.running_mean, self.running_var
        if self.training:
            mean, var = masked_batch_stats(c, mask)
            with torch.no_grad():
                for buf, new in ((self.running_mean, mean),
                                 (self.running_var, var)):
                    buf.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM)
                                               * new.detach())
        rate, seed = drop_args(self, self.dropout_rate, gen)
        return conv_module.fused_bn_out(
            c, x, mask, mean, var, self.bn_scale, self.bn_bias,
            self.pw_out.kernel, self.pw_out.bias, rate=rate, seed=seed)


def masked_batch_stats(c, mask):
    """Mean and biased variance (D,) in f32 of c (N, T, D) over the valid
    frames, as the JAX ConvModule computes them."""
    m = mask[..., None]
    cf = c.float()
    cnt = torch.clamp(mask.float().sum(), min=1.0)
    mean = torch.where(m, cf, 0.0).sum((0, 1)) / cnt
    var = torch.where(m, (cf - mean) ** 2, 0.0).sum((0, 1)) / cnt
    return mean, var


class ConformerCell(nn.Module):
    """FF/2 -> MHSA -> Conv -> FF/2 -> LN, residual stream in `dtype`;
    `causal_conv` and `attention_context` as the JAX cell's."""

    def __init__(self, d_model, num_heads, kernel_size=32, ff_expansion=4,
                 dropout_rate=0.0, causal_conv=False,
                 attention_context=(-1, -1)):
        super().__init__()
        self.ff1 = FFModule(d_model, ff_expansion, dropout_rate=dropout_rate)
        self.norm_mhsa = _layer_norm(d_model)
        self.mhsa = RelPositionMultiHeadAttention(num_heads, d_model,
                                                  attention_context,
                                                  dropout_rate=dropout_rate)
        self.conv = ConvModule(d_model, kernel_size, causal_conv,
                               dropout_rate=dropout_rate)
        self.ff2 = FFModule(d_model, ff_expansion, dropout_rate=dropout_rate)
        self.norm_out = _layer_norm(d_model)

    def forward(self, x, lengths, gen=None):
        dtype = x.dtype
        mask = length_mask(lengths, x.shape[1])
        x = self.ff1(x, gen)
        h = self.norm_mhsa(x.float()).to(dtype)
        x = x + self.mhsa(h, lengths, dtype, gen)
        x = self.conv(x, mask, dtype, gen)
        x = self.ff2(x, gen)
        x = self.norm_out(x.float()).to(dtype)
        return x * mask[..., None].to(dtype)


class TDNNLayer(nn.Module):
    """Dilated 1-D conv over frames, then ReLU (counterpart of the JAX
    `TDNNLayer`): kernel 2·half_context + 1, symmetric padding
    half_context·dilation, lengths ceil(len / stride), at least 1. Takes
    and returns the (N, C, T) layout of `F.conv1d` in float32. Padded
    frames are not masked, as in the JAX module: the convolutions carry
    them into the last valid frames alike in both packages."""

    def __init__(self, idim, odim, half_context=1, dilation=1, stride=1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(idim, odim, 2 * half_context + 1, stride=stride,
                              padding=half_context * dilation,
                              dilation=dilation)

    def forward(self, x, lengths):
        h = F.relu(self.conv(x))
        if self.stride > 1:
            lengths = torch.clamp(
                (lengths + self.stride - 1) // self.stride, min=1)
        return h, lengths
