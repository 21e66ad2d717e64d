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

Left out (a later slice, see ROADMAP.md): the subsampling's `time_chunk`,
the causal conv and attention context windows.
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

    def __init__(self, num_heads, d_model, context=(-1, -1), dropout_rate=0.0):
        super().__init__()
        if tuple(context) != (-1, -1):
            raise NotImplementedError("attention context windows are not "
                                      "ported yet; see ROADMAP.md")
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
        o = attention.relpos_attention(q, k, v, p, self.u_bias.to(dtype),
                                       self.v_bias.to(dtype), lengths,
                                       rate=rate, seed=seed)
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
        if causal:
            raise NotImplementedError("the causal conv module is not ported "
                                      "yet; see ROADMAP.md")
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
        # asymmetric "same" padding, as the JAX module: (k-1)//2 left
        h = F.pad(h.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
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
    """FF/2 -> MHSA -> Conv -> FF/2 -> LN, residual stream in `dtype`."""

    def __init__(self, d_model, num_heads, kernel_size=32, ff_expansion=4,
                 dropout_rate=0.0):
        super().__init__()
        self.ff1 = FFModule(d_model, ff_expansion, dropout_rate=dropout_rate)
        self.norm_mhsa = _layer_norm(d_model)
        self.mhsa = RelPositionMultiHeadAttention(num_heads, d_model,
                                                  dropout_rate=dropout_rate)
        self.conv = ConvModule(d_model, kernel_size,
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
