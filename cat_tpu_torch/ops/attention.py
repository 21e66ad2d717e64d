"""Relative-position (Transformer-XL) attention, forward only (eval).

    out = softmax(((q + u) . kᵀ + relshift((q + v) . pᵀ)) * scale + keymask) . v

Replaces the TPU's rel-pos flash attention forward kernels of
`cat_tpu/ops/attention_pallas.py`: `_fwd_kernel_packed` (reached through
`flash_relpos_attention_packed`, the TPU default up to 512 frames) and
`_fwd_kernel` (through `flash_relpos_attention`, above 512), as well as
the single-tile, decomp and band variants that compute the same function.
One CUDA kernel, `cat_tpu_torch/csrc/relpos_attention_fwd.cu`, serves
every length; `relpos_attention_reference` is its plain version. The
projected sinusoid table p = pe(2T-1, D) . W_pos is computed outside the
kernel, as the TPU's tiled path also does.

What bounds it on the H100: per utterance of length L and head the work
is three L x L x Dh products (content scores, position scores, values),
6·L²·Dh FLOP. At the main path's batch (8 utterances of 97..599 frames,
H = 8, Dh = 64) that is about 2.3 GFLOP, 2.3 us at the 989 TFLOP/s bf16
peak, against about 9 MB of q, k, v, p and output, 2.7 us at 3.35 TB/s.
The design keeps every score in shared memory: one block per (64-query
tile, head, utterance) walks the key tiles up to the utterance's length
with an online softmax, so padded key tiles and padded query tiles cost
nothing. The position scores for a tile pair come from the 127 rows of p
that its relative positions cover, loaded to shared memory once per pair;
the diagonal band is then read by index, which leaves behind the TPU's
lane shears and trig-table decomposition.
"""
from __future__ import annotations

import math

import torch

from cat_tpu_torch import _build

NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_ENTRIES = {"relpos_attention_fwd": (8, 4, 1)}


def rel_shift(bd):
    """(N, H, T, 2T-1) -> (N, H, T, T): out[t, j] = bd[t, T-1-t+j]."""
    N, H, T, M = bd.shape
    x = torch.nn.functional.pad(bd, (1, 0)).reshape(N, H, 2 * T, T)
    return x[:, :, 1:].reshape(N, H, T, M)[..., :T]


def relpos_attention_reference(q, k, v, p, u_bias, v_bias, lengths,
                               scale=None):
    """Plain PyTorch version of `relpos_attention`, in the arithmetic of
    the JAX package's `relpos_attention_reference`: scores and softmax in
    f32, probabilities rounded to v.dtype before the value product."""
    N, T, H, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    dt = q.dtype
    kmask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    ac = torch.einsum("nthd,nshd->nhts", (q + u_bias.to(dt)).float(),
                      k.float())
    bd = torch.einsum("nthd,mhd->nhtm", (q + v_bias.to(dt)).float(),
                      p.float())
    s = (ac + rel_shift(bd)) * scale
    s = s.masked_fill(~kmask[:, None, None, :], NEG)
    attn = torch.softmax(s, dim=-1)
    out = torch.einsum("nhts,nshd->nthd", attn.to(v.dtype).float(),
                       v.float())
    return out.to(dt)


def relpos_attention(q, k, v, p, u_bias, v_bias, lengths, scale=None):
    """q, k, v (N, T, H, Dh); p (2T-1, H, Dh); u_bias, v_bias (H, Dh);
    lengths (N,): keys at or past an utterance's length are masked.
    Returns (N, T, H, Dh). Query rows past the length are not defined
    here (the kernel writes zeros); the caller zeroes them.

    A CPU tensor takes `relpos_attention_reference`. A CUDA tensor
    launches the kernel, which takes bf16 with Dh in (16, 32, 64, 128);
    anything else raises."""
    if q.device.type == "cpu":
        return relpos_attention_reference(q, k, v, p, u_bias, v_bias,
                                          lengths, scale)
    N, T, H, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if q.device.type != "cuda" or any(t.dtype != torch.bfloat16
                                      for t in (q, k, v, p)):
        raise ValueError(f"relpos_attention: the kernel takes bfloat16 CUDA "
                         f"tensors, got {q.dtype} on {q.device}")
    if Dh not in _HEAD_DIMS or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape) \
            or tuple(p.shape) != (2 * T - 1, H, Dh) \
            or u_bias.numel() != H * Dh or v_bias.numel() != H * Dh \
            or tuple(lengths.shape) != (N,):
        raise ValueError(f"relpos_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, p {tuple(p.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    bf = torch.bfloat16
    args = [q.contiguous(), k.contiguous(), v.contiguous(), p.contiguous(),
            u_bias.to(bf).contiguous(), v_bias.to(bf).contiguous(),
            lengths.to(device=q.device, dtype=torch.int32)
            .clamp(0, T).contiguous()]
    for t in args:
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError("relpos_attention: operands must lie on q's "
                             "device, 16-byte aligned")
    out = torch.empty_like(args[0])
    err = _build.load("relpos_attention_fwd", _ENTRIES).relpos_attention_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(), N, T, H, Dh,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "relpos_attention_fwd")
    relpos_attention.launches += 1
    return out


relpos_attention.launches = 0
