"""Relative-position (Transformer-XL) attention, forward and backward.

    out = drop(softmax(((q + u) . kᵀ + relshift((q + v) . pᵀ)) * scale
                       + keymask)) . v

Replaces the TPU's rel-pos flash attention kernels of
`cat_tpu/ops/attention_pallas.py`: the forward kernels `_fwd_kernel_packed`
(reached through `flash_relpos_attention_packed`, the TPU default up to
512 frames) and `_fwd_kernel` (through `flash_relpos_attention`, above
512), the single-tile, decomp and band variants that compute the same
function, and their five backward kernels. `relpos_attention` is one
`torch.autograd.Function`: its forward calls `relpos_attention_forward`
(CUDA kernel `cat_tpu_torch/csrc/relpos_attention_fwd.cu`, which also
writes the per-row log-sum-exp) and its backward
`relpos_attention_backward` (`relpos_attention_bwd.cu`), which return
dq, dk, dv, dp (2T-1, H, Dh), du and dv_bias; on a CPU tensor each takes
its plain version (`relpos_attention_reference_lse`,
`relpos_attention_backward_reference`), and each counts its kernel
launches. The dropout on the probabilities is the Philox mask of
`ops/dropout.py` (stream 0, plane n*H + h, row t, column s); the
normaliser sums the undropped probabilities, as on the TPU. The projected
sinusoid table p = pe(2T-1, D) . W_pos is computed outside the kernels,
and so is the gradient of W_pos (a plain product of dp with the table),
as the TPU's tiled path also does.

What bounds the forward on the H100: per utterance of length L and head
the work is three L x L x Dh products, 6·L²·Dh FLOP. At the training
batch (32 utterances of 299..493 frames, H = 8, Dh = 64) that is 15.7
GFLOP, 15.9 us at the 989 TFLOP/s bf16 peak, against 53 MB of q, k, v, p
and output, 15.9 us at 3.35 TB/s. Every score stays on chip: a block per
query tile, head and utterance walks the key tiles up to the utterance's
length with an online softmax, so padded key tiles and padded query
tiles cost nothing. The position scores for a tile pair come from the
rows of p that its relative positions cover; the diagonal band is then
read by index, which leaves behind the TPU's lane shears and trig-table
decomposition. Two routes by head dimension (`fwd_route`): Dh = 64, the
width of every recipe, takes a TMA + wgmma flash kernel (128 queries a
block, window coordinates as `fwd_plan` gives them); 16, 32 and 128 a
wmma kernel (64 queries a block). The backward has two routes too
(`bwd_route`). Dh = 64: a TMA + wgmma pass in the forward's orientation
(query tiles of 128, key tiles of 64, coordinates from `bwd_plan`) that
writes dq and, as per-slot partials in a workspace, dp, du and dv_bias;
a reduce kernel that sums the partials in a fixed order (`bwd_slots`);
and a key-major TMA + wgmma pass for dK and dV (key tiles of 128, query
tiles of 64, coordinates from `bwd_kv_plan`) that recomputes the scores
as the dq pass does and keeps dK and dV in registers: three launches,
no atomics, the same bits on every call. Dh = 16, 32 and 128: a wmma
kernel, which adds dq, dp, du and dv_bias with f32 atomics into zeroed
buffers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cat_tpu_torch import _build
from cat_tpu_torch.ops.dropout import dropout_scale, kernel_args

NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_FWD = {"relpos_attention_fwd": (9, 7, 2)}
_BWD = {"relpos_attention_bwd": (19, 7, 2),
        "relpos_attention_bwd_tile": (3, 0, 0)}
# the Dh = 64 forward kernel's tiles: queries a block, keys a stage; the
# Dh = 64 backward's dq pass has the same
FWD_BQ, FWD_BK = 128, 64


class FwdPlan(NamedTuple):
    """Where the Dh = 64 forward kernel (and, by `bwd_kv_plan`, the
    backward's dK/dV pass) reads for one (query tile, key tile,
    consumer), in rows of the utterance (q, k, v) or of the (2T-1) table
    (p); TMA fills rows outside the tensor with zeros."""
    q_row: int          # first of the consumer's 64 query rows
    kv_row: int         # first of the 64 key rows (K and V boxes)
    p_rows: tuple       # first rows of the stage's three 64-row p boxes
    win: int            # first stage window row of the consumer's 128
    band: torch.Tensor  # (64, 64) window column of (query r, key c)


def fwd_route(Dh: int) -> str:
    """The forward kernel a head dimension takes: "wgmma" (Dh = 64) or
    "wmma" (16, 32, 128)."""
    return "wgmma" if Dh == 64 else "wmma"


def fwd_plan(T: int, t0: int, s0: int, w: int) -> FwdPlan:
    """Coordinates of `relpos_attention_fwd_wgmma` for the query tile at
    t0 (a multiple of FWD_BQ), the key tile at s0 (a multiple of FWD_BK)
    and consumer w (query rows t0 + 64w ..). Query t = q_row + r and key
    s = kv_row + c read table row T-1-t+s, which is row win + band[r, c]
    of the 192 rows p_rows[0] .. p_rows[0] + 191 that the stage holds."""
    w0 = T - FWD_BQ - t0 + s0
    r = torch.arange(64)
    return FwdPlan(t0 + 64 * w, s0, (w0, w0 + 64, w0 + 128), 64 * (1 - w),
                   r[None, :] - r[:, None] + 63)


class BwdPlan(NamedTuple):
    """Where the Dh = 64 backward's dq pass reads and writes for one
    (query tile, key tile, consumer). It reads what the forward reads
    (`fwd`), scatters dS[r, c] into column scatter[r, c] of the
    consumer's 64 x 128 window gradient dQP, and after the key tile
    writes the 64 table rows flush_row .. flush_row + 63 of its dp window
    (final: the next key tile's window starts 64 rows further) to rows
    slot_row .. slot_row + 63 of workspace slot `slot`; after its last key
    tile it writes the next 64 rows (the window's upper half) to the 64
    slot rows after those."""
    fwd: FwdPlan
    scatter: torch.Tensor  # (64, 64) window column of (query r, key c)
    slot: int              # the utterance's 64-query sub-tile, q_row / 64
    flush_row: int         # first table row of the flush
    slot_row: int          # first slot row of the flush


def bwd_route(Dh: int) -> str:
    """The backward kernels a head dimension takes: "wgmma" (Dh = 64: the
    dq pass, the reduce and the dK/dV pass) or "wmma" (16, 32, 128: the
    wmma kernel alone)."""
    return "wgmma" if Dh == 64 else "wmma"


def bwd_plan(T: int, t0: int, s0: int, w: int) -> BwdPlan:
    """Coordinates of `relpos_attention_bwd_dq_wgmma` for the query tile
    at t0, the key tile at s0 and consumer w, as `fwd_plan`. Window
    column m of the consumer is table row T-64-q_row+s0+m, so query
    t = q_row + r and key s = s0 + c scatter into column c - r + 63
    (table row T-1-t+s), and window rows 0..63 are table rows
    flush_row = T-64-q_row+s0 ..; slot row = table row - (T-64-q_row)."""
    f = fwd_plan(T, t0, s0, w)
    return BwdPlan(f, f.band, f.q_row // 64, T - 64 - f.q_row + s0, s0)


def bwd_kv_plan(T: int, t0: int, s0: int, w: int) -> FwdPlan:
    """Coordinates of `relpos_attention_bwd_dkdv_wgmma` for the key tile
    at s0 (a multiple of 128), the query tile at t0 (a multiple of 64)
    and consumer w (keys s0 + 64w ..), in the fields of `fwd_plan`: the
    stage holds 64 query rows from q_row and table rows p_rows[0] ..
    p_rows[0] + 191, p_rows[0] = T-64-t0+s0; query t = q_row + r and key
    s = kv_row + c read table row T-1-t+s, which is row win + band[r, c]
    of the stage, column band[r, c] = c - r + 63 of the consumer's
    128-row window from stage row win = 64w."""
    w0 = T - 64 - t0 + s0
    r = torch.arange(64)
    return FwdPlan(t0, s0 + 64 * w, (w0, w0 + 64, w0 + 128), 64 * w,
                   r[None, :] - r[:, None] + 63)


def bwd_slot_rows(T: int, j: int, length: int) -> tuple:
    """(first table row, rows) of workspace slot j (query rows 64j ..
    64j + 63) of an utterance of `length`: the windows of its key tiles,
    64·ceil(length/64) + 64 rows from T-64-64j (some may lie outside the
    table; their partials are zeros)."""
    return T - 64 - 64 * j, 64 * -(-length // 64) + 64


def bwd_workspace_rows(T: int) -> int:
    """Rows a slot takes in the workspace, whatever the length: slot j of
    utterance n starts at row (n·J + j)·bwd_workspace_rows(T), J =
    ceil(T/64)."""
    return 64 * -(-T // 64) + 64


def bwd_slots(T: int, lengths) -> list:
    """The slots the reduce sums, in its order (utterance ascending, then
    sub-tile ascending): (n, j, first table row, rows, first workspace
    row)."""
    J, SR = -(-T // 64), bwd_workspace_rows(T)
    out = []
    for n, L in enumerate(int(x) for x in lengths):
        for j in range(-(-L // 64)):
            out.append((n, j, *bwd_slot_rows(T, j, L), (n * J + j) * SR))
    return out


def rel_shift(bd):
    """(N, H, T, 2T-1) -> (N, H, T, T): out[t, j] = bd[t, T-1-t+j]."""
    N, H, T, M = bd.shape
    x = torch.nn.functional.pad(bd, (1, 0)).reshape(N, H, 2 * T, T)
    return x[:, :, 1:].reshape(N, H, T, M)[..., :T]


def _band_index(T, device):
    """(T, T) index m = T-1-t+s of the table row each (t, s) reads."""
    t = torch.arange(T, device=device)
    return T - 1 - t[:, None] + t[None, :]


def _scores(q, k, p, u_bias, v_bias, lengths, scale, context=(-1, -1)):
    """Masked f32 scores (N, H, T, T), the key mask and qu, qv (in q's
    dtype). context (left, right): keys more than `left` frames before or
    `right` after a query are masked too (-1: unbounded)."""
    T = q.shape[1]
    dt = q.dtype
    kmask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    qu, qv = q + u_bias.to(dt), q + v_bias.to(dt)
    ac = torch.einsum("nthd,nshd->nhts", qu.float(), k.float())
    bd = torch.einsum("nthd,mhd->nhtm", qv.float(), p.float())
    s = (ac + rel_shift(bd)) * scale
    keep = kmask[:, None, None, :]
    left, right = context
    t = torch.arange(T, device=q.device)
    if left >= 0:
        keep = keep & (t[None, :] >= t[:, None] - left)
    if right >= 0:
        keep = keep & (t[None, :] <= t[:, None] + right)
    return s.masked_fill(~keep, NEG), kmask, qu, qv


def _drop(seed, rate, N, H, T, device):
    if rate <= 0.0:
        return 1.0
    return dropout_scale(seed, 0, N * H, T, T, rate, device).view(N, H, T, T)


def relpos_attention_reference_lse(q, k, v, p, u_bias, v_bias, lengths,
                                   scale=None, rate=0.0, seed=None,
                                   context=(-1, -1)):
    """Plain PyTorch version of the forward, in the arithmetic of the JAX
    package's `relpos_attention_reference` (scores and softmax in f32,
    probabilities rounded to v.dtype before the value product), with the
    dropout; `context` bands the keys (`_scores`), as the JAX module's
    unfused path does. Returns (out (N, T, H, Dh), lse (N, H, T) f32);
    query rows past the length are zeros in out and in lse."""
    N, T, H, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    s, kmask, _, _ = _scores(q, k, p, u_bias, v_bias, lengths, scale,
                             context)
    lse = torch.logsumexp(s, dim=-1)
    attn = torch.exp(s - lse[..., None]) * _drop(seed, rate, N, H, T,
                                                 q.device)
    out = torch.einsum("nhts,nshd->nthd", attn.to(v.dtype).float(),
                       v.float())
    qmask = kmask[:, :, None, None]
    out = torch.where(qmask, out, 0.0).to(q.dtype)
    return out, torch.where(kmask[:, None, :], lse, 0.0)


def relpos_attention_reference(q, k, v, p, u_bias, v_bias, lengths,
                               scale=None, rate=0.0, seed=None,
                               context=(-1, -1)):
    """The output of `relpos_attention_reference_lse`."""
    return relpos_attention_reference_lse(q, k, v, p, u_bias, v_bias,
                                          lengths, scale, rate, seed,
                                          context)[0]


def relpos_attention_backward_reference(q, k, v, p, u_bias, v_bias, lengths,
                                        out, lse, dout, scale=None, rate=0.0,
                                        seed=None):
    """Plain PyTorch version of the backward, following the TPU kernels'
    recompute-from-lse math with f32 sums and the same rounding points.
    Returns (dq, dk, dv in q's dtype; dp (2T-1, H, Dh), du, dv_bias (H, Dh)
    in f32)."""
    N, T, H, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    dt = q.dtype
    s, kmask, qu, qv = _scores(q, k, p, u_bias, v_bias, lengths, scale)
    qmask = kmask[:, None, :, None]
    P = torch.where(qmask, torch.exp(s - lse[..., None]), 0.0)
    P = torch.where(kmask[:, None, None, :], P, 0.0)
    drop = _drop(seed, rate, N, H, T, q.device)
    do = dout.float()
    dpm = torch.einsum("nthd,nshd->nhts", do, v.float()) * drop
    dv = torch.einsum("nhts,nthd->nshd", (P * drop).to(dt).float(), do)
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)       # (N, H, T)
    ds = (P * (dpm - delta[..., None]) * scale).to(dt).float()
    dqu = torch.einsum("nhts,nshd->nthd", ds, k.float())
    dk = torch.einsum("nhts,nthd->nshd", ds, qu.float())
    # the rel-shift band read back: dbd[t, T-1-t+s] = ds[t, s]
    idx = _band_index(T, q.device).expand(N, H, T, T)
    dbd = torch.zeros(N, H, T, 2 * T - 1, device=q.device).scatter_(
        -1, idx, ds).to(dt).float()
    dqv = torch.einsum("nhtm,mhd->nthd", dbd, p.float())
    dp = torch.einsum("nhtm,nthd->mhd", dbd, qv.float())
    return ((dqu + dqv).to(dt), dk.to(dt), dv.to(dt), dp,
            dqu.sum((0, 1)), dqv.sum((0, 1)))


def _operands(q, k, v, p, u_bias, v_bias, lengths):
    N, T, H, Dh = q.shape
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
    return args


def relpos_attention_forward(q, k, v, p, u_bias, v_bias, lengths, scale=None,
                             rate=0.0, seed=None):
    """(out, lse) of `relpos_attention`. A CPU tensor takes
    `relpos_attention_reference_lse`. A CUDA tensor launches the kernel
    of its route (`fwd_route`), which takes bf16 with Dh in (16, 32, 64,
    128); anything else raises."""
    if q.device.type == "cpu":
        return relpos_attention_reference_lse(q, k, v, p, u_bias, v_bias,
                                              lengths, scale, rate, seed)
    N, T, H, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    args = _operands(q, k, v, p, u_bias, v_bias, lengths)
    drop, inv = kernel_args(rate, seed)
    out = torch.empty_like(args[0])
    lse = torch.empty(N, H, T, dtype=torch.float32, device=q.device)
    err = _build.load("relpos_attention_fwd", _FWD).relpos_attention_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(), lse.data_ptr(), N, T,
        H, Dh, *drop, float(scale), inv,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "relpos_attention_fwd")
    relpos_attention_forward.launches += 1
    relpos_attention_forward.routes[fwd_route(Dh)] += 1
    return out, lse


def relpos_attention_backward(q, k, v, p, u_bias, v_bias, lengths, out, lse,
                              dout, scale=None, rate=0.0, seed=None):
    """(dq, dk, dv, dp, du, dv_bias) of `relpos_attention`. A CPU tensor
    takes `relpos_attention_backward_reference`; a CUDA tensor launches
    the kernels of its route (`bwd_route`, the shapes of the forward) or
    raises. At Dh = 64 dq comes out of the kernel in bf16, and dp, du
    and dv_bias from the reduce of an f32 workspace of N·ceil(T/64)
    slots of `bwd_workspace_rows(T)` x H·Dh."""
    if q.device.type == "cpu":
        return relpos_attention_backward_reference(
            q, k, v, p, u_bias, v_bias, lengths, out, lse, dout, scale,
            rate, seed)
    N, T, H, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    args = _operands(q, k, v, p, u_bias, v_bias, lengths)
    drop, inv = kernel_args(rate, seed)
    do = dout.to(torch.bfloat16).contiguous()
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(args[0]), torch.empty_like(args[0])
    route = bwd_route(Dh)
    if route == "wgmma":  # every output written whole, no atomics
        dq = torch.empty_like(args[0])
        dp = torch.empty(2 * T - 1, H, Dh, **f32)
        du, dvb = torch.empty(H, Dh, **f32), torch.empty(H, Dh, **f32)
        slots = N * -(-T // 64)
        ws = [torch.empty(slots * bwd_workspace_rows(T), H * Dh, **f32),
              torch.empty(slots, H * Dh, **f32),
              torch.empty(slots, H * Dh, **f32)]
    else:  # the wmma kernel adds into zeroed f32 buffers
        dq = torch.zeros(N, T, H, Dh, **f32)
        dp = torch.zeros(2 * T - 1, H, Dh, **f32)
        du, dvb = torch.zeros(H, Dh, **f32), torch.zeros(H, Dh, **f32)
        ws = [None] * 3  # no workspace
    err = _build.load("relpos_attention_bwd", _BWD).relpos_attention_bwd(
        *(t.data_ptr() for t in args), lse.contiguous().data_ptr(),
        delta.data_ptr(), do.data_ptr(),
        *(t.data_ptr() for t in (dq, dk, dv, dp, du, dvb)),
        *(None if t is None else t.data_ptr() for t in ws), N, T, H, Dh,
        *drop, float(scale), inv,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "relpos_attention_bwd")
    relpos_attention_backward.launches += 1
    relpos_attention_backward.routes[route] += 1
    return dq.to(q.dtype), dk, dv, dp, du, dvb


def dkdv_tile_product(a, b):
    """aᵀ·b (64, 64) f32 for a, b (64, 64) bf16: one tile of the Dh = 64
    dK/dV pass's products (dV += Pdᵀ·dO, dK += dSᵀ·qu), with a stored as
    that pass stores Pd and dS and b as TMA stores dO, both read MN-major
    as the pass reads them. A check of those layouts, not a part of the
    backward. A CPU tensor takes the plain product; a CUDA tensor
    launches `relpos_attention_bwd_tile` or raises."""
    if a.device.type == "cpu":
        return a.float().T @ b.float()
    if any(t.shape != (64, 64) or t.dtype != torch.bfloat16
           or t.device != a.device for t in (a, b)):
        raise ValueError("dkdv_tile_product: takes two (64, 64) bfloat16 "
                         "tensors on one device")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(64, 64, dtype=torch.float32, device=a.device)
    err = _build.load("relpos_attention_bwd", _BWD).relpos_attention_bwd_tile(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "relpos_attention_bwd_tile")
    dkdv_tile_product.launches += 1
    return out


dkdv_tile_product.launches = 0
relpos_attention_forward.launches = 0
# launches by route (`fwd_route`); `launches` counts both
relpos_attention_forward.routes = {"wgmma": 0, "wmma": 0}
relpos_attention_backward.launches = 0
# calls by route (`bwd_route`); `launches` counts both, one a call
relpos_attention_backward.routes = {"wgmma": 0, "wmma": 0}


class _RelPosAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, p, u_bias, v_bias, lengths, scale, rate, seed):
        out, lse = relpos_attention_forward(q, k, v, p, u_bias, v_bias,
                                            lengths, scale, rate, seed)
        ctx.save_for_backward(q, k, v, p, u_bias, v_bias, lengths, out, lse)
        ctx.cfg = (scale, rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, p, u_bias, v_bias, lengths, out, lse = ctx.saved_tensors
        dq, dk, dv, dp, du, dvb = relpos_attention_backward(
            q, k, v, p, u_bias, v_bias, lengths, out, lse, dout, *ctx.cfg)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), dp.to(p.dtype),
                du.to(u_bias.dtype).view(u_bias.shape),
                dvb.to(v_bias.dtype).view(v_bias.shape), None, None, None,
                None)


def relpos_attention(q, k, v, p, u_bias, v_bias, lengths, scale=None,
                     rate=0.0, seed=None):
    """q, k, v (N, T, H, Dh); p (2T-1, H, Dh); u_bias, v_bias (H, Dh);
    lengths (N,): keys at or past an utterance's length are masked.
    Returns (N, T, H, Dh) with query rows past the length zero (the
    caller zeroes them anyway). seed: two 32-bit words, needed when
    rate > 0. Differentiable in q, k, v, p, u_bias and v_bias."""
    return _RelPosAttention.apply(q, k, v, p, u_bias, v_bias, lengths,
                                  scale, rate, seed)
