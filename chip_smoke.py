#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, any failure exits non-zero:
1. build: compile every CUDA kernel of cat_tpu_torch/csrc with nvcc, one
   process per source, all at once;
2. kernels: hold each kernel against its plain PyTorch version on the
   card. Forward kernels at the serving batch's shapes (attention also at
   a batch of at most 512 frames after subsampling); every kernel at the
   training batch's shapes, at dropout rates 0 and 0.1 (the plain
   versions draw the same Philox masks), with some rows of every
   utterance identical (as SpecAugment's time masks leave them after
   subsampling), constant or zero; the JSON records time the training
   batch at rate 0.1; no single PyTorch call computes any of these
   functions, so `library_ms` is null;
3. serving: the libri crf-v1 conformer (egs/libri/exp/crf-v1/config.json:
   17 cells, d=512, 8 heads, bf16; 72 classes) with seeded random weights
   decodes a ragged batch of 8 synthetic utterances through
   `cat_tpu_torch.ctc.decode.decode_batch` (greedy), and 2 of them with a
   width-16 prefix beam; the launch counters must show that every cell
   ran through the four forward kernels and no backward kernel; the same
   forward with every fused op on its plain version must agree with it;
4. train vs plain: one crf-v1 CTC-CRF train step (dropout 0.1,
   SpecAugment) on the serving batch with the kernels, the same step with
   every fused op, forward and backward, on its plain version, and the
   same plain step in float32 (the reference), all from one generator
   (the same masks and dropout seeds); loss, gradient norm, running
   statistics and every parameter's gradient must agree between the
   kernel and plain steps, and the kernel step may be no farther from the
   float32 step than the plain bf16 step is, in its gradient and in its
   logits, frame by frame, in the time-masked and in the other frames;
5. training: `cat_tpu_torch.ctc.train.make_train_step` trains the full
   crf-v1 model (CTC-CRF, lambda 0.01, 3-gram dense denominator over
   V=72, SpecAugment, dropout 0.1, Noam + Adam, clipping at 5) on 32
   utterances of 1200 + 25k frames (k = 0..31): 2 warm-up and 5 timed
   steps; losses finite, nothing skipped, exactly 34 FF, 17 glu_in, 17
   bn_out and 17 attention launches per step each way; step time, audio
   seconds trained per second, peak memory and the split of one step
   into encoder and loss;
6. device: the card's name and power limit.
With --profile, one serving forward and one train step also run under
torch.profiler; the device time by kernel is printed and written to
chiprun_out/profile.txt and chiprun_out/profile_train.txt.

The last two lines are the per-kernel JSON record and the result line
{"ok": true, "device": {...}}. Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
FRAMES = [2400, 1600, 1400, 1200, 1000, 800, 600, 400]  # ragged batch
TRAIN_FRAMES = [1200 + 25 * k for k in range(32)]       # training batch
LOGIT_TOL = 0.25             # 17-cell bf16 forward vs its plain version
# One bf16 train step through 17 cells against the same step on the plain
# versions, bf16 and float32, from one generator: loss, grad norm and
# running statistics, and the cosine of every parameter's gradient, kernel
# step vs plain bf16 step; and the kernel step's distance to the float32
# step, in its gradient and in its logits in the time-masked and the other
# frames, at most STEP_CONTROL times the plain bf16 step's (the control:
# an equally valid bf16 computation). See PERF.md and
# tools/torch_step_diag.py for draws at which no bf16 step can meet the
# cosine.
STEP_LOSS_REL, STEP_GNORM_REL, STEP_COS, STEP_STATS_REL = 1e-2, 5e-2, 0.99, 2e-2
STEP_CONTROL = 1.5
SEED = (0x0BADF00D, 0x5EED1234)
REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("ffn_fwd", "glu_in_fwd", "bn_out_fwd", "relpos_attention_fwd",
           "ffn_bwd", "glu_in_bwd", "bn_out_bwd", "relpos_attention_bwd")
PER_STEP = {"ffn_fwd": 34, "glu_in_fwd": 17, "bn_out_fwd": 17,
            "relpos_attention_fwd": 17, "ffn_bwd": 34, "glu_in_bwd": 17,
            "bn_out_bwd": 17, "relpos_attention_bwd": 17}
SERVE = {k: (v if k.endswith("_fwd") else 0) for k, v in PER_STEP.items()}
# biases whose exact gradient is 0, so both steps hold rounding noise
# there: the depthwise conv bias (re-centred by batch normalisation) and
# the key bias (the softmax cancels a score shared by every key)
NOISE_GRADS = ("conv.depthwise.bias", "mhsa.k.bias")


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, iters=20, warmup=3):
    """Milliseconds per call, CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes):
    return 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def compare(name, out, ref, rows=None):
    """Max-abs error of a bf16 output; fails beyond the elementwise
    tolerance of `cat_tpu_torch.utils.tolerance`."""
    import torch
    from cat_tpu_torch.utils import tolerance
    out, ref = out.float(), ref.float()
    if rows is not None:
        out, ref = out[rows], ref[rows]
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite output")
    bad = tolerance.beyond(out, ref)
    if bad:
        fail(f"{name}: {bad} elements beyond atol {tolerance.ATOL} + rtol "
             f"{tolerance.RTOL}, max abs err "
             f"{(out - ref).abs().max().item():.4g}")
    return (out - ref).abs().max().item()


def compare_rel(name, out, ref):
    """Max-abs error of an f32 sum over many rows; fails beyond the
    relative norm tolerance of `cat_tpu_torch.utils.tolerance`."""
    import torch
    from cat_tpu_torch.utils import tolerance
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite output")
    err, bound = tolerance.rel_error(out, ref)
    if err > bound:
        fail(f"{name}: error norm {err:.4g} > {bound:.4g}")
    return (out.float() - ref.float()).abs().max().item()


def phase_build():
    from cat_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} of {len(_build.SOURCES)} kernel libraries "
        f"compiled in {time.perf_counter() - t0:.1f} s "
        f"(nvcc -gencode arch=compute_90a,code=sm_90a)")
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/ptxas.txt", "w") as f:
        for name, text in logs.items():
            f.write(f"--- {name}\n{text}\n")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line and "0 bytes spill" not in line:
                log(f"[build] {name}: {line.strip()}")


def subsampled(frames):
    return max(((frames - 1) // 2 - 1) // 2, 1)


def wrappers():
    """Every kernel wrapper of the port by kernel name; each counts the
    launches of its kernel."""
    from cat_tpu_torch.ops import attention, conv_module, ffn
    return {"ffn_fwd": ffn.ff_forward, "ffn_bwd": ffn.ff_backward,
            "glu_in_fwd": conv_module.glu_in_forward,
            "glu_in_bwd": conv_module.glu_in_backward,
            "bn_out_fwd": conv_module.bn_out_forward,
            "bn_out_bwd": conv_module.bn_out_backward,
            "relpos_attention_fwd": attention.relpos_attention_forward,
            "relpos_attention_bwd": attention.relpos_attention_backward}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def counts():
    return {k: w.launches for k, w in wrappers().items()}


def plain_patches():
    """Every fused op, forward and backward, on its plain version."""
    from cat_tpu_torch.ops import attention, conv_module, ffn
    return {ffn: {"ff_forward": ffn.ff_reference,
                  "ff_backward": ffn.ff_backward_reference},
            conv_module: {
                "glu_in_forward": conv_module.glu_in_reference,
                "glu_in_backward": conv_module.glu_in_backward_reference,
                "bn_out_forward": conv_module.bn_out_reference,
                "bn_out_backward": conv_module.bn_out_backward_reference},
            attention: {
                "relpos_attention_forward":
                    attention.relpos_attention_reference_lse,
                "relpos_attention_backward":
                    attention.relpos_attention_backward_reference}}


class Records:
    def __init__(self):
        self.by_name = {}

    def add(self, name, source, replaces, err, k_ms, p_ms, flops, nbytes,
            what):
        b = bound_ms(flops, nbytes)
        by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES \
            else "bytes"
        log(f"[kernel] {name} {what}: max err {err:.4g}, kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b:.4f} ms ({by})")
        self.by_name.setdefault(name, {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None})


def _rnd(gen, *shape, s=1.0, dtype=None):
    import torch
    out = torch.randn(*shape, generator=gen, device="cuda") * s
    return out if dtype is None else out.to(dtype)


def phase_kernels(gen):
    """Forward kernels against their plain versions at the serving batch's
    shapes, at rate 0 (the serving path's shapes)."""
    import torch
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops import attention, conv_module, ffn

    dev, bf = "cuda", torch.bfloat16
    D, F, H = 512, 2048, 8
    Dh = D // H
    tl = [subsampled(f) for f in FRAMES]
    N, T = len(tl), max(tl)
    mask = length_mask(torch.tensor(tl, device=dev), T)

    # weight matrices in bf16 and vectors in f32, as the kernels read them
    x = _rnd(gen, N, T, D, dtype=bf)
    ffp = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, F, s=D ** -0.5, dtype=bf), _rnd(gen, F, s=0.1),
           _rnd(gen, F, D, s=F ** -0.5, dtype=bf), _rnd(gen, D, s=0.1))
    errs = {"ffn_fwd": compare("ffn_fwd", ffn.ff_forward(x, *ffp),
                               ffn.ff_reference(x, *ffp))}
    glp = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, 2 * D, s=D ** -0.5, dtype=bf), _rnd(gen, 2 * D, s=0.1))
    errs["glu_in_fwd"] = compare(
        "glu_in_fwd", conv_module.glu_in_forward(x, mask, *glp),
        conv_module.glu_in_reference(x, mask, *glp))
    c = _rnd(gen, N, T, D, dtype=bf)
    bnp = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
           1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, D, s=D ** -0.5, dtype=bf), _rnd(gen, D, s=0.1))
    errs["bn_out_fwd"] = compare(
        "bn_out_fwd", conv_module.bn_out_forward(c, x, mask, *bnp),
        conv_module.bn_out_reference(c, x, mask, *bnp))

    # rel-pos attention: the serving batch (T' > 512) and, without its
    # longest utterance, a batch of at most 512 frames
    for lens in (tl, tl[1:]):
        n, t = len(lens), max(lens)
        lt = torch.tensor(lens, device=dev)
        q, k, v = (_rnd(gen, n, t, H, Dh, dtype=bf) for _ in range(3))
        p = _rnd(gen, 2 * t - 1, H, Dh, s=0.5, dtype=bf)
        ub, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                          dtype=bf)
        args = (q, k, v, p, ub, vb, lt)
        out, _ = attention.relpos_attention_forward(*args)
        valid = length_mask(lt, t)
        errs[f"relpos_attention_fwd T'={t}"] = compare(
            f"relpos_attention_fwd T'={t}", out,
            attention.relpos_attention_reference(*args), valid)
        if not (out.float()[~valid] == 0).all():
            fail("relpos_attention_fwd: padded query rows are not zero")
    log(f"[kernel] forward kernels at the serving batch's shapes (N={N}, "
        f"T'={T}, D={D}), rate 0, agree with their plain versions; max abs "
        f"err " + ", ".join(f"{k} {e:.4g}" for k, e in errs.items()))


def special_rows(t):
    """t (N, T, ...) with, in every utterance, rows 21..59 equal to row 20
    (as frames that a SpecAugment time mask zeroed are after the
    subsampling), rows 60..69 constant across their values and rows
    70..74 zero."""
    t = t.clone()
    N = t.shape[0]
    t[:, 21:60] = t[:, 20:21]
    const = t[:, 60:70].reshape(N, 10, -1)
    t[:, 60:70] = const[..., :1].expand_as(const).reshape(t[:, 60:70].shape)
    t[:, 70:75] = 0
    return t


def phase_backward_kernels(gen, rec):
    """Backward kernels, and the forward kernels with dropout, against their
    plain versions at the training batch's shapes, rates 0 and 0.1, on
    inputs with identical, constant and zero rows (`special_rows`); the
    JSON records of all eight kernels are timed here at rate 0.1."""
    import torch
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops import attention, conv_module, ffn

    dev, bf = "cuda", torch.bfloat16
    D, F, H = 512, 2048, 8
    Dh = D // H
    tl = [subsampled(f) for f in TRAIN_FRAMES]
    N, T = len(tl), max(tl)
    R, Rv = N * T, sum(tl)
    lengths = torch.tensor(tl, device=dev)
    mask = length_mask(lengths, T)
    x, c, do = (special_rows(_rnd(gen, N, T, D, dtype=bf)) for _ in range(3))
    ffp = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, F, s=D ** -0.5, dtype=bf), _rnd(gen, F, s=0.1),
           _rnd(gen, F, D, s=F ** -0.5, dtype=bf), _rnd(gen, D, s=0.1))
    glp = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, 2 * D, s=D ** -0.5, dtype=bf), _rnd(gen, 2 * D, s=0.1))
    bnp = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
           1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, D, s=D ** -0.5, dtype=bf), _rnd(gen, D, s=0.1))
    q, k, v = (special_rows(_rnd(gen, N, T, H, Dh, dtype=bf))
               for _ in range(3))
    p = _rnd(gen, 2 * T - 1, H, Dh, s=0.5, dtype=bf)
    ub, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                      dtype=bf)
    att = (q, k, v, p, ub, vb, lengths)
    dao = special_rows(_rnd(gen, N, T, H, Dh) * mask[..., None, None]).to(bf)
    what = (f"N={N} T'={T} R={R} ({Rv} valid) D={D}, identical, constant "
            f"and zero rows")

    # rows of zero variance (the constant and zero rows of x): a layer
    # norm's backward multiplies them by 1/sqrt(eps) = 1000, so a one-step
    # rounding difference of a bf16 intermediate becomes a difference of
    # a few bf16 steps of values in the thousands, which near-cancelling
    # elements of dx do not absorb; there dx is held to the relative norm
    # tolerance, elsewhere to the elementwise one
    flat = x.float().var(-1) == 0

    def grads(name, got, want, rows=None):
        """d0 (bf16) elementwise, or on `rows` by relative norm; the f32
        sums d1.. by relative norm."""
        errs = [compare(f"{name} d0", got[0], want[0],
                        None if rows is None else ~rows)]
        if rows is not None:
            errs.append(compare_rel(f"{name} d0, zero-variance rows",
                                    got[0][rows], want[0][rows]))
        errs += [compare_rel(f"{name} d{i}", a, b)
                 for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1)]
        return max(errs)

    for rate in (0.0, 0.1):
        kw = dict(rate=rate, seed=SEED)
        tag = f"rate {rate}"
        # forward kernels with dropout at the training shapes
        compare(f"ffn_fwd {tag}", ffn.ff_forward(x, *ffp, **kw),
                ffn.ff_reference(x, *ffp, **kw))
        compare(f"bn_out_fwd {tag}",
                conv_module.bn_out_forward(c, x, mask, *bnp, **kw),
                conv_module.bn_out_reference(c, x, mask, *bnp, **kw))
        out, lse = attention.relpos_attention_forward(*att, **kw)
        ref_out, ref_lse = attention.relpos_attention_reference_lse(*att,
                                                                    **kw)
        compare(f"relpos_attention_fwd {tag}", out, ref_out, mask)
        vm = mask[:, None, :].expand_as(lse)
        compare(f"relpos_attention_fwd lse {tag}", lse[vm], ref_lse[vm])
        log(f"[kernel] forward kernels with dropout at the training batch, "
            f"{tag}: ffn, bn_out, attention (out and lse) agree")

        e_ff = grads(f"ffn_bwd {tag}", ffn.ff_backward(x, *ffp, do, **kw),
                     ffn.ff_backward_reference(x, *ffp, do, **kw), flat)
        e_glu = grads(f"glu_in_bwd {tag}",
                      conv_module.glu_in_backward(x, mask, *glp, do),
                      conv_module.glu_in_backward_reference(x, mask, *glp,
                                                            do), flat)
        e_bn = grads(f"bn_out_bwd {tag}",
                     conv_module.bn_out_backward(c, x, mask, *bnp, do, **kw),
                     conv_module.bn_out_backward_reference(c, x, mask, *bnp,
                                                           do, **kw))
        got = attention.relpos_attention_backward(*att, out, lse, dao, **kw)
        want = attention.relpos_attention_backward_reference(
            *att, out, lse, dao, **kw)
        e_att = max(compare(f"relpos_attention_bwd {tag} d{i}", a, b)
                    for i, (a, b) in enumerate(zip(got[:3], want[:3])))
        e_att = max([e_att] + [compare_rel(f"relpos_attention_bwd {tag} "
                                           f"d{i + 3}", a, b)
                               for i, (a, b) in enumerate(zip(got[3:],
                                                              want[3:]))])
        log(f"[kernel] backward kernels at the training batch, {tag}: max "
            f"err ffn {e_ff:.4g}, glu_in {e_glu:.4g}, bn_out {e_bn:.4g}, "
            f"attention {e_att:.4g} (max abs err over all outputs)")
        del got, want
        torch.cuda.empty_cache()
        if rate == 0.0:
            continue
        # the JSON records: the training batch at rate 0.1, as in training;
        # bounds count the valid rows and (query, key) pairs only
        sq = sum(L * L for L in tl)
        rec.add("ffn_fwd", "cat_tpu_torch/csrc/ffn_fwd.cu",
                "cat_tpu/ops/ffn_pallas.py:76",
                compare("ffn_fwd", ffn.ff_forward(x, *ffp, **kw),
                        ffn.ff_reference(x, *ffp, **kw)),
                timed(lambda: ffn.ff_forward(x, *ffp, **kw), 10, 2),
                timed(lambda: ffn.ff_reference(x, *ffp, **kw), 3, 1),
                4 * Rv * D * F, 2 * Rv * D * 2 + 2 * D * F * 2 + (3 * D + F) * 4,
                what + f" F={F} rate 0.1")
        rec.add("glu_in_fwd", "cat_tpu_torch/csrc/conv_module_fwd.cu",
                "cat_tpu/ops/conv_module_pallas.py:53",
                compare("glu_in_fwd", conv_module.glu_in_forward(x, mask, *glp),
                        conv_module.glu_in_reference(x, mask, *glp)),
                timed(lambda: conv_module.glu_in_forward(x, mask, *glp), 10, 2),
                timed(lambda: conv_module.glu_in_reference(x, mask, *glp), 3,
                      1),
                4 * Rv * D * D, 2 * Rv * D * 2 + Rv * 4 + 2 * D * D * 2 + 4 * D * 4,
                what + " (no dropout)")
        rec.add("bn_out_fwd", "cat_tpu_torch/csrc/conv_module_fwd.cu",
                "cat_tpu/ops/conv_module_pallas.py:237",
                compare("bn_out_fwd",
                        conv_module.bn_out_forward(c, x, mask, *bnp, **kw),
                        conv_module.bn_out_reference(c, x, mask, *bnp, **kw)),
                timed(lambda: conv_module.bn_out_forward(c, x, mask, *bnp,
                                                         **kw), 10, 2),
                timed(lambda: conv_module.bn_out_reference(c, x, mask, *bnp,
                                                           **kw), 3, 1),
                2 * Rv * D * D, 3 * Rv * D * 2 + Rv * 4 + D * D * 2 + 5 * D * 4,
                what + " rate 0.1")
        rec.add("relpos_attention_fwd",
                "cat_tpu_torch/csrc/relpos_attention_fwd.cu",
                "cat_tpu/ops/attention_pallas.py:563",
                compare("relpos_attention_fwd", out, ref_out, mask),
                timed(lambda: attention.relpos_attention_forward(*att, **kw),
                      10, 2),
                timed(lambda: attention.relpos_attention_reference_lse(
                    *att, **kw), 3, 1),
                6 * sq * Dh * H,
                (3 * Rv * D + (2 * T - 1) * D + Rv * D) * 2 + Rv * H * 4,
                f"N={N} T'={T} H={H} Dh={Dh} rate 0.1")
        rec.add("ffn_bwd", "cat_tpu_torch/csrc/ffn_bwd.cu",
                "cat_tpu/ops/ffn_pallas.py:104", e_ff,
                timed(lambda: ffn.ff_backward(x, *ffp, do, **kw), 10, 2),
                timed(lambda: ffn.ff_backward_reference(x, *ffp, do, **kw),
                      3, 1),
                10 * Rv * D * F,
                3 * Rv * D * 2 + 2 * D * F * 2 + 2 * D * F * 4
                + (4 * D + F) * 4 * 2, what + f" F={F}")
        rec.add("glu_in_bwd", "cat_tpu_torch/csrc/conv_module_bwd.cu",
                "cat_tpu/ops/conv_module_pallas.py:71", e_glu,
                timed(lambda: conv_module.glu_in_backward(x, mask, *glp, do),
                      10, 2),
                timed(lambda: conv_module.glu_in_backward_reference(
                    x, mask, *glp, do), 3, 1),
                12 * Rv * D * D,
                3 * Rv * D * 2 + Rv * 4 + 2 * D * D * (2 + 4) + 8 * D * 4,
                what)
        rec.add("bn_out_bwd", "cat_tpu_torch/csrc/conv_module_bwd.cu",
                "cat_tpu/ops/conv_module_pallas.py:261", e_bn,
                timed(lambda: conv_module.bn_out_backward(c, x, mask, *bnp, do,
                                                          **kw), 10, 2),
                timed(lambda: conv_module.bn_out_backward_reference(
                    c, x, mask, *bnp, do, **kw), 3, 1),
                4 * Rv * D * D,
                3 * Rv * D * 2 + Rv * 4 + D * D * (2 + 4) + 10 * D * 4, what)
        # eight L x L x Dh products per utterance and head (scores and
        # position scores recomputed, dO.V^T, dV, dK, dq's two, dp); q, k,
        # v, dO read and dq, dk, dv written for the valid rows, p read and
        # dp written once, lse and Delta read
        rec.add("relpos_attention_bwd",
                "cat_tpu_torch/csrc/relpos_attention_bwd.cu",
                "cat_tpu/ops/attention_pallas.py:624", e_att,
                timed(lambda: attention.relpos_attention_backward(
                    *att, out, lse, dao, **kw), 10, 2),
                timed(lambda: attention.relpos_attention_backward_reference(
                    *att, out, lse, dao, **kw), 3, 1),
                16 * sq * Dh * H,
                7 * Rv * D * 2 + (2 * T - 1) * D * (2 + 4) + 2 * Rv * H * 4,
                f"N={N} T'={T} H={H} Dh={Dh}")
    torch.cuda.empty_cache()


def load_config():
    with open(os.path.join(REPO, "egs/libri/exp/crf-v1/config.json")) as f:
        return json.load(f)


def perturb(model, gen):
    """Random biases, norm parameters and running statistics, so that the
    serving run exercises every term (kernels stay 1/fan_in normal)."""
    import torch
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            noise = torch.randn(t.shape, generator=gen) * 0.1
            if name.endswith("running_var"):
                t.copy_(1 + noise.abs().to(t.device))
            elif t.dim() == 1 or name.endswith(("u_bias", "v_bias")):
                base = 1.0 if name.endswith(("norm.weight", "norm_mhsa.weight",
                                             "norm_out.weight",
                                             "bn_scale")) else 0.0
                t.copy_((base + noise).to(t.device))


def phase_serving(cfg):
    import torch
    from cat_tpu_torch.ctc.decode import decode_batch, greedy_decode
    from cat_tpu_torch.ctc.train import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, num_classes=72, device="cuda", seed=0)
    perturb(model, torch.Generator().manual_seed(1))
    log(f"[serve] crf-v1 ConformerNet {cfg['encoder']['kwargs']} V=72: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(2)
    N, T = len(FRAMES), max(FRAMES)
    lengths = torch.tensor(FRAMES, device="cuda")
    feats = torch.randn(N, T, 80, generator=gen, device="cuda")
    feats *= (torch.arange(T, device="cuda")[None, :, None]
              < lengths[:, None, None])

    reset_counts()
    greedy = decode_batch(model, feats, lengths, "greedy")
    torch.cuda.synchronize()
    seen = counts()
    log(f"[serve] greedy decode of {N} utterances: launches {seen}")
    if seen != SERVE:
        fail(f"launch counts {seen} != {SERVE} for one forward")
    reset_counts()
    t = time.perf_counter()
    beam = decode_batch(model, feats[:2], lengths[:2], "beam",
                        beam_width=16)
    beam_s = time.perf_counter() - t
    if counts() != SERVE:
        fail(f"beam decode launch counts {counts()} != {SERVE}")
    for n in range(2):
        log(f"[serve] beam16 utt {n}: score {beam[n][0][0]:.3f}, "
            f"{len(beam[n][0][1])} tokens; greedy {len(greedy[n][0][1])} "
            f"tokens")
    log(f"[serve] beam16 decode of 2 utterances "
        f"({sum(FRAMES[:2]) * 0.01:.1f} audio s), forward and host search: "
        f"{beam_s * 1e3:.1f} ms host wall")

    with torch.inference_mode():
        logits, olen = model(feats, lengths)
        with ExitStack() as stack:
            for mod, fns in plain_patches().items():
                for name, fn in fns.items():
                    stack.enter_context(mock.patch.object(mod, name, fn))
            plain, plain_len = model(feats, lengths)
    torch.cuda.synchronize()
    Tp = max(subsampled(f) for f in FRAMES)
    if tuple(logits.shape) != (N, Tp, 72) or logits.dtype != torch.float32:
        fail(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not torch.isfinite(logits).all():
        fail("non-finite logits")
    if not torch.equal(olen, plain_len):
        fail("output lengths differ from the plain forward")
    valid = torch.arange(Tp, device="cuda")[None, :] < olen[:, None]
    diff = (logits - plain).abs()[valid].max().item()
    scale = plain.abs()[valid].max().item()
    agree = sum(a == b for a, b in zip(
        greedy_decode(torch.log_softmax(plain, -1), plain_len),
        [list(g[0][1]) for g in greedy]))
    same_best = (logits.argmax(-1) == plain.argmax(-1))[valid]
    log(f"[serve] logits vs plain forward: max abs diff {diff:.4g} "
        f"(tol {LOGIT_TOL}; max |logit| {scale:.3g}); identical greedy "
        f"hypotheses {agree}/{N}; same best class in "
        f"{same_best.sum().item()}/{same_best.numel()} frames, "
        f"{logits.argmax(-1)[valid].unique().numel()} distinct")
    if not diff <= LOGIT_TOL:
        fail(f"forward logits differ from the plain forward by {diff}")

    def forward():
        with torch.inference_mode():
            model(feats, lengths)

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    fwd_ms = timed(forward, iters=5, warmup=1)
    t = time.perf_counter()
    decode_batch(model, feats, lengths, "greedy")
    greedy_ms = (time.perf_counter() - t) * 1e3
    audio_s = sum(FRAMES) * 0.01
    log(f"[serve] forward of {N} utterances ({audio_s:.1f} audio s): "
        f"{fwd_ms:.2f} ms (CUDA events, 5 runs); host wall "
        f"{[round(w * 1e3, 2) for w in walls]} ms; "
        f"{audio_s / (fwd_ms / 1e3):.1f} audio-s/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; greedy "
        f"decode_batch {greedy_ms:.2f} ms host wall")
    return forward


def make_batch(frames, seed, device="cuda"):
    """Features numpy-normal from `seed`, labels U_n = T'_n // 4 ids in
    1..71, weights 1."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    N, T = len(frames), max(frames)
    feats = rng.standard_normal((N, T, 80)).astype(np.float32)
    feats *= np.arange(T)[None, :, None] < np.array(frames)[:, None, None]
    llens = np.array([subsampled(f) // 4 for f in frames])
    labels = rng.integers(1, 72, (N, llens.max()))
    labels *= np.arange(llens.max())[None, :] < llens[:, None]
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return {"feats": t(feats, torch.float32),
            "feat_lengths": t(frames, torch.int64),
            "labels": t(labels, torch.int64),
            "label_lengths": t(llens, torch.int64),
            "weight": torch.ones(N, device=device)}


def make_den():
    """The 3-gram phone denominator over V=72, built as bench.py builds
    the JAX package's: train_ngram over 300 random phone sequences."""
    import numpy as np
    from cat_tpu_torch.fst.ngram import train_ngram
    from cat_tpu_torch.ops.crf_dense import DenseDen
    rng = np.random.default_rng(0)
    seqs = [list(map(int, rng.integers(1, 72, size=int(rng.integers(5, 30)))))
            for _ in range(300)]
    return DenseDen.from_ngram(train_ngram(seqs, order=3), num_classes=72)


def time_masked(masks, frames, Tp):
    """(N, T') bool on the CPU: the subsampled frames whose whole receptive
    field (input frames 4t'..4t'+6) lies in a SpecAugment time mask."""
    import torch
    pos = torch.arange(max(frames))[None, None, :]
    s, w = masks["time_starts"][:, :, None], masks["time_widths"][:, :, None]
    tm = ((pos >= s) & (pos < s + w)).any(1).float()
    win = tm.unfold(1, 7, 4).amin(-1) > 0
    out = torch.zeros(tm.shape[0], Tp, dtype=torch.bool)
    n = min(Tp, win.shape[1])
    out[:, :n] = win[:, :n]
    return out


def train_step_once(model, start, cfg, den, batch, patches=None, f32=False,
                    specaug=True):
    """One crf-v1 train step from the weights and statistics `start`, with
    the fused ops patched by `patches` ({module: {name: fn}}) and, with
    `f32`, the forward in float32 throughout (the plain versions then run
    in float32). The SpecAugment masks and dropout seeds come from a
    generator of seed 5. Returns the loss, grad norm and skipped flag, the
    unclipped gradients, the updated buffers, the logits and the loss's
    gradient at them."""
    import torch
    from cat_tpu_torch.ctc.train import init_state, make_train_step
    from cat_tpu_torch.utils.scheduler import build_scheduler

    model.load_state_dict(start)
    seen = {}

    def hook(_m, _i, out):
        out[0].retain_grad()
        seen["logits"] = out[0]

    def forward32(x, lengths, gen=None):
        h, lengths = model.subsampling(x, lengths, torch.float32)
        h = model.dropout(h, gen)
        for cell in model.cells:
            h = cell(h, lengths, gen)
        return model.classifier(h, torch.float32), lengths

    sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
    tr = cfg["trainer"]
    step = make_train_step(model, opt, tr["loss"], den, tr["lamb"],
                           cfg["specaug"] if specaug else None, grad_clip=5.0)
    with ExitStack() as stack:
        for mod, fns in (patches or {}).items():
            for name, fn in fns.items():
                stack.enter_context(mock.patch.object(mod, name, fn))
        if f32:
            stack.enter_context(mock.patch.object(model, "forward",
                                                  forward32))
        stack.callback(model.register_forward_hook(hook).remove)
        _, m = step(init_state(model, opt), batch, sched.lr,
                    torch.Generator().manual_seed(5))
    gn = m["grad_norm"].item()
    unclip = max(1.0, (gn + 1e-6) / 5.0)
    logits = seen["logits"]
    return {"loss": m["loss"].item(), "grad_norm": gn,
            "skipped": m["skipped"],
            "grads": {n: (p.grad.detach().float() * unclip
                          if p.grad is not None else torch.zeros_like(p))
                      for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "logits": logits.detach().float(),
            "dlogits": logits.grad.detach().float()}


def phase_train_vs_plain(cfg, den):
    """One train step with the kernels against the same step on every
    fused op's plain version, in bf16 and in float32, from the same
    weights and generator (the same SpecAugment masks and dropout
    seeds)."""
    import torch
    from cat_tpu_torch.ctc.train import build_model
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops.specaug import draw_masks

    model = build_model(cfg, num_classes=72, device="cuda", seed=0)
    perturb(model, torch.Generator().manual_seed(1))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch(FRAMES, seed=3)
    reset_counts()
    k = train_step_once(model, start, cfg, den, batch)
    if counts() != PER_STEP:
        fail(f"train step launch counts {counts()} != {PER_STEP}")
    p = train_step_once(model, start, cfg, den, batch, plain_patches())
    r = train_step_once(model, start, cfg, den, batch, plain_patches(),
                        f32=True)
    if counts() != PER_STEP:
        fail("a kernel launched while every fused op was patched to its "
             "plain version")
    if k["skipped"] or p["skipped"] or r["skipped"]:
        fail("a train step was skipped (non-finite loss or grad norm)")

    def cosine(a, b):
        a, b = a.flatten().double(), b.flatten().double()
        return (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()

    names = [n for n in k["grads"] if not n.endswith(NOISE_GRADS)]
    cos = {n: cosine(k["grads"][n], p["grads"][n]) for n in names}
    worst = min(cos, key=cos.get)
    flat = lambda d: torch.cat([d["grads"][n].flatten() for n in names])
    gk, gp, gr = flat(k), flat(p), flat(r)
    dist = {"kernels": (gk - gr).norm().item() / gr.norm().item(),
            "plain": (gp - gr).norm().item() / gr.norm().item()}
    # the logits, frame by frame, in the frames a SpecAugment time mask
    # covered (the step's own draw, the first from its generator) and in
    # the other valid frames
    Tp = k["logits"].shape[1]
    valid = length_mask(torch.tensor([subsampled(f) for f in FRAMES],
                                     device="cuda"), Tp)
    masks = draw_masks(torch.Generator().manual_seed(5),
                       batch["feat_lengths"], 80, **cfg["specaug"])
    tm = time_masked(masks, FRAMES, Tp).to("cuda")
    logit_dist = {}
    for region, m in (("time-masked", tm & valid), ("other", ~tm & valid)):
        ref = r["logits"][m]
        ek, ep = ((d["logits"][m] - ref).norm() / ref.norm() for d in (k, p))
        logit_dist[region] = (int(m.sum()), ek.item(), ep.item())
    stats_rel = max(((k["buffers"][n] - p["buffers"][n]).norm()
                     / p["buffers"][n].norm()).item() for n in k["buffers"])
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    gn_rel = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
    log(f"[step] crf-v1 train step on the serving batch (dropout 0.1, "
        f"SpecAugment), kernels / plain bf16 / plain float32: loss "
        f"{k['loss']:.6g} / {p['loss']:.6g} / {r['loss']:.6g} (kernels vs "
        f"plain rel {loss_rel:.3g}, tol {STEP_LOSS_REL}); grad norm "
        f"{k['grad_norm']:.6g} / {p['grad_norm']:.6g} / "
        f"{r['grad_norm']:.6g} (rel {gn_rel:.3g}, tol {STEP_GNORM_REL}); "
        f"running statistics rel {stats_rel:.3g} (tol {STEP_STATS_REL})")
    log(f"[step] gradient cosine, kernels vs plain bf16, over {len(cos)} "
        f"tensors: min {cos[worst]:.5f} ({worst}), median "
        f"{sorted(cos.values())[len(cos) // 2]:.5f} (tol {STEP_COS}; "
        f"exact-zero bias gradients not gated)")
    log(f"[step] distance to the float32 step: gradient kernels "
        f"{dist['kernels']:.4g}, plain bf16 {dist['plain']:.4g}; logits "
        + "; ".join(f"{reg} frames ({n}) kernels {ek:.4g}, plain {ep:.4g}"
                    for reg, (n, ek, ep) in logit_dist.items())
        + f" (kernels within {STEP_CONTROL}x plain)")
    if loss_rel > STEP_LOSS_REL or gn_rel > STEP_GNORM_REL \
            or stats_rel > STEP_STATS_REL or cos[worst] < STEP_COS:
        fail("the kernel train step does not agree with the plain one")
    if dist["kernels"] > STEP_CONTROL * dist["plain"] or any(
            ek > STEP_CONTROL * ep for _, ek, ep in logit_dist.values()):
        fail("the kernel train step is farther from the float32 step than "
             f"{STEP_CONTROL}x the plain bf16 step")
    del model, k, p, r
    torch.cuda.empty_cache()


def phase_training(cfg, den, profile):
    """The main path: train steps of the full crf-v1 model."""
    import torch
    from cat_tpu_torch.ctc.train import (build_model, init_state,
                                         make_train_step)
    from cat_tpu_torch.ops.crf_dense import ctc_crf_loss_dense
    from cat_tpu_torch.utils.scheduler import build_scheduler

    model = build_model(cfg, num_classes=72, device="cuda", seed=0)
    sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
    tr = cfg["trainer"]
    step = make_train_step(model, opt, tr["loss"], den, tr["lamb"],
                           cfg["specaug"], grad_clip=5.0)
    batch = make_batch(TRAIN_FRAMES, seed=6)
    audio_s = sum(TRAIN_FRAMES) * 0.01
    tl = [subsampled(f) for f in TRAIN_FRAMES]
    log(f"[train] batch: {len(TRAIN_FRAMES)} utterances of "
        f"{min(TRAIN_FRAMES)}..{max(TRAIN_FRAMES)} frames ("
        f"{sum(TRAIN_FRAMES)} frames, {audio_s:.1f} audio s), T' "
        f"{min(tl)}..{max(tl)}, labels "
        f"{batch['label_lengths'].min().item()}.."
        f"{batch['label_lengths'].max().item()}")
    state = init_state(model, opt)
    gen = torch.Generator().manual_seed(7)
    reset_counts()
    events, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(7):
        sched.update_lr_step(state.step + 1)
        before = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        state, m = step(state, batch, sched.lr, gen)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ms = start.elapsed_time(end)
        per = {k: v - before[k] for k, v in counts().items()}
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        log(f"[train] step {i + 1} ({'warm-up' if i < 2 else 'timed'}): "
            f"loss {loss:.5g}, grad norm {gn:.5g}, skipped {m['skipped']}, "
            f"{ms:.1f} ms (CUDA events), {wall * 1e3:.1f} ms host wall")
        if per != PER_STEP:
            fail(f"train step launch counts {per} != {PER_STEP}")
        if m["skipped"] or not (torch.isfinite(m["loss"])
                                and torch.isfinite(m["grad_norm"])):
            fail(f"train step {i + 1}: non-finite loss or grad norm")
        if i >= 2:
            events.append(ms)
            walls.append(wall)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean_ms = sum(events) / len(events)
    log(f"[train] {len(events)} timed steps: {mean_ms:.1f} ms per step "
        f"(CUDA events; {min(events):.1f}..{max(events):.1f}), host wall "
        f"{1e3 * sum(walls) / len(walls):.1f} ms; "
        f"{audio_s / (mean_ms / 1e3):.1f} audio-s/s trained; peak memory "
        f"{peak:.2f} GiB; launches per step {PER_STEP}")

    # the split of one step: encoder forward, loss forward, loss backward
    # (to the log-probs), encoder backward
    model.train()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    ev[0].record()
    logits, olen = model(batch["feats"], batch["feat_lengths"], gen)
    lp_enc = torch.log_softmax(logits.float(), dim=-1)
    ev[1].record()
    lp = lp_enc.detach().requires_grad_()
    loss = ctc_crf_loss_dense(lp, batch["labels"], olen,
                              batch["label_lengths"], den, tr["lamb"])
    ev[2].record()
    loss.backward()
    ev[3].record()
    lp_enc.backward(lp.grad)
    ev[4].record()
    torch.cuda.synchronize()
    part = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    log(f"[train] one step split (CUDA events, ms): encoder forward "
        f"{part[0]:.1f}, loss forward {part[1]:.1f}, loss backward "
        f"{part[2]:.1f}, encoder backward {part[3]:.1f}; encoder fwd+bwd "
        f"{part[0] + part[3]:.1f}, loss fwd+bwd {part[1] + part[2]:.1f}")
    if profile:
        phase_profile(lambda: step(state, batch, sched.lr, gen),
                      "one train step", "chiprun_out/profile_train.txt")
    return launches


def phase_profile(fn, what, path):
    """Device time of fn() by kernel (torch.profiler), and the device's
    busy share over the span from its first kernel's start to its last
    kernel's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # warm the profiler up
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("[profile] the profiler recorded no device time: not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in spans) - spans[0][0]
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    rows = sorted(((t, n, k) for k, (t, n) in by_name.items()), reverse=True)
    total = sum(r[0] for r in rows)
    lines = [f"{t:10.1f} us {100 * t / total:5.1f}% {n:6d}x  {k}"
             for t, n, k in rows]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    log(f"[profile] {what}: {len(kernels)} kernels, device time "
        f"{total / 1e3:.3f} ms over a span of {span / 1e3:.3f} ms; busy "
        f"share {busy / span:.3f}")
    for line in lines[:20]:
        log(f"[profile] {line[:150]}")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in sys.argv[1:]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()

    phase_build()
    rec = Records()
    phase_kernels(torch.Generator(device="cuda").manual_seed(0))
    phase_backward_kernels(torch.Generator(device="cuda").manual_seed(1), rec)
    cfg = load_config()
    forward = phase_serving(cfg)
    if profile:
        phase_profile(forward, "one serving forward",
                      "chiprun_out/profile.txt")
    del forward
    torch.cuda.empty_cache()
    t = time.perf_counter()
    den = make_den()
    log(f"[train] dense 3-gram denominator over V=72 built in "
        f"{time.perf_counter() - t:.1f} s")
    phase_train_vs_plain(cfg, den)
    launches = phase_training(cfg, den, profile)
    records = [rec.by_name[k] for k in KERNELS]
    for r in records:
        r["launches"] = launches[r["name"]]
    log(f"[env] whole run {time.perf_counter() - t_all:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    if "jax" in sys.modules:
        fail("jax was imported")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
