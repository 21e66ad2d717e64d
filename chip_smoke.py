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
   versions draw the same Philox masks; attention's out and lse at
   both batches, through its Dh = 64 wgmma route), with some rows of every
   utterance identical (as SpecAugment's time masks leave them after
   subsampling), constant or zero; the JSON records time the training
   batch at rate 0.1; no single PyTorch call computes any of these
   functions, so `library_ms` is null; the FF, glu_in and bn_out
   forwards' and backwards' launches inside one call (torch.profiler;
   the forwards at both batches, bn_out's backward too, the FF forward
   beside its two products alone by `torch.matmul`) and two calls of
   each, and of the attention forward (both batches), bit for bit; the
   attention backward through its Dh = 64 wgmma route (the dq pass, the
   reduce and the dK/dV pass: the three launches' device split, which
   must show each of them and no wmma backward kernel, and all six
   outputs of two calls bit for bit, at both rates); then the loss
   path's kernels at the training batch (N = 32, T' = 299..493, U =
   74..123, V = 72, the 3-gram denominator of `make_den`): the
   standalone dropout bit for bit
   (and `torch.nn.functional.dropout` timed beside it), CTC alphas and
   betas (the lanes route of `ctc_plan` at the training batch, the frames
   route on a lattice of S = 2049, N = 2, T' = 40; two calls of each bit
   for bit) on live states within 1e-3 + 2e-6·|plain| and the rest floored
   on both sides, the CTC log-likelihood and the den logZ to 1e-5
   relative, the den snapshots to 1e-5 relative on live states, the CTC
   and den gradient rows within 1e-3 + 1e-3·|plain| (CTC beside
   `torch.nn.functional.ctc_loss`, forward and forward + backward; no
   single call computes the dense denominator); the den kernels' plan
   (blocks a cluster, utterances a cluster, where the expW slices live,
   shared memory a block) and two calls of each den kernel bit for bit;
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
   the kernel step runs the encoder and the loss (dropout, CTC, dense
   denominator) on kernels, the plain steps neither;
5. fold: two micro-steps of `make_train_step(..., grad_accum_fold=2)` on
   the serving batch: `applied` 0 then 1, the parameters unmoved by the
   first, both finite, the kernels' launch counts per micro-step;
6. training: `cat_tpu_torch.ctc.train.make_train_step` trains the full
   crf-v1 model (CTC-CRF, lambda 0.01, 3-gram dense denominator over
   V=72, SpecAugment, dropout 0.1, Noam + Adam, clipping at 5) on 32
   utterances of 1200 + 25k frames (k = 0..31): 2 warm-up and 5 timed
   steps; losses finite, nothing skipped, exactly 34 FF, 17 glu_in, 17
   bn_out and 17 attention launches per step each way, 2 dropout (its
   forward and backward), 1 CTC alpha, 1 CTC beta, 1 den forward and 1
   den backward; step time, audio seconds trained per second, peak
   memory and the split of one step into encoder and loss;
6b. manager: the training loop (`cat_tpu_torch.utils.manager.Manager`)
   trains the full crf-v1 model (as phase 6, at `grad_accum_fold` 2, cut
   from crf-v1's 16) for one epoch of a packed split (256 utterances of
   800..2400 frames, `pack_speech_data`; dev 32) through
   `BucketedLoader` at crf-v1's loader options (frame budget 51,200, 8
   buckets, seed 0), check_freq 3: every micro-step launches exactly the
   kernels of phase 6 and every eval batch the four forward kernels, 1
   CTC alpha and 1 den forward (EVAL); losses finite; the lr at micro-step
   k is Noam's at ceil(k / 2). The step-3 checkpoint, taken mid-fold,
   loads into a fresh Manager (model from another seed) bit for bit
   (parameters, running statistics, Adam moments and steps, fold sums,
   weight and count); a run resumed from it (given the generator's state
   at step 3, which the Manager does not checkpoint) ends with run A's
   global step, epoch, scheduler state_dict, checkpoint names and
   batches (cuDNN's and PyTorch's deterministic algorithms are on for the
   phase). Then the LSTM encoder of egs/template/exp/asr-ctc trains 3
   Manager steps (1 CTC alpha and 1 beta a step) until a fixed stop.
   Step ms (CUDA events) and host wall, the Manager's data_s and step_s,
   collate ms a batch and the phase's seconds are printed;
7. RNN-T kernels: the lattice recursions of `ops/rnnt.py` against their
   plain versions at the rnnt-v1 training batch (the training batch's
   T' = 299..493, labels U = T'//6 ids in 1..1023, V = 1024, tables of
   log-softmaxed random logits; the wavefront route of `rnnt_plan`):
   states as the CTC ones and log-likelihoods to 1e-5 relative, against
   the f32 plain versions and against the same plain versions on f64
   copies of the tables (the witness); gradient rows within 1e-3 +
   1e-3·|witness| of the witness's (the f32 plain version's own lie about
   twice that far from it at this batch; both distances are printed);
   and at edge shapes on both routes (U+1 of 1 to 1024 on the wavefront,
   1025 and 1500 on the row scan, T' = 1, label length 0), against both;
   two calls of each bit for bit; no PyTorch call computes an RNN-T loss
   (torchaudio is absent), so `library_ms` is null. The bounds of the CTC
   and RNN-T recursions take a third term beside operations and bytes:
   their chain of dependent steps times t_step, the latency of one step of
   the kernel's own arithmetic measured in this run (`rnnt.chain_floor`,
   `ctc.chain_floor`);
8. RNN-T serving: the libri rnnt-v1 transducer (egs/libri/exp/rnnt-v1:
   the crf-v1 encoder without its classifier, a 640-wide LSTM predictor,
   a 512-wide "add" joiner, V = 1024) greedy-decodes the serving batch
   and beam-searches (width 16) two of its utterances; the counters must
   show the four encoder forward kernels and nothing else;
9. RNN-T train vs plain: one rnnt-v1 train step on the serving batch, as
   phase 4 (the encoder output in place of the logits);
10. RNN-T training: `cat_tpu_torch.rnnt.train.make_train_step` trains the
   full rnnt-v1 model (SpecAugment, dropout 0.1, Noam + Adam, clipping at
   5) on the training batch's 32 utterances: 2 warm-up and 5 timed steps;
   exactly the encoder launches of phase 6, 2 dropout, 1 rnnt_alpha, 1
   rnnt_beta and no CTC or den kernel per step; step time, audio-s/s,
   peak memory and the split of one step;
11. device: the card's name and power limit.
With --profile, one serving forward and the two train steps also run
under torch.profiler; the device time by kernel is printed and written to
chiprun_out/profile.txt, profile_train.txt and profile_rnnt_train.txt.
Annotation ranges on the device's timeline, such as the optimizer step's,
are printed on a line of their own, outside the device time and the busy
share.

The last two lines are the per-kernel JSON record and the result line
{"ok": true, "device": {...}}. Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
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
           "ffn_bwd", "glu_in_bwd", "bn_out_bwd", "relpos_attention_bwd",
           "dropout", "ctc_alpha", "ctc_beta", "den_fwd", "den_bwd",
           "rnnt_alpha", "rnnt_beta")
# launches per train step: crf-v1 (PER_STEP) and rnnt-v1 (RNNT_STEP); the
# serving forward of either model runs the four encoder forward kernels
PER_STEP = {"ffn_fwd": 34, "glu_in_fwd": 17, "bn_out_fwd": 17,
            "relpos_attention_fwd": 17, "ffn_bwd": 34, "glu_in_bwd": 17,
            "bn_out_bwd": 17, "relpos_attention_bwd": 17, "dropout": 2,
            "ctc_alpha": 1, "ctc_beta": 1, "den_fwd": 1, "den_bwd": 1,
            "rnnt_alpha": 0, "rnnt_beta": 0}
RNNT_STEP = {k: (v if k in KERNELS[:9] else 0) for k, v in PER_STEP.items()}
RNNT_STEP.update(rnnt_alpha=1, rnnt_beta=1)
SERVE = {k: (v if k in KERNELS[:4] else 0) for k, v in PER_STEP.items()}
RNNT_V = 1024  # rnnt-v1's unigram vocabulary (hyper-p.json)
# the loss kernels against their plain versions (f32): lattice states
# within 1e-3 + 2e-6·|plain| (the values reach about -2e3 for CTC and
# -4e3 for RNN-T at T' = 493, where one f32 step is 2.4e-4 and 4.9e-4),
# snapshots, log-likelihoods and logZ to 1e-5 relative, gradient rows
# (posteriors exp(alpha + beta - ll), in which a one-step difference of a
# deep alpha shows as ~5e-4 relative) within 1e-3 + 1e-3·|plain|; values
# at or below LOG_EPS / 2 are zeros
STATE_ATOL, STATE_RTOL, LL_RTOL, GRAD_TOL = 1e-3, 2e-6, 1e-5, 1e-3
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


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS, chain_ms=0.0):
    return max(1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES, chain_ms)


def step_floors():
    """t_step in ms by kind ("rnnt", "ctc"): the latency of one dependent
    step of each lattice recursion, its kernel's own arithmetic walked with
    no loads (`rnnt.chain_floor`, `ctc.chain_floor`) on 32 blocks of one
    warp, from the times of 10 x 575 and 575 steps."""
    import torch
    from cat_tpu_torch.ops import ctc, rnnt
    out = torch.empty(32, 32, device="cuda")
    floors = {}
    for kind, mod in (("rnnt", rnnt), ("ctc", ctc)):
        ms = [timed(lambda: mod.chain_floor(out, k * 575), 20, 3)
              for k in (1, 10)]
        floors[kind] = (ms[1] - ms[0]) / (9 * 575)
        log(f"[kernel] dependent-step floor of the {kind} recursion: "
            f"{floors[kind] * 1e6:.2f} ns a step (575 steps {ms[0]:.4f} ms, "
            f"5750 steps {ms[1]:.4f} ms; 32 blocks of one warp, no loads)")
    return floors


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
    from cat_tpu_torch.ops import (attention, conv_module, crf_dense, ctc,
                                   dropout, ffn, rnnt)
    return {"ffn_fwd": ffn.ff_forward, "ffn_bwd": ffn.ff_backward,
            "glu_in_fwd": conv_module.glu_in_forward,
            "glu_in_bwd": conv_module.glu_in_backward,
            "bn_out_fwd": conv_module.bn_out_forward,
            "bn_out_bwd": conv_module.bn_out_backward,
            "relpos_attention_fwd": attention.relpos_attention_forward,
            "relpos_attention_bwd": attention.relpos_attention_backward,
            "dropout": dropout.dropout_apply,
            "ctc_alpha": ctc.forward_alphas,
            "ctc_beta": ctc.backward_betas,
            "den_fwd": crf_dense.den_forward,
            "den_bwd": crf_dense.den_backward,
            "rnnt_alpha": rnnt.forward_alphas,
            "rnnt_beta": rnnt.backward_betas}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def counts():
    return {k: w.launches for k, w in wrappers().items()}


def plain_patches():
    """Every kernel wrapper, forward and backward, on its plain version."""
    from cat_tpu_torch.ops import (attention, conv_module, crf_dense, ctc,
                                   dropout, ffn, rnnt)
    return {dropout: {"dropout_apply": dropout.dropout_reference},
            rnnt: {"forward_alphas": rnnt.forward_alphas_reference,
                   "backward_betas": rnnt.backward_betas_reference},
            ctc: {"forward_alphas": ctc.forward_alphas_reference,
                  "backward_betas": ctc.backward_betas_reference},
            crf_dense: {"den_forward": crf_dense.den_forward_reference,
                        "den_backward": crf_dense.den_backward_reference},
            ffn: {"ff_forward": ffn.ff_reference,
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
            what, peak=PEAK_BF16_FLOPS, library_ms=None, chain=None):
        """chain: (dependent steps, t_step ms) of a recursion, whose product
        bounds it beside operations and bytes; a dependent chain of
        operations, it counts as bound by operations."""
        ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
        chain_ms = chain[0] * chain[1] if chain else 0.0
        b = bound_ms(flops, nbytes, peak, chain_ms)
        by = "operations" if max(ops_ms, chain_ms) >= bytes_ms else "bytes"
        how = by
        if chain:
            how += (f"; chain {chain[0]} steps x {chain[1] * 1e6:.2f} ns = "
                    f"{chain_ms:.4f} ms"
                    + (", the larger term" if chain_ms >= max(ops_ms, bytes_ms)
                       else ""))
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"[kernel] {name} {what}: max err {err:.4g}, kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms{lib}, bound {b:.4f} ms "
            f"({how})")
        self.by_name.setdefault(name, {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by,
            "library_ms": library_ms})


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
    split_and_repro("ffn_fwd", lambda: ffn.ff_forward(x, *ffp),
                    f"serving batch, R={N * T}, rate 0")
    ffn_fwd_products(x, ffp, "serving batch")
    glp = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, 2 * D, s=D ** -0.5, dtype=bf), _rnd(gen, 2 * D, s=0.1))
    errs["glu_in_fwd"] = compare(
        "glu_in_fwd", conv_module.glu_in_forward(x, mask, *glp),
        conv_module.glu_in_reference(x, mask, *glp))
    split_and_repro("glu_in_fwd",
                    lambda: conv_module.glu_in_forward(x, mask, *glp),
                    f"serving batch, R={N * T}")
    c = _rnd(gen, N, T, D, dtype=bf)
    bnp = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
           1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
           _rnd(gen, D, D, s=D ** -0.5, dtype=bf), _rnd(gen, D, s=0.1))
    errs["bn_out_fwd"] = compare(
        "bn_out_fwd", conv_module.bn_out_forward(c, x, mask, *bnp),
        conv_module.bn_out_reference(c, x, mask, *bnp))
    split_and_repro("bn_out_fwd",
                    lambda: conv_module.bn_out_forward(c, x, mask, *bnp),
                    f"serving batch, R={N * T}, rate 0")
    do = _rnd(gen, N, T, D, dtype=bf)
    split_and_repro("bn_out_bwd",
                    lambda: conv_module.bn_out_backward(
                        c, x, mask, *bnp, do, rate=0.1, seed=SEED),
                    f"serving batch, R={N * T}, rate 0.1, "
                    f"{conv_module.bn_out_plan(N * T, D).splits} wgrad splits")

    # rel-pos attention: the serving batch (T' > 512) and, without its
    # longest utterance, a batch of at most 512 frames; out and lse at
    # rates 0 and 0.1, on the Dh = 64 route
    for lens in (tl, tl[1:]):
        n, t = len(lens), max(lens)
        lt = torch.tensor(lens, device=dev)
        q, k, v = (_rnd(gen, n, t, H, Dh, dtype=bf) for _ in range(3))
        p = _rnd(gen, 2 * t - 1, H, Dh, s=0.5, dtype=bf)
        ub, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                          dtype=bf)
        args = (q, k, v, p, ub, vb, lt)
        valid = length_mask(lt, t)
        for rate in (0.0, 0.1):
            kw = dict(rate=rate, seed=SEED)
            before = attention.relpos_attention_forward.routes["wgmma"]
            out, lse = attention.relpos_attention_forward(*args, **kw)
            if attention.relpos_attention_forward.routes["wgmma"] != \
                    before + 1:
                fail("relpos_attention_fwd: Dh = 64 did not take the "
                     "wgmma route")
            ref_out, ref_lse = attention.relpos_attention_reference_lse(
                *args, **kw)
            tag = f"relpos_attention_fwd T'={t} rate {rate}"
            errs[tag] = compare(tag, out, ref_out, valid)
            vm = valid[:, None, :].expand_as(lse)
            errs[f"{tag} lse"] = compare(f"{tag} lse", lse[vm], ref_lse[vm])
            if not (out.float()[~valid] == 0).all() or lse[~vm].any():
                fail("relpos_attention_fwd: padded query rows are not zero")
        split_and_repro("relpos_attention_fwd",
                        lambda: attention.relpos_attention_forward(
                            *args, rate=0.1, seed=SEED),
                        f"N={n} T'={t} H={H} Dh={Dh}, rate 0.1")
    log(f"[kernel] forward kernels at the serving batch's shapes (N={N}, "
        f"T'={T}, D={D}), rate 0 (attention also 0.1), agree with their "
        f"plain versions; max abs "
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


# the launches inside one call of each staged kernel (csrc/ffn_fwd.cu,
# ffn_bwd.cu, glu_in.cu, bn_out.cu), and of the attention forward's and
# backward's Dh = 64 routes
STAGES = {"relpos_attention_fwd": ("wgmma",),
          "relpos_attention_bwd": ("dq_wgmma", "reduce", "dkdv_wgmma"),
          "ffn_fwd": ("ln", "up", "down"),
          "ffn_bwd": ("prep", "up", "down", "ln", "wgrad", "reduce"),
          "glu_in_fwd": ("ln", "up"),
          "glu_in_bwd": ("prep", "up", "down", "ln", "wgrad", "reduce"),
          "bn_out_fwd": ("rows", "product"),
          "bn_out_bwd": ("prep", "down", "wgrad", "reduce")}


def split_and_repro(name, call, what, calls=5):
    """The launches inside one call of a staged kernel (`STAGES`), device
    ms by kernel name from torch.profiler over `calls` calls, where each
    stage must show device time and no other kernel of its own (named
    `name`_...) may run; and two calls on the same inputs, which must
    give the same bits (no atomics)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    split, other = dict.fromkeys(STAGES[name], 0.0), 0.0
    strays = set()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        stage = next((st for st in split if f"{name}_{st}(" in e.name
                      or f"{name}_{st}<" in e.name), None)
        if stage is None:
            other += us
            if f"{name}_" in e.name:
                strays.add(e.name[:100])
        else:
            split[stage] += us
    if sum(split.values()) == 0:
        log(f"[kernel] {name} split of one call ({what}): the profiler "
            f"recorded no device time: not measured")
    else:
        log(f"[kernel] {name} split of one call ({what}; device ms, "
            f"torch.profiler, {calls} calls): " + ", ".join(
                f"{k} {v / calls / 1e3:.4f}" for k, v in split.items())
            + f"; other {other / calls / 1e3:.4f}; sum "
            f"{(sum(split.values()) + other) / calls / 1e3:.4f}")
        missing = [st for st, us in split.items() if us == 0]
        if missing or strays:
            fail(f"{name} ({what}): stages without device time {missing}, "
                 f"other kernels of its own {sorted(strays)}")
    first, second = call(), call()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[kernel] {name} bitwise reproducible over two calls ({what}): "
        f"{same}")
    if not same:
        fail(f"{name}: two calls on the same inputs differ")


def ffn_fwd_products(x, ffp, what):
    """The FF forward's two products alone by torch.matmul at its shapes
    (bf16, (R, D) . (D, F) and (R, F) . (F, D)): a reference line beside
    the kernel's split, not a library time of the FF module."""
    import torch
    D, F = ffp[2].shape
    h = x.reshape(-1, D)
    a1 = torch.empty(h.shape[0], F, dtype=h.dtype, device=h.device)
    up = timed(lambda: torch.matmul(h, ffp[2], out=a1), 10, 2)
    down = timed(lambda: torch.matmul(a1, ffp[4]), 10, 2)
    log(f"[kernel] ffn_fwd's products alone by torch.matmul ({what}): up "
        f"{up:.4f} ms, down {down:.4f} ms, sum {up + down:.4f} ms")


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
        split_and_repro("relpos_attention_fwd",
                        lambda: attention.relpos_attention_forward(*att, **kw),
                        f"training batch, {tag}")

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
        before = attention.relpos_attention_backward.routes["wgmma"]
        got = attention.relpos_attention_backward(*att, out, lse, dao, **kw)
        if attention.relpos_attention_backward.routes["wgmma"] != before + 1:
            fail("relpos_attention_bwd: Dh = 64 did not take the wgmma "
                 "route")
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
        split_and_repro("relpos_attention_bwd",
                        lambda: attention.relpos_attention_backward(
                            *att, out, lse, dao, **kw),
                        f"training batch, {tag}")
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
        rec.add("glu_in_fwd", "cat_tpu_torch/csrc/glu_in.cu",
                "cat_tpu/ops/conv_module_pallas.py:53",
                compare("glu_in_fwd", conv_module.glu_in_forward(x, mask, *glp),
                        conv_module.glu_in_reference(x, mask, *glp)),
                timed(lambda: conv_module.glu_in_forward(x, mask, *glp), 10, 2),
                timed(lambda: conv_module.glu_in_reference(x, mask, *glp), 3,
                      1),
                4 * Rv * D * D, 2 * Rv * D * 2 + Rv * 4 + 2 * D * D * 2 + 4 * D * 4,
                what + " (no dropout)")
        rec.add("bn_out_fwd", "cat_tpu_torch/csrc/bn_out.cu",
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
                f"N={N} T'={T} H={H} Dh={Dh} rate 0.1, "
                f"{attention.fwd_route(Dh)} route")
        rec.add("ffn_bwd", "cat_tpu_torch/csrc/ffn_bwd.cu",
                "cat_tpu/ops/ffn_pallas.py:104", e_ff,
                timed(lambda: ffn.ff_backward(x, *ffp, do, **kw), 10, 2),
                timed(lambda: ffn.ff_backward_reference(x, *ffp, do, **kw),
                      3, 1),
                10 * Rv * D * F,
                3 * Rv * D * 2 + 2 * D * F * 2 + 2 * D * F * 4
                + (4 * D + F) * 4 * 2, what + f" F={F}")
        split_and_repro("ffn_bwd",
                        lambda: ffn.ff_backward(x, *ffp, do, **kw),
                        f"training batch, rate {rate}")
        split_and_repro("ffn_fwd", lambda: ffn.ff_forward(x, *ffp, **kw),
                        f"training batch, rate {rate}")
        ffn_fwd_products(x, ffp, "training batch")
        rec.add("glu_in_bwd", "cat_tpu_torch/csrc/glu_in.cu",
                "cat_tpu/ops/conv_module_pallas.py:71", e_glu,
                timed(lambda: conv_module.glu_in_backward(x, mask, *glp, do),
                      10, 2),
                timed(lambda: conv_module.glu_in_backward_reference(
                    x, mask, *glp, do), 3, 1),
                12 * Rv * D * D,
                3 * Rv * D * 2 + Rv * 4 + 2 * D * D * (2 + 4) + 8 * D * 4,
                what)
        split_and_repro("glu_in_bwd",
                        lambda: conv_module.glu_in_backward(x, mask, *glp, do),
                        "training batch")
        split_and_repro("glu_in_fwd",
                        lambda: conv_module.glu_in_forward(x, mask, *glp),
                        "training batch")
        rec.add("bn_out_bwd", "cat_tpu_torch/csrc/bn_out.cu",
                "cat_tpu/ops/conv_module_pallas.py:261", e_bn,
                timed(lambda: conv_module.bn_out_backward(c, x, mask, *bnp, do,
                                                          **kw), 10, 2),
                timed(lambda: conv_module.bn_out_backward_reference(
                    c, x, mask, *bnp, do, **kw), 3, 1),
                4 * Rv * D * D,
                3 * Rv * D * 2 + Rv * 4 + D * D * (2 + 4) + 10 * D * 4, what)
        split_and_repro("bn_out_bwd",
                        lambda: conv_module.bn_out_backward(c, x, mask, *bnp,
                                                            do, **kw),
                        f"training batch, rate {rate}, "
                        f"{conv_module.bn_out_plan(R, D).splits} wgrad "
                        f"splits")
        split_and_repro("bn_out_fwd",
                        lambda: conv_module.bn_out_forward(c, x, mask, *bnp,
                                                           **kw),
                        f"training batch, rate {rate}")
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
                f"N={N} T'={T} H={H} Dh={Dh} rate 0.1, "
                f"{attention.bwd_route(Dh)} route")
    torch.cuda.empty_cache()


def close_states(name, got, want, atol, rtol):
    """Max abs error of f32 log-domain states over the plain version's live
    ones (above LOG_EPS / 2); fails unless those agree within atol +
    rtol·|plain| and the others lie at or below LOG_EPS / 2 in both."""
    from cat_tpu_torch.ops.semiring import LOG_EPS
    if got.isnan().any():
        fail(f"{name}: NaN in the kernel's output")
    live = want > LOG_EPS / 2
    if (got[~live] > LOG_EPS / 2).any():
        fail(f"{name}: states floored in the plain version are live in the "
             f"kernel's output")
    err = (got - want)[live].abs()
    bad = int((err > atol + rtol * want[live].abs()).sum())
    if bad:
        fail(f"{name}: {bad} live states beyond {atol} + {rtol}·|plain|, max "
             f"abs err {err.max().item():.4g}")
    return err.max().item() if err.numel() else 0.0


def close_rows(name, got, want):
    """Max abs error of f32 gradient rows; fails beyond GRAD_TOL +
    GRAD_TOL·|plain| anywhere."""
    if not got.isfinite().all():
        fail(f"{name}: non-finite gradient")
    err = (got - want).abs()
    bad = int((err > GRAD_TOL + GRAD_TOL * want.abs()).sum())
    if bad:
        fail(f"{name}: {bad} elements beyond {GRAD_TOL} + {GRAD_TOL}·|plain|, "
             f"max abs err {err.max().item():.4g}")
    return err.max().item()


def close_rel(name, got, want):
    rel = ((got - want).abs() / want.abs()).max().item()
    if not rel <= LL_RTOL:
        fail(f"{name}: relative error {rel:.3g} > {LL_RTOL}")
    return (got - want).abs().max().item()


def phase_loss_kernels(gen, rec, den, floors):
    """The loss path's kernels against their plain versions at the
    training batch; the JSON records of all five, the CTC recursions'
    bounds with their chain of T' dependent steps (`step_floors`)."""
    import torch
    import torch.nn.functional as F
    from cat_tpu_torch.ops import crf_dense, ctc, dropout

    tl = [subsampled(f) for f in TRAIN_FRAMES]
    N, T, V, D = len(tl), max(tl), 72, 512
    Rv = sum(tl)
    lens = torch.tensor(tl, device="cuda")
    batch = make_batch(TRAIN_FRAMES, seed=6)
    labels, llens = batch["labels"], batch["label_lengths"]
    lp = torch.log_softmax(_rnd(gen, N, T, V, s=2.0), -1)
    what = f"N={N} T'={min(tl)}..{T} V={V}"

    # the standalone dropout: its forward and, through the autograd
    # Function, its backward, bit for bit, at the post-subsampling shape
    x = _rnd(gen, N, T, D, dtype=torch.bfloat16)
    for rate in (0.1, 0.5):
        if not torch.equal(dropout.dropout_apply(x, rate, SEED),
                           dropout.dropout_reference(x, rate, SEED)):
            fail(f"dropout rate {rate}: the kernel's output is not the plain "
                 f"version's, bit for bit")
    xg = x.clone().requires_grad_()
    gy = _rnd(gen, N, T, D, dtype=torch.bfloat16)
    dropout.dropout(xg, 0.1, SEED).backward(gy)
    if not torch.equal(xg.grad, dropout.dropout_reference(gy, 0.1, SEED)):
        fail("dropout backward: not the plain version's mask, bit for bit")
    rec.add("dropout", "cat_tpu_torch/csrc/dropout.cu",
            "cat_tpu/ops/dropout_pallas.py:44", 0.0,
            timed(lambda: dropout.dropout_apply(x, 0.1, SEED), 20, 3),
            timed(lambda: dropout.dropout_reference(x, 0.1, SEED), 3, 1),
            0, 2 * x.numel() * 2,
            f"({N}, {T}, {D}) bf16, rate 0.1, bit-exact forward and backward",
            library_ms=timed(lambda: F.dropout(x, 0.1, True), 20, 3))

    # CTC: the lattice of the training batch's labels (the lanes route of
    # `ctc_plan`), then a lattice of S = 2049 (the frames route)
    S = 2 * labels.shape[1] + 1
    plan = ctc.ctc_plan(S)
    log(f"[kernel] ctc plan at the crf-v1 batch (S = {S}): route "
        f"{plan.route}, {plan.warps} warps of one state a thread")

    def ctc_case(tag, lp_, labels_, lens_, llens_):
        """Both CTC kernels against their plain versions (states, the
        log-likelihoods, the gradient rows) and two calls bit for bit;
        returns (em, allow2, allow2_dst, beta_last) and the errors."""
        S_ = 2 * labels_.shape[1] + 1
        ext, svalid, allow2 = ctc._lattice_tables(labels_, llens_, 0, S_)
        em = ctc._emissions(lp_, ext, svalid, lens_, 0)
        allow2_dst, beta_last = ctc._beta_tables(allow2, llens_)
        alphas = ctc.forward_alphas(em, allow2)
        betas = ctc.backward_betas(em, allow2_dst, beta_last)
        plain_a = ctc.forward_alphas_reference(em, allow2)
        e_a = close_states(f"ctc_alpha {tag}", alphas, plain_a, STATE_ATOL,
                           STATE_RTOL)
        close_rel(f"ctc log-likelihood {tag}",
                  ctc._final_ll(alphas[-1], llens_),
                  ctc._final_ll(plain_a[-1], llens_))
        e_b = close_states(f"ctc_beta {tag}", betas,
                           ctc.backward_betas_reference(em, allow2_dst,
                                                        beta_last),
                           STATE_ATOL, STATE_RTOL)
        if not (torch.equal(ctc.forward_alphas(em, allow2), alphas)
                and torch.equal(ctc.backward_betas(em, allow2_dst,
                                                   beta_last), betas)):
            fail(f"ctc {tag}: two calls on the same inputs differ")

        def ctc_grad():
            xl = lp_.clone().requires_grad_()
            ctc.ctc_loss(xl, labels_, lens_, llens_,
                         reduction="sum").backward()
            return xl.grad

        e_g = close_rows(f"ctc gradient rows {tag}", ctc_grad(),
                         patched(plain_patches(), ctc_grad))
        log(f"[kernel] ctc_alpha, ctc_beta {tag} ({ctc.ctc_plan(S_).route} "
            f"route): max abs err alpha {e_a:.4g}, beta {e_b:.4g}, gradient "
            f"rows {e_g:.4g}; bitwise reproducible over two calls: True, "
            f"True")
        return (em, allow2, allow2_dst, beta_last), (e_a, e_b, e_g)

    wide_lens = torch.tensor([40, 33], device="cuda")
    wide_ll = torch.tensor([1024, 15], device="cuda")
    wide_labels = torch.randint(1, V, (2, 1024), generator=gen,
                                device="cuda")
    wide_labels *= torch.arange(1024, device="cuda")[None, :] < wide_ll[:,
                                                                        None]
    if ctc.ctc_plan(2049).route != "frames":
        fail("ctc: S = 2049 does not take the frames route")
    ctc_case("N=2 T'=40 S=2049 U=1024,15", torch.log_softmax(
        _rnd(gen, 2, 40, V, s=2.0), -1), wide_labels, wide_lens, wide_ll)
    (em, allow2, allow2_dst, beta_last), (e_a, e_b, e_g) = ctc_case(
        f"crf-v1 batch S={S}", lp, labels, lens, llens)
    lib_in = lp.transpose(0, 1).detach().requires_grad_()

    def library(backward):
        loss = F.ctc_loss(lib_in, labels, lens, llens, reduction="sum")
        if backward:
            loss.backward()

    # bytes: em read and the states written; about 12 f32 operations a
    # state and frame (three exp, a log, adds and maxima)
    nbytes = 2 * em.numel() * 4 + allow2.numel()
    sw = (f"{what} S={S} U={llens.min().item()}..{llens.max().item()}, "
          f"{plan.route} route, W={plan.warps}")
    rec.add("ctc_alpha", "cat_tpu_torch/csrc/ctc.cu",
            "cat_tpu/ops/ctc_pallas.py:55", max(e_a, e_g),
            timed(lambda: ctc.forward_alphas(em, allow2), 10, 2),
            timed(lambda: ctc.forward_alphas_reference(em, allow2), 1, 1),
            12 * em.numel(), nbytes, sw, PEAK_F32_FLOPS,
            timed(lambda: library(False), 10, 2), (T, floors["ctc"]))
    rec.add("ctc_beta", "cat_tpu_torch/csrc/ctc.cu",
            "cat_tpu/ops/ctc_pallas.py:73", max(e_b, e_g),
            timed(lambda: ctc.backward_betas(em, allow2_dst, beta_last), 10,
                  2),
            timed(lambda: ctc.backward_betas_reference(em, allow2_dst,
                                                       beta_last), 1, 1),
            12 * em.numel(), nbytes + beta_last.numel() * 4, sw,
            PEAK_F32_FLOPS, timed(lambda: library(True), 10, 2),
            (T, floors["ctc"]))
    log(f"[kernel] ctc alphas, betas and gradient rows agree with the plain "
        f"versions (max abs err over live states: alpha {e_a:.4g}, beta "
        f"{e_b:.4g}; gradient rows {e_g:.4g}); library_ms: "
        f"F.ctc_loss forward (alpha) and forward + backward (beta)")
    del em, lib_in

    # the dense denominator: snapshots, logZ, gradient rows
    (s_in, s_bl), logz = crf_dense.den_forward(lp, lens, den)
    (p_in, p_bl), plain_z = crf_dense.den_forward_reference(lp, lens, den)
    e_z = close_rel("den logZ", logz, plain_z)
    e_s = max(close_states(f"den snapshots {k}", a, b, 0.0, LL_RTOL)
              for k, a, b in (("in", s_in, p_in), ("bl", s_bl, p_bl)))
    g = 1 + 0.5 * _rnd(gen, N).abs()
    snaps = (s_in, s_bl)
    grad = crf_dense.den_backward(lp, lens, snaps, logz, g, den)
    e_d = close_rows("den gradient rows", grad, crf_dense.den_backward_reference(
        lp, lens, (p_in, p_bl), plain_z, g, den))
    log(f"[kernel] den logZ (max abs err {e_z:.4g}), snapshots ({e_s:.4g}) "
        f"and gradient rows ({e_d:.4g}) agree with the plain versions")
    for bwd, name in ((False, "den_fwd"), (True, "den_bwd")):
        clusters = crf_dense._cluster_count(den, lens.device, bwd)
        plan = crf_dense.den_plan(lens, V, clusters, bwd)
        log(f"[kernel] {name} plan: clusters of C={plan.C} blocks, G="
            f"{plan.G} utterances a cluster, {plan.groups} clusters, expW "
            f"slice in {'shared memory' if plan.w_smem else 'L2'}, "
            f"{plan.smem_bytes} bytes of shared memory a block; the card "
            f"holds {clusters} such clusters")
    (r_in, r_bl), r_z = crf_dense.den_forward(lp, lens, den)
    same = [torch.equal(s_in, r_in) and torch.equal(s_bl, r_bl)
            and torch.equal(logz, r_z),
            torch.equal(grad, crf_dense.den_backward(lp, lens, snaps, logz,
                                                     g, den))]
    log(f"[kernel] den_fwd, den_bwd bitwise reproducible over two calls "
        f"(training batch): {same[0]}, {same[1]}")
    if not all(same):
        fail("den kernels: two calls on the same inputs differ")
    del r_in, r_bl
    # two (V, V, V) contractions a valid frame forward, twice that
    # backward (the recompute and the beta contraction)
    flops = 2 * 2 * V ** 3 * Rv
    tables = (V ** 3 + V * V) * 4 + N * 8
    fwd_bytes = lp.numel() * 4 + 2 * s_in.numel() * 4 + tables + N * 4
    dw = f"{what} K={den.ckpt_every} 3-gram; {Rv} valid frames"
    rec.add("den_fwd", "cat_tpu_torch/csrc/crf_dense.cu",
            "cat_tpu/ops/crf_dense_pallas.py:76", max(e_z, e_s),
            timed(lambda: crf_dense.den_forward(lp, lens, den), 5, 1),
            timed(lambda: crf_dense.den_forward_reference(lp, lens, den), 1,
                  0), flops, fwd_bytes, dw, PEAK_F32_FLOPS)
    rec.add("den_bwd", "cat_tpu_torch/csrc/crf_dense.cu",
            "cat_tpu/ops/crf_dense.py:321", e_d,
            timed(lambda: crf_dense.den_backward(lp, lens, snaps, logz, g,
                                                 den), 5, 1),
            timed(lambda: crf_dense.den_backward_reference(
                lp, lens, snaps, logz, g, den), 1, 0),
            2 * flops, fwd_bytes + N * 4 + lp.numel() * 4, dw,
            PEAK_F32_FLOPS)
    torch.cuda.empty_cache()


def patched(patches, fn):
    """fn() with the module attributes of `patches` replaced."""
    with ExitStack() as stack:
        for mod, fns in patches.items():
            for name, f in fns.items():
                stack.enter_context(mock.patch.object(mod, name, f))
        return fn()


def load_config(name="crf-v1"):
    with open(os.path.join(REPO, f"egs/libri/exp/{name}/config.json")) as f:
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


def make_batch(frames, seed, device="cuda", vocab=72, frames_per_label=4):
    """Features numpy-normal from `seed`, labels U_n = T'_n //
    frames_per_label ids in 1..vocab-1, weights 1."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    N, T = len(frames), max(frames)
    feats = rng.standard_normal((N, T, 80)).astype(np.float32)
    feats *= np.arange(T)[None, :, None] < np.array(frames)[:, None, None]
    llens = np.array([subsampled(f) // frames_per_label for f in frames])
    labels = rng.integers(1, vocab, (N, llens.max()))
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


def forward32(encoder):
    """The ConformerNet `encoder`'s forward in float32 throughout (its fused
    ops then take their plain versions in float32)."""
    import torch

    def forward(x, lengths, gen=None):
        h, lengths = encoder.subsampling(x, lengths, torch.float32)
        h = encoder.dropout(h, gen)
        for cell in encoder.cells:
            h = cell(h, lengths, gen)
        if encoder.classifier is not None:
            h = encoder.classifier(h, torch.float32)
        return h, lengths

    return forward


def step_once(model, start, make_step, batch, encoder, patches=None,
              f32=False):
    """One train step, built by `make_step()` -> (step, lr, optimizer), from
    the weights and statistics `start`, with the fused ops patched by
    `patches` ({module: {name: fn}}) and, with `f32`, the encoder in
    float32 throughout. The SpecAugment masks and dropout seeds come from a
    generator of seed 5.
    Returns the loss, grad norm and skipped flag, the unclipped gradients,
    the updated buffers, and under "logits" and "dlogits" the encoder's
    output (a CTC model's logits) and the loss's gradient at it."""
    import torch
    from cat_tpu_torch.ctc.train import init_state

    model.load_state_dict(start)
    seen = {}

    def hook(_m, _i, out):
        out[0].retain_grad()
        seen["out"] = out[0]

    with ExitStack() as stack:
        for mod, fns in (patches or {}).items():
            for name, fn in fns.items():
                stack.enter_context(mock.patch.object(mod, name, fn))
        if f32:
            stack.enter_context(mock.patch.object(encoder, "forward",
                                                  forward32(encoder)))
        stack.callback(encoder.register_forward_hook(hook).remove)
        step, lr, opt = make_step()
        _, m = step(init_state(model, opt), batch, lr,
                    torch.Generator().manual_seed(5))
    gn = m["grad_norm"].item()
    unclip = max(1.0, (gn + 1e-6) / 5.0)
    out = seen["out"]
    return {"loss": m["loss"].item(), "grad_norm": gn,
            "skipped": m["skipped"],
            "grads": {n: (p.grad.detach().float() * unclip
                          if p.grad is not None else torch.zeros_like(p))
                      for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "logits": out.detach().float(),
            "dlogits": out.grad.detach().float()}


def train_step_once(model, start, cfg, den, batch, patches=None, f32=False,
                    specaug=True):
    """One crf-v1 train step (`step_once`), SpecAugment optional."""
    from cat_tpu_torch.ctc.train import make_train_step
    from cat_tpu_torch.utils.scheduler import build_scheduler

    def make_step():
        sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
        tr = cfg["trainer"]
        return make_train_step(model, opt, tr["loss"], den, tr["lamb"],
                               cfg["specaug"] if specaug else None,
                               grad_clip=5.0), sched.lr, opt

    return step_once(model, start, make_step, batch, model, patches, f32)


def steps_agree(what, run, batch, specaug_cfg, per_step, out_name):
    """One train step with the kernels, `run(None, False)`, against the
    same step on every kernel's plain version (the encoder's fused ops,
    the dropout and the losses) in bf16, `run(plain_patches(), False)`,
    and in float32, `run(plain_patches(), True)`, all from the same
    weights and generator (the same SpecAugment masks and dropout seeds);
    fails unless they meet the gates of STEP_* and STEP_CONTROL."""
    import torch
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops.specaug import draw_masks

    reset_counts()
    k = run(None, False)
    if counts() != per_step:
        fail(f"{what} train step launch counts {counts()} != {per_step}")
    p = run(plain_patches(), False)
    r = run(plain_patches(), True)
    if counts() != per_step:
        fail("a kernel launched while every kernel wrapper was patched to "
             "its plain version")
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
    # the encoder's output, frame by frame, in the frames a SpecAugment
    # time mask covered (the step's own draw, the first from its
    # generator) and in the other valid frames
    frames = batch["feat_lengths"].tolist()
    Tp = k["logits"].shape[1]
    valid = length_mask(torch.tensor([subsampled(f) for f in frames],
                                     device="cuda"), Tp)
    masks = draw_masks(torch.Generator().manual_seed(5),
                       batch["feat_lengths"], 80, **specaug_cfg)
    tm = time_masked(masks, frames, Tp).to("cuda")
    out_dist = {}
    for region, m in (("time-masked", tm & valid), ("other", ~tm & valid)):
        ref = r["logits"][m]
        ek, ep = ((d["logits"][m] - ref).norm() / ref.norm() for d in (k, p))
        out_dist[region] = (int(m.sum()), ek.item(), ep.item())
    stats_rel = max(((k["buffers"][n] - p["buffers"][n]).norm()
                     / p["buffers"][n].norm()).item() for n in k["buffers"])
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    gn_rel = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
    log(f"[step] {what} train step on the serving batch (dropout 0.1, "
        f"SpecAugment), kernels / plain bf16 / plain float32: loss "
        f"{k['loss']:.6g} / {p['loss']:.6g} / {r['loss']:.6g} (kernels vs "
        f"plain rel {loss_rel:.3g}, tol {STEP_LOSS_REL}); grad norm "
        f"{k['grad_norm']:.6g} / {p['grad_norm']:.6g} / "
        f"{r['grad_norm']:.6g} (rel {gn_rel:.3g}, tol {STEP_GNORM_REL}); "
        f"running statistics rel {stats_rel:.3g} (tol {STEP_STATS_REL})")
    log(f"[step] {what} gradient cosine, kernels vs plain bf16, over "
        f"{len(cos)} tensors: min {cos[worst]:.5f} ({worst}), median "
        f"{sorted(cos.values())[len(cos) // 2]:.5f} (tol {STEP_COS}; "
        f"exact-zero bias gradients not gated)")
    log(f"[step] {what} distance to the float32 step: gradient kernels "
        f"{dist['kernels']:.4g}, plain bf16 {dist['plain']:.4g}; {out_name} "
        + "; ".join(f"{reg} frames ({n}) kernels {ek:.4g}, plain {ep:.4g}"
                    for reg, (n, ek, ep) in out_dist.items())
        + f" (kernels within {STEP_CONTROL}x plain)")
    if loss_rel > STEP_LOSS_REL or gn_rel > STEP_GNORM_REL \
            or stats_rel > STEP_STATS_REL or cos[worst] < STEP_COS:
        fail(f"the {what} kernel train step does not agree with the plain "
             "one")
    if dist["kernels"] > STEP_CONTROL * dist["plain"] or any(
            ek > STEP_CONTROL * ep for _, ek, ep in out_dist.values()):
        fail(f"the {what} kernel train step is farther from the float32 step "
             f"than {STEP_CONTROL}x the plain bf16 step")


def phase_train_vs_plain(cfg, den):
    """One crf-v1 train step with the kernels against the plain versions in
    bf16 and in float32 (`steps_agree`)."""
    import torch
    from cat_tpu_torch.ctc.train import build_model

    model = build_model(cfg, num_classes=72, device="cuda", seed=0)
    perturb(model, torch.Generator().manual_seed(1))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch(FRAMES, seed=3)
    steps_agree("crf-v1", lambda patches, f32: train_step_once(
        model, start, cfg, den, batch, patches, f32), batch, cfg["specaug"],
        PER_STEP, "logits")
    del model
    torch.cuda.empty_cache()


def phase_fold(cfg, den):
    """Two micro-steps of a fold-2 crf-v1 train step on the serving batch:
    the first applies nothing, the second the fold's update."""
    import torch
    from cat_tpu_torch.ctc.train import (build_model, init_state,
                                         make_train_step)
    from cat_tpu_torch.utils.scheduler import build_scheduler

    model = build_model(cfg, num_classes=72, device="cuda", seed=0)
    sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
    tr = cfg["trainer"]
    step = make_train_step(model, opt, tr["loss"], den, tr["lamb"],
                           cfg["specaug"], grad_clip=5.0, grad_accum_fold=2)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, gen = init_state(model, opt), torch.Generator().manual_seed(10)
    for i in range(2):
        reset_counts()
        state, m = step(state, make_batch(FRAMES, seed=8 + i), sched.lr, gen)
        torch.cuda.synchronize()
        if counts() != PER_STEP:
            fail(f"fold micro-step {i + 1}: launch counts {counts()} != "
                 f"{PER_STEP}")
        moved = [n for n, p in model.named_parameters()
                 if not torch.equal(p, start[n])]
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        log(f"[fold] grad_accum_fold=2, micro-step {i + 1}: loss {loss:.5g}, "
            f"fold grad norm {gn:.5g}, applied {m['applied']}, skipped "
            f"{m['skipped']}, {len(moved)} of {len(start)} parameters moved")
        if m["applied"] != i or m["skipped"] or not (
                torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
            fail(f"fold micro-step {i + 1}: applied {m['applied']}, skipped "
                 f"{m['skipped']}, loss {loss}, grad norm {gn}")
        if (i == 0 and moved) or (i == 1 and len(moved) < len(start) // 2):
            fail(f"fold micro-step {i + 1}: {len(moved)} parameters moved")
    del model, opt, state
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


EVAL = {k: (1 if k in ("ctc_alpha", "den_fwd") else v)
        for k, v in SERVE.items()}  # one crf-v1 eval batch
MANAGER_FOLD = 2  # crf-v1 trains at grad_accum_fold 16: cut to 2


def pack_split(path, n, seed, frames=(800, 2400), dim=80, vocab=72,
               frames_per_label=4, subsample=True):
    """A packed split (`cat_tpu_torch.utils.data.pack_speech_data`) of `n`
    utterances: frames uniform in `frames`, features numpy-normal from
    `seed`, labels U = T' // frames_per_label ids in 1..vocab-1 (T' the
    subsampled length, or T), as `make_batch` draws them."""
    import numpy as np
    from cat_tpu_torch.utils.data import pack_speech_data
    rng = np.random.default_rng(seed)

    def utterances():
        for i in range(n):
            T = int(rng.integers(frames[0], frames[1] + 1))
            U = (subsampled(T) if subsample else T) // frames_per_label
            yield (f"s{seed}-{i:04d}",
                   rng.standard_normal((T, dim), dtype=np.float32),
                   [int(c) for c in rng.integers(1, vocab, U)])

    return pack_speech_data(path, utterances())


class Probe:
    """Wraps a Manager's train and eval steps: each call's launches (the
    counters' change), CUDA-event ms and host wall, the lr it was given,
    its metrics; the uids of every batch trained on; the seconds of each
    checkpoint write."""

    def __init__(self, mgr):
        import torch
        self.train, self.evals, self.uids, self.saves = [], [], [], []
        step, evaluate, transform = (mgr.train_step, mgr.eval_step,
                                     mgr.batch_transform)
        ckpt_save = mgr.ckpt.save

        def save(*args):
            t = time.perf_counter()
            name = ckpt_save(*args)
            self.saves.append(time.perf_counter() - t)
            return name

        mgr.ckpt.save = save

        def run(fn, *args):
            before = counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev[0].record()
            out = fn(*args)
            ev[1].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            per = {k: v - before[k] for k, v in counts().items()}
            return out, per, ev[0].elapsed_time(ev[1]), wall

        def train_step(state, batch, lr, gen):
            # the Manager transforms each batch just before its step
            self.uids.append(self.last_uids)
            (state, m), per, ms, wall = run(step, state, batch, lr, gen)
            self.train.append(dict(lr=lr, launches=per, ms=ms, wall=wall,
                                   loss=m["loss"].item(),
                                   applied=m.get("applied", 1),
                                   skipped=m["skipped"]))
            return state, m

        def eval_step(state, batch):
            m, per, ms, wall = run(evaluate, state, batch)
            self.evals.append(dict(launches=per, ms=ms,
                                   loss_sum=m["loss_sum"].item()))
            return m

        def batch_transform(b):
            self.last_uids = list(b.uids)
            return transform(b)

        mgr.train_step, mgr.eval_step = train_step, eval_step
        mgr.batch_transform = batch_transform


def state_tensors(tree, prefix=""):
    """{path: CPU copy} of every tensor of a (nested) state dict, and
    {path: value} of every other leaf."""
    import torch
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(state_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(state_tensors(v, f"{prefix}/{i}"))
    else:
        out[prefix] = (tree.detach().to("cpu", copy=True)
                       if isinstance(tree, torch.Tensor) else tree)
    return out


def bitwise_diff(got, want):
    """Paths of `want` (from `state_tensors`) whose value `got` does not
    hold bit for bit, with its dtype."""
    import torch
    bad = sorted(set(got) ^ set(want))
    for k, w in want.items():
        g = got.get(k)
        if isinstance(w, torch.Tensor):
            if not (isinstance(g, torch.Tensor) and g.dtype == w.dtype
                    and torch.equal(g, w)):
                bad.append(k)
        elif g != w:
            bad.append(k)
    return bad


def phase_manager(cfg, den):
    """[manager] The training loop: crf-v1 (full width and depth) trains
    one epoch of a packed 256-utterance split under the port's Manager
    (crf-v1's loader options, Noam + Adam, check_freq 3, fold 2): every
    micro-step's and eval batch's launches, finite losses, the lr at each
    step; the step-3 checkpoint into a fresh Manager bit for bit; a run
    resumed from it against the uninterrupted one. Then the LSTM encoder
    of egs/template/exp/asr-ctc for 3 Manager steps. Splits and
    checkpoints live under build/manager and are removed at the end."""
    import shutil
    import numpy as np
    import torch
    from cat_tpu_torch.ctc.train import (build_model, init_state,
                                         make_eval_step, make_train_step)
    from cat_tpu_torch.utils.checkpoint import CheckpointManager
    from cat_tpu_torch.utils.data import BucketedLoader, SpeechDataset
    from cat_tpu_torch.utils.manager import Manager
    from cat_tpu_torch.utils.scheduler import SchedulerNoam, build_scheduler

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "build", "manager")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    fill = torch.utils.deterministic
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.are_deterministic_algorithms_enabled(),
                     fill.fill_uninitialized_memory)
    # run B must repeat run A's arithmetic: cuDNN's deterministic
    # algorithms, and the CTC gradient's scatter_add without atomics
    # (uninitialised memory is left as it is, as in every other phase)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    fill.fill_uninitialized_memory = False
    try:
        t = time.perf_counter()
        train_dir = pack_split(os.path.join(root, "train"), 256, 20)
        dev_dir = pack_split(os.path.join(root, "dev"), 32, 21)
        with open(os.path.join(REPO, "egs/libri/exp/crf-v1/hyper-p.json")) \
                as f:
            opts = json.load(f)["train"]["option"]
        kw = dict(frame_budget=opts["frame_budget"],
                  num_buckets=opts["num_buckets"])
        train_ds = SpeechDataset(train_dir)
        frames = [train_ds.frame_length(i) for i in range(len(train_ds))]
        log(f"[manager] packed 256 + 32 utterances of 800..2400 frames "
            f"({sum(frames) * 0.01:.1f} audio s in train) in "
            f"{time.perf_counter() - t:.1f} s; disk free "
            f"{shutil.disk_usage(root).free / 2 ** 30:.1f} GiB")
        tr = cfg["trainer"]

        def manager(seed, name):
            model = build_model(cfg, num_classes=72, device="cuda",
                                seed=seed)
            sched, opt = build_scheduler(cfg["scheduler"],
                                         model.parameters())
            train_loader = BucketedLoader(train_ds, seed=opts["seed"], **kw)
            mgr = Manager(
                make_train_step(model, opt, tr["loss"], den, tr["lamb"],
                                cfg["specaug"], grad_clip=5.0,
                                grad_accum_fold=MANAGER_FOLD),
                make_eval_step(model, tr["loss"], den, tr["lamb"]),
                init_state(model, opt), sched,
                CheckpointManager(os.path.join(root, name), keep_last=2,
                                  keep_best=1),
                train_loader,
                BucketedLoader(SpeechDataset(dev_dir), shuffle=False, **kw),
                gen=torch.Generator().manual_seed(13), max_epochs=1,
                check_freq=3, verbose=False, grad_accum_fold=MANAGER_FOLD)
            collate = train_loader._collate
            mgr.collate_ms = []

            def timed_collate(*args):
                t = time.perf_counter()
                out = collate(*args)
                mgr.collate_ms.append(1e3 * (time.perf_counter() - t))
                return out

            train_loader._collate = timed_collate
            return mgr, Probe(mgr)

        a, pa = manager(0, "a")
        loader = a.train_loader
        log(f"[manager] BucketedLoader (crf-v1 options {kw}, seed "
            f"{opts['seed']}): buckets {loader.buckets}, batch sizes "
            f"{loader.batch_sizes}, label caps {loader.label_caps}, "
            f"{loader.num_batches()} batches an epoch; grad_accum_fold "
            f"{MANAGER_FOLD} (crf-v1: 16), check_freq 3")
        at = {}
        save = a.save

        def save_and_keep(metric):
            name = save(metric)
            if a.global_step == 3:
                # the checkpoint, kept aside from retention by a hard link
                at["path"] = os.path.join(root, "step3.pt")
                os.link(a.ckpt.path(name), at["path"])
                at["state"] = state_tensors(a.state.state_dict())
                at["gen"] = a.gen.get_state()
                at["batches"] = len(pa.uids)
            return name

        a.save = save_and_keep
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        a.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        total = counts()
        n_steps, n_evals = len(pa.train), len(pa.evals)
        with open(a.logger.path) as f:
            logged = [json.loads(line) for line in f]
        epoch_log = [m for m in logged if "data_s" in m]
        rounds = [m for m in logged if "dev_loss" in m]
        want = {k: n_steps * PER_STEP[k] + n_evals * EVAL[k]
                for k in PER_STEP}
        for i, r in enumerate(pa.train):
            if r["launches"] != PER_STEP:
                fail(f"manager micro-step {i + 1}: launch counts "
                     f"{r['launches']} != {PER_STEP}")
            if r["skipped"] or not math.isfinite(r["loss"]):
                fail(f"manager micro-step {i + 1}: loss {r['loss']}, "
                     f"skipped {r['skipped']}")
            if r["applied"] != int((i + 1) % MANAGER_FOLD == 0):
                fail(f"manager micro-step {i + 1}: applied {r['applied']}")
        for i, r in enumerate(pa.evals):
            if r["launches"] != EVAL:
                fail(f"manager eval batch {i + 1}: launch counts "
                     f"{r['launches']} != {EVAL}")
            if not math.isfinite(r["loss_sum"]):
                fail(f"manager eval batch {i + 1}: loss {r['loss_sum']}")
        if total != want:
            fail(f"manager run A launches {total} != {want}")
        noam = SchedulerNoam(**cfg["scheduler"]["kwargs"])
        for k, r in enumerate(pa.train, 1):
            noam.update_lr_step(-(-k // MANAGER_FOLD))
            if r["lr"] != noam.lr:
                fail(f"manager micro-step {k}: lr {r['lr']} != Noam at "
                     f"update {-(-k // MANAGER_FOLD)}: {noam.lr}")
        if n_steps != loader.num_batches() or a.global_step != n_steps \
                or len(rounds) != n_steps // 3 or "path" not in at:
            fail(f"manager run A: {n_steps} steps, {len(rounds)} rounds")
        if any(not math.isfinite(m["dev_loss"]) for m in rounds):
            fail(f"manager run A: dev losses {rounds}")
        ms = [r["ms"] for r in pa.train]
        walls = [1e3 * r["wall"] for r in pa.train]
        log(f"[manager] run A: {n_steps} micro-steps ({n_steps // 2} "
            f"updates), {len(rounds)} eval rounds of "
            f"{n_evals // len(rounds)} batches, in {run_s:.1f} s; losses "
            f"{[round(r['loss'], 3) for r in pa.train]}; dev losses "
            f"{[round(m['dev_loss'], 4) for m in rounds]}; lr = Noam at "
            f"ceil(step / {MANAGER_FOLD}) at every step")
        log(f"[manager] run A launches: {PER_STEP} a micro-step, {EVAL} an "
            f"eval batch; {total} in all")
        log(f"[manager] micro-step ms (CUDA events) {[round(x, 1) for x in ms]}"
            f", mean {sum(ms) / len(ms):.1f}; host wall "
            f"{[round(x, 1) for x in walls]}, mean "
            f"{sum(walls) / len(walls):.1f}; eval batch ms mean "
            f"{sum(r['ms'] for r in pa.evals) / n_evals:.1f}")
        log(f"[manager] epoch: data_s {epoch_log[0]['data_s']:.3f}, step_s "
            f"{epoch_log[0]['step_s']:.3f} (Manager's log); collate ms a "
            f"batch {[round(x, 1) for x in a.collate_ms]}, mean "
            f"{sum(a.collate_ms) / len(a.collate_ms):.1f}; checkpoint "
            f"writes s {[round(x, 2) for x in pa.saves]}")
        names_a = [e[0] for e in a.ckpt.entries]
        sched_a = a.scheduler.state_dict()
        uids_a = pa.uids[at["batches"]:]
        step_a, epoch_a = a.global_step, a.epoch
        del a, pa, loader
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(root, "a"))

        # the round trip: a fresh Manager, its model from another seed
        b, pb = manager(1, "b")
        fresh = state_tensors(b.state.state_dict())
        if not bitwise_diff(fresh, at["state"]):
            fail("the fresh model already equals run A's")
        t = time.perf_counter()
        b.resume(at["path"])
        load_s = time.perf_counter() - t
        bad = bitwise_diff(state_tensors(b.state.state_dict()), at["state"])
        n_t = sum(isinstance(v, torch.Tensor) for v in at["state"].values())
        fold = at["state"]["/fold/count"], float(at["state"]["/fold/weight"])
        log(f"[manager] step-3 checkpoint ({os.path.getsize(at['path']) / 2 ** 30:.2f} "
            f"GiB) into a fresh Manager in {load_s:.1f} s: {n_t} tensors "
            f"(parameters, running statistics, Adam moments and steps, fold "
            f"sums), fold count {fold[0]} weight {fold[1]:g}; "
            f"{len(bad)} differ bit for bit")
        if bad or fold[0] != 1:
            fail(f"the step-3 checkpoint does not round-trip: {bad[:5]}")
        # run B: resumed, with the generator's state at step 3 (the
        # Manager does not checkpoint its generator, as JAX its rng)
        b.gen.set_state(at["gen"])
        reset_counts()
        t = time.perf_counter()
        b.run()
        torch.cuda.synchronize()
        log(f"[manager] run B (resumed at step 3, epoch replayed from its "
            f"start): {len(pb.train)} micro-steps in "
            f"{time.perf_counter() - t:.1f} s, launches {counts()}")
        checks = {"global_step": (b.global_step, step_a),
                  "epoch": (b.epoch, epoch_a),
                  "scheduler state_dict": (b.scheduler.state_dict(), sched_a),
                  "checkpoint.list names": ([e[0] for e in b.ckpt.entries],
                                            names_a[1:]),
                  "batch uids after step 3": (pb.uids, uids_a)}
        for what, (got, exp) in checks.items():
            if got != exp:
                fail(f"manager run B's {what} differs from run A's: {got} "
                     f"!= {exp}")
        log(f"[manager] run B = run A: global_step {step_a}, epoch "
            f"{epoch_a}, scheduler state_dict (best {sched_a['best_metric']:.6g}, "
            f"lr {sched_a['lr']:.6g}), checkpoint names {names_a[1:]}, "
            f"uids of {len(uids_a)} batches")
        del b, pb
        torch.cuda.empty_cache()
        phase_manager_lstm(root)
    finally:
        torch.backends.cudnn.deterministic = deterministic[0]
        torch.use_deterministic_algorithms(deterministic[1])
        fill.fill_uninitialized_memory = deterministic[2]
        shutil.rmtree(root, ignore_errors=True)
    log(f"[manager] phase {time.perf_counter() - t_phase:.1f} s")


def phase_manager_lstm(root):
    """The LSTM encoder of egs/template/exp/asr-ctc (hdim 32, one
    bidirectional layer, CTC, Adam at its lr, 40 features, its loader
    options) under the Manager for 3 steps on the card; a fixed stop at
    step 3 ends the run at its first checkpoint round."""
    import torch
    from cat_tpu_torch.ctc.train import (build_model, init_state,
                                         make_eval_step, make_train_step)
    from cat_tpu_torch.utils.checkpoint import CheckpointManager
    from cat_tpu_torch.utils.data import BucketedLoader, SpeechDataset
    from cat_tpu_torch.utils.manager import Manager
    from cat_tpu_torch.utils.scheduler import build_scheduler

    exp = os.path.join(REPO, "egs/template/exp/asr-ctc")
    with open(os.path.join(exp, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(exp, "hyper-p.json")) as f:
        hyper = json.load(f)
    dim = hyper["feature"]["num_mel_bins"]
    vocab = 12
    cfg["encoder"]["kwargs"]["idim"] = dim
    opts = hyper["train"]["option"]
    kw = dict(frame_budget=opts["frame_budget"],
              num_buckets=opts["num_buckets"])
    train_dir = pack_split(os.path.join(root, "lstm-train"), 24, 30,
                           (60, 240), dim, vocab, 8, subsample=False)
    dev_dir = pack_split(os.path.join(root, "lstm-dev"), 6, 31, (60, 240),
                         dim, vocab, 8, subsample=False)
    model = build_model(cfg, num_classes=vocab, device="cuda", seed=0)
    sched, opt = build_scheduler(
        {"type": "SchedulerFixedStop", "kwargs": {"stop_step": 3},
         "optimizer": cfg["scheduler"]["optimizer"]}, model.parameters())
    loss = cfg["trainer"]["loss"]
    mgr = Manager(make_train_step(model, opt, loss),
                  make_eval_step(model, loss), init_state(model, opt), sched,
                  CheckpointManager(os.path.join(root, "lstm")),
                  BucketedLoader(SpeechDataset(train_dir), seed=opts["seed"],
                                 **kw),
                  BucketedLoader(SpeechDataset(dev_dir), shuffle=False, **kw),
                  max_epochs=5, check_freq=3, verbose=False)
    probe = Probe(mgr)
    reset_counts()
    mgr.run()
    torch.cuda.synchronize()
    step = {k: int(k in ("ctc_alpha", "ctc_beta")) for k in KERNELS}
    ev = {k: int(k == "ctc_alpha") for k in KERNELS}
    for i, r in enumerate(probe.train):
        if r["launches"] != step or not math.isfinite(r["loss"]) \
                or r["skipped"]:
            fail(f"LSTM manager step {i + 1}: launches {r['launches']} != "
                 f"{step}, loss {r['loss']}, skipped {r['skipped']}")
    for r in probe.evals:
        if r["launches"] != ev:
            fail(f"LSTM eval batch: launches {r['launches']} != {ev}")
    want = {k: 3 * step[k] + len(probe.evals) * ev[k] for k in KERNELS}
    if mgr.global_step != 3 or len(probe.train) != 3 or counts() != want \
            or len(mgr.ckpt.entries) != 1:
        fail(f"LSTM manager: {mgr.global_step} steps, launches {counts()} "
             f"!= {want}, checkpoints {mgr.ckpt.entries}")
    log(f"[manager] LSTM (asr-ctc: {cfg['encoder']['kwargs']}, V={vocab}): "
        f"3 steps, losses {[round(r['loss'], 3) for r in probe.train]}, "
        f"{[round(r['ms'], 1) for r in probe.train]} ms (CUDA events), "
        f"launches a step {dict((k, v) for k, v in step.items() if v)}, an "
        f"eval batch {dict((k, v) for k, v in ev.items() if v)}; stopped at "
        f"step 3 by SchedulerFixedStop ({len(probe.evals)} eval batches)")


def rnnt_edge_tables(gen, U1, T, N, V=9):
    """RNN-T tables (`_row_tables`) of U = U1 - 1 labels over V: label
    lengths falling from U to 0, input lengths from T down, for N > 1 one
    utterance of one frame and one without labels."""
    import torch
    from cat_tpu_torch.ops import rnnt
    U = U1 - 1
    lp = torch.log_softmax(_rnd(gen, N, T, U1, V, s=2.0), -1)
    labels = torch.randint(1, V, (N, U), generator=gen, device="cuda")
    llens = torch.tensor([U - (U * i) // N for i in range(N)], device="cuda")
    ilens = torch.tensor([max(1, T - 3 * i) for i in range(N)],
                         device="cuda")
    if N > 1:
        llens[-1], ilens[1] = 0, 1
    labels *= torch.arange(U, device="cuda")[None, :] < llens[:, None]
    return rnnt._row_tables(lp, labels, ilens, llens, 0), llens


def phase_rnnt_kernels(gen, rec, floors):
    """The RNN-T lattice kernels (rows 20-21) against their plain versions
    at the rnnt-v1 training batch (N = 32, T' = 299..493, U = T' // 6, V =
    1024, tables of log-softmaxed random logits) and at edge shapes, on
    both routes of `rnnt_plan` (wavefront up to U+1 = 1024, row scan
    above), two calls of each bit for bit; the JSON records of both, their
    bounds with the chain of T' + U dependent steps (`step_floors`).

    Each comparison is made twice: against the plain version in f32 (what
    a CPU tensor takes) and against the same plain version on f64 copies
    of the tables (the witness, exact to about 1e-11). States and
    log-likelihoods are gated against both. The gradient rows (the blank
    and label posteriors of `rnnt.posteriors`, which the loss's backward
    scatters, negated, into the V-wide rows) are gated against the
    witness: at this batch the f32 plain version's own rows lie about
    twice GRAD_TOL from it (printed here; measured on the CPU by
    tests/test_torch_rnnt_wavefront.py), so no kernel that sums in another
    order could meet GRAD_TOL against them; their distance from the
    kernel's is printed beside."""
    import torch
    from cat_tpu_torch.ops import rnnt

    def same_twice(tag, call, first):
        if not torch.equal(call(), first):
            fail(f"{tag}: two calls on the same inputs differ")

    def wide(xs):
        return [x.double() for x in xs]

    tl = [subsampled(f) for f in TRAIN_FRAMES]
    N, T = len(tl), max(tl)
    batch = make_batch(TRAIN_FRAMES, seed=11, vocab=RNNT_V,
                       frames_per_label=6)
    labels, llens = batch["labels"], batch["label_lengths"]
    U1 = labels.shape[1] + 1
    plan = rnnt.rnnt_plan(U1)
    log(f"[kernel] rnnt plan at the rnnt-v1 batch (U+1 = {U1}): route "
        f"{plan.route}, {plan.warps} warps of one state a thread")
    lens = torch.tensor(tl, device="cuda")
    lp = torch.log_softmax(_rnd(gen, N, T, U1, RNNT_V, s=2.0), -1)
    tabs = rnnt._row_tables(lp, labels, lens, llens, 0)
    del lp
    torch.cuda.empty_cache()
    be, le = tabs[0], tabs[1]
    term = rnnt.beta_term(llens, U1)
    alphas = rnnt.forward_alphas(be, le)
    betas = rnnt.backward_betas(be, le, term)
    plain_a = rnnt.forward_alphas_reference(be, le)
    plain_b = rnnt.backward_betas_reference(be, le, term)
    wit_a = rnnt.forward_alphas_reference(*wide((be, le)))
    wit_b = rnnt.backward_betas_reference(*wide((be, le, term)))
    ll_k, ll_p, ll_w = (rnnt._final_ll(a, b, llens) for a, b in (
        (alphas, be), (plain_a, be), (wit_a, be.double())))
    e_a = close_states("rnnt_alpha", alphas, plain_a, STATE_ATOL, STATE_RTOL)
    e_b = close_states("rnnt_beta", betas, plain_b, STATE_ATOL, STATE_RTOL)
    e_aw = close_states("rnnt_alpha vs the f64 witness", alphas, wit_a,
                        STATE_ATOL, STATE_RTOL)
    e_bw = close_states("rnnt_beta vs the f64 witness", betas, wit_b,
                        STATE_ATOL, STATE_RTOL)
    close_rel("rnnt log-likelihood", ll_k, ll_p)
    close_rel("rnnt log-likelihood vs the f64 witness", ll_k, ll_w)
    same_twice("rnnt_alpha", lambda: rnnt.forward_alphas(be, le), alphas)
    same_twice("rnnt_beta", lambda: rnnt.backward_betas(be, le, term), betas)
    log("[kernel] rnnt_alpha, rnnt_beta bitwise reproducible over two calls "
        "(rnnt-v1 batch): True, True")
    del alphas, betas, plain_a, plain_b, wit_a, wit_b

    ones = torch.ones(N, device="cuda")

    def rows(tables, alphas_of):
        a = alphas_of(tables[0], tables[1])
        return torch.stack(rnnt.posteriors(
            *tables, a, rnnt._final_ll(a, tables[0], llens), lens, llens,
            ones))

    rows_k = rows(tabs, rnnt.forward_alphas)
    rows_p = patched(plain_patches(),
                     lambda: rows(tabs, rnnt.forward_alphas_reference))
    rows_w = patched(plain_patches(),
                     lambda: rows(wide(tabs), rnnt.forward_alphas_reference))
    e_g = close_rows("rnnt gradient rows vs the f64 witness", rows_k, rows_w)
    e_gp = (rows_k - rows_p).abs().max().item()
    e_pw = (rows_p - rows_w).abs().max().item()
    over = lambda got: ((got - rows_w).abs()
                        / (GRAD_TOL + GRAD_TOL * rows_w.abs())).max().item()
    log(f"[kernel] rnnt gradient rows at the rnnt-v1 batch, max abs err: "
        f"kernel vs the f64 witness {e_g:.4g} ({over(rows_k):.3f} of the "
        f"gate); f32 plain vs the witness {e_pw:.4g} ({over(rows_p):.3f} of "
        f"the gate); kernel vs f32 plain {e_gp:.4g}; states vs the witness "
        f"alpha {e_aw:.4g}, beta {e_bw:.4g}")
    del rows_k, rows_p, rows_w
    torch.cuda.empty_cache()
    edges = []
    shapes = [(1, 24, 3), (2, 24, 3), (32, 24, 3), (33, 24, 3), (64, 24, 3),
              (65, 24, 3), (97, 24, 3), (256, 24, 3), (257, 24, 3),
              (1024, 24, 3), (1025, 24, 3), (1500, 24, 3), (9, 1, 2)]
    for U1e, Te, Ne in shapes:
        (eb, el, _, _), ell = rnnt_edge_tables(gen, U1e, Te, Ne)
        eterm = rnnt.beta_term(ell, U1e)
        ea = rnnt.forward_alphas(eb, el)
        eb_out = rnnt.backward_betas(eb, el, eterm)
        ep = rnnt.rnnt_plan(U1e)
        tag = f"U+1={U1e} T'={Te} N={Ne} ({ep.route}, W={ep.warps})"
        for what, tables in (("", (eb, el, eterm)),
                             (" vs the f64 witness", wide((eb, el, eterm)))):
            pa = rnnt.forward_alphas_reference(*tables[:2])
            edges.append(close_states(f"rnnt_alpha {tag}{what}", ea, pa,
                                      STATE_ATOL, STATE_RTOL))
            close_rel(f"rnnt log-likelihood {tag}{what}",
                      rnnt._final_ll(ea, eb, ell),
                      rnnt._final_ll(pa, tables[0], ell))
            edges.append(close_states(
                f"rnnt_beta {tag}{what}", eb_out,
                rnnt.backward_betas_reference(*tables), STATE_ATOL,
                STATE_RTOL))
        same_twice(f"rnnt_alpha {tag}", lambda: rnnt.forward_alphas(eb, el),
                   ea)
        same_twice(f"rnnt_beta {tag}",
                   lambda: rnnt.backward_betas(eb, el, eterm), eb_out)
    log(f"[kernel] rnnt alphas, betas and log-likelihoods agree with the "
        f"f32 plain versions and the f64 witness, gradient rows with the "
        f"witness (max abs err over live states vs f32 plain: alpha "
        f"{e_a:.4g}, beta {e_b:.4g}; gradient rows {e_g:.4g}; edge shapes U+1 "
        f"in {', '.join(str(u) for u, _, _ in shapes[:-1])} at T'=24 and 9 "
        f"at T'=1, label lengths down to 0, on both routes, each two calls "
        f"bit for bit: {max(edges):.4g}); no PyTorch call computes an RNN-T "
        f"loss here (torchaudio is absent): library_ms null")
    # bytes: the two tables read and the states written (and beta_T read);
    # about 12 f32 operations a state and frame (an exp, a log1p, adds and
    # maxima of the sequential recurrence); the longest utterance's chain
    # of T' + U dependent steps
    nbytes = 3 * be.numel() * 4
    chain = (T + llens.max().item(), floors["rnnt"])
    what = (f"N={N} T'={min(tl)}..{T} U+1={U1} "
            f"(U={llens.min().item()}..{llens.max().item()}) V={RNNT_V}, "
            f"{plan.route} route, W={plan.warps}")
    rec.add("rnnt_alpha", "cat_tpu_torch/csrc/rnnt.cu",
            "cat_tpu/ops/rnnt_pallas.py:87", max(e_a, e_g),
            timed(lambda: rnnt.forward_alphas(be, le), 10, 2),
            timed(lambda: rnnt.forward_alphas_reference(be, le), 1, 1),
            12 * be.numel(), nbytes, what, PEAK_F32_FLOPS, chain=chain)
    rec.add("rnnt_beta", "cat_tpu_torch/csrc/rnnt.cu",
            "cat_tpu/ops/rnnt_pallas.py:112", max(e_b, e_g),
            timed(lambda: rnnt.backward_betas(be, le, term), 10, 2),
            timed(lambda: rnnt.backward_betas_reference(be, le, term), 1, 1),
            12 * be.numel(), nbytes + term.numel() * 4, what, PEAK_F32_FLOPS,
            chain=chain)
    torch.cuda.empty_cache()


def rnnt_model(cfg, perturbed=True):
    """The rnnt-v1 transducer over V = 1024 with seeded random weights (and
    random biases, norms and statistics)."""
    import torch
    from cat_tpu_torch.rnnt.train import build_model
    model = build_model(cfg, num_classes=RNNT_V, device="cuda", seed=0)
    if perturbed:
        perturb(model, torch.Generator().manual_seed(1))
    return model


def phase_rnnt_serving(cfg):
    """rnnt-v1 greedy decoding of the serving batch and a width-16 beam
    search of two of its utterances, through the port's decoders."""
    import torch
    from cat_tpu_torch.rnnt.decode import RNNTBeamDecoder, make_greedy_decoder

    t0 = time.perf_counter()
    model = rnnt_model(cfg)
    log(f"[rnnt-serve] rnnt-v1 TransducerModel (encoder "
        f"{cfg['encoder']['kwargs']}, predictor {cfg['predictor']}, joiner "
        f"{cfg['joiner']}) V={RNNT_V}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    N, T = len(FRAMES), max(FRAMES)
    lengths = torch.tensor(FRAMES, device="cuda")
    feats = torch.randn(N, T, 80, generator=gen, device="cuda")
    feats *= (torch.arange(T, device="cuda")[None, :, None]
              < lengths[:, None, None])
    greedy = make_greedy_decoder(model)
    walls = []
    for i in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tokens, n_tok = greedy(feats, lengths)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        seen = counts()
        if seen != SERVE:
            fail(f"rnnt greedy decode launch counts {seen} != {SERVE}")
    if tuple(tokens.shape) != (N, 200) or not (
            (tokens >= 0) & (tokens < RNNT_V)).all():
        fail(f"rnnt greedy tokens {tuple(tokens.shape)} out of range")
    reset_counts()
    t = time.perf_counter()
    beam = RNNTBeamDecoder(model, beam_width=16).decode(feats[:2],
                                                        lengths[:2])
    beam_s = time.perf_counter() - t
    if counts() != SERVE:
        fail(f"rnnt beam decode launch counts {counts()} != {SERVE}")
    if not all(math.isfinite(b[0][0]) for b in beam):
        fail("rnnt beam search: non-finite score")
    audio_s = sum(FRAMES) * 0.01
    log(f"[rnnt-serve] greedy decode of {N} utterances ({audio_s:.1f} audio "
        f"s, max 4 symbols a frame, at most 200 tokens): launches {seen}; "
        f"tokens per utterance "
        f"{n_tok.tolist()}; host wall {[round(w * 1e3, 1) for w in walls]} "
        f"ms")
    log(f"[rnnt-serve] beam16 decode of 2 utterances "
        f"({sum(FRAMES[:2]) * 0.01:.1f} audio s), encoder and host search: "
        f"{beam_s * 1e3:.1f} ms host wall; best scores "
        f"{[round(b[0][0], 3) for b in beam]}, "
        f"{[len(b[0][1]) for b in beam]} tokens")
    del model
    torch.cuda.empty_cache()


def phase_rnnt_train_vs_plain(cfg):
    """One rnnt-v1 train step with the kernels against the plain versions
    in bf16 and in float32 (`steps_agree`), labels U = T' // 6 ids in
    1..1023."""
    import torch
    from cat_tpu_torch.rnnt.train import make_train_step
    from cat_tpu_torch.utils.scheduler import build_scheduler

    model = rnnt_model(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch(FRAMES, seed=3, vocab=RNNT_V, frames_per_label=6)

    def make_step():
        sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
        return make_train_step(model, opt, cfg["specaug"], grad_clip=5.0), \
            sched.lr, opt

    steps_agree("rnnt-v1", lambda patches, f32: step_once(
        model, start, make_step, batch, model.encoder, patches, f32), batch,
        cfg["specaug"], RNNT_STEP, "encoder output")
    del model
    torch.cuda.empty_cache()


def phase_rnnt_training(cfg, profile):
    """The RNN-T main path: train steps of the full rnnt-v1 model."""
    import torch
    import torch.nn.functional as F
    from cat_tpu_torch.ops.rnnt import rnnt_loss
    from cat_tpu_torch.rnnt.train import init_state, make_train_step
    from cat_tpu_torch.utils.scheduler import build_scheduler

    model = rnnt_model(cfg, perturbed=False)
    sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
    step = make_train_step(model, opt, cfg["specaug"], grad_clip=5.0)
    batch = make_batch(TRAIN_FRAMES, seed=6, vocab=RNNT_V,
                       frames_per_label=6)
    audio_s = sum(TRAIN_FRAMES) * 0.01
    tl = [subsampled(f) for f in TRAIN_FRAMES]
    U1 = batch["labels"].shape[1] + 1
    log(f"[rnnt-train] batch: {len(TRAIN_FRAMES)} utterances of "
        f"{min(TRAIN_FRAMES)}..{max(TRAIN_FRAMES)} frames ({audio_s:.1f} "
        f"audio s), T' {min(tl)}..{max(tl)}, labels "
        f"{batch['label_lengths'].min().item()}.."
        f"{batch['label_lengths'].max().item()} of V={RNNT_V}; lattice "
        f"(N, T', U+1, V) = ({len(tl)}, {max(tl)}, {U1}, {RNNT_V}), "
        f"{len(tl) * max(tl) * U1 * RNNT_V * 4 / 1e9:.2f} GB in f32")
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
        log(f"[rnnt-train] step {i + 1} ({'warm-up' if i < 2 else 'timed'}): "
            f"loss {loss:.5g}, grad norm {gn:.5g}, skipped {m['skipped']}, "
            f"{ms:.1f} ms (CUDA events), {wall * 1e3:.1f} ms host wall")
        if per != RNNT_STEP:
            fail(f"rnnt train step launch counts {per} != {RNNT_STEP}")
        if m["skipped"] or not (torch.isfinite(m["loss"])
                                and torch.isfinite(m["grad_norm"])):
            fail(f"rnnt train step {i + 1}: non-finite loss or grad norm")
        if i >= 2:
            events.append(ms)
            walls.append(wall)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean_ms = sum(events) / len(events)
    log(f"[rnnt-train] {len(events)} timed steps: {mean_ms:.1f} ms per step "
        f"(CUDA events; {min(events):.1f}..{max(events):.1f}), host wall "
        f"{1e3 * sum(walls) / len(walls):.1f} ms; "
        f"{audio_s / (mean_ms / 1e3):.1f} audio-s/s trained; peak memory "
        f"{peak:.2f} GiB; launches per step {RNNT_STEP}")

    # the split of one step: encoder forward, predictor + joiner forward
    # (with the log-softmax), loss forward, loss backward (to the
    # log-probs), predictor + joiner backward, encoder backward
    model.train()
    opt.zero_grad(set_to_none=True)
    labels, llens = batch["labels"], batch["label_lengths"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    torch.cuda.synchronize()
    ev[0].record()
    enc, olen = model.encoder(batch["feats"], batch["feat_lengths"], gen)
    ev[1].record()
    enc_d = enc.detach().requires_grad_()
    pred, _ = model.predictor(F.pad(labels, (1, 0)), llens + 1, gen)
    lp = torch.log_softmax(model.joiner(enc_d, pred).float(), dim=-1)
    ev[2].record()
    lp_d = lp.detach().requires_grad_()
    loss = rnnt_loss(lp_d, labels, olen, llens)
    ev[3].record()
    loss.backward()
    ev[4].record()
    lp.backward(lp_d.grad)
    ev[5].record()
    enc.backward(enc_d.grad)
    ev[6].record()
    torch.cuda.synchronize()
    part = [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]
    log(f"[rnnt-train] one step split (CUDA events, ms): encoder forward "
        f"{part[0]:.1f}, predictor + joiner forward {part[1]:.1f}, loss "
        f"forward {part[2]:.1f}, loss backward {part[3]:.1f}, predictor + "
        f"joiner backward {part[4]:.1f}, encoder backward {part[5]:.1f}; "
        f"encoder fwd+bwd {part[0] + part[5]:.1f}, predictor + joiner "
        f"fwd+bwd {part[1] + part[4]:.1f}, loss fwd+bwd "
        f"{part[2] + part[3]:.1f}")
    del enc, enc_d, pred, lp, lp_d, loss
    opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    if profile:
        phase_profile(lambda: step(state, batch, sched.lr, gen),
                      "one rnnt-v1 train step",
                      "chiprun_out/profile_rnnt_train.txt")
    del model, opt, state, step
    torch.cuda.empty_cache()
    return launches


def phase_profile(fn, what, path):
    """Device time of fn() by kernel (torch.profiler), and the device's
    busy share over the span from its first kernel's start to its last
    kernel's end. User annotation ranges on the device's timeline (the
    `Optimizer.step#...` range around Adam's launches) are no kernels:
    they are left out of the device time, the span and the busy share and
    printed on a line of their own."""
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
    kernels, ranges = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        annotation = getattr(e, "is_user_annotation", False) \
            or e.name.startswith("Optimizer.")
        (ranges if annotation else kernels).append(e)
    if ranges:
        log(f"[profile] {what}: annotation ranges left out: " + ", ".join(
            f"{e.name} {(e.time_range.end - e.time_range.start) / 1e3:.3f} "
            f"ms" for e in ranges))
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
    t = time.perf_counter()
    den = make_den()
    log(f"[train] dense 3-gram denominator over V=72 built in "
        f"{time.perf_counter() - t:.1f} s")
    rec = Records()
    phase_kernels(torch.Generator(device="cuda").manual_seed(0))
    phase_backward_kernels(torch.Generator(device="cuda").manual_seed(1), rec)
    floors = step_floors()
    phase_loss_kernels(torch.Generator(device="cuda").manual_seed(4), rec,
                       den, floors)
    phase_rnnt_kernels(torch.Generator(device="cuda").manual_seed(12), rec,
                       floors)
    cfg = load_config()
    forward = phase_serving(cfg)
    if profile:
        phase_profile(forward, "one serving forward",
                      "chiprun_out/profile.txt")
    del forward
    torch.cuda.empty_cache()
    phase_train_vs_plain(cfg, den)
    phase_fold(cfg, den)
    launches = phase_training(cfg, den, profile)
    phase_manager(cfg, den)
    rnnt_cfg = load_config("rnnt-v1")
    phase_rnnt_serving(rnnt_cfg)
    phase_rnnt_train_vs_plain(rnnt_cfg)
    rnnt_launches = phase_rnnt_training(rnnt_cfg, profile)
    # each kernel's launches on the main path that runs it: the crf-v1
    # training phase, or the rnnt-v1 one for the RNN-T lattice kernels
    records = [rec.by_name[k] for k in KERNELS]
    for r in records:
        r["launches"] = (rnnt_launches if r["name"].startswith("rnnt_")
                         else launches)[r["name"]]
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
