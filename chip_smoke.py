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
6c. encoders: the recipes' encoders at full width, random weights, each
   train step (CTC-CRF over the 3-gram of phase 2, the recipe's lambda,
   SpecAugment and scheduler) against its plain versions as in phase 4:
   egs/iumien/exp/crf-joinap (`JoinAPLinearEncoder` over a 14-cell, d =
   512, 8-head, conv kernel 15, dropout 0.1 bf16 conformer; P a seeded
   (72, 51) matrix, so V = 72; its logits in float32), launches pinned
   (JOINAP_STEP: 14 cells' encoder kernels, 2 dropout, the loss kernels
   once each), then 2 warm-up and 5 timed steps on the training batch;
   `JoinAPNonLinearEncoder` (ap_hdim 512) on the same head, its eval
   forward (JOINAP_SERVE launches) against the plain forward (the head's
   output within LOGIT_TOL, A·P bit for bit, the logits' difference
   printed) and one step; the JoinAP steps' per-tensor cosines judged by
   the float32 step where the two bf16 steps disagree (`steps_agree`
   judge_float32: the random JoinAP logits reach ~37, crf-v1's ~3);
   egs/wsj/exp/crf-tdnn (`TDNN_NAS`, hdim 640, dropout 0.5,
   float32, the convolutions cuDNN with TF32 off; 7 dropouts both ways
   and the loss kernels a step, TDNN_STEP; its plain step is the float32
   step, held within STEP_F32_REL), then timed the same way;
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
   show the four encoder forward kernels and nothing else; the same beam
   fused with a token 3-gram over V = 1024 (trained on seeded random
   sequences, written to ARPA and read back): two calls alike bit for
   bit, and at alpha = beta = 0 equal to the unfused beam;
9. RNN-T train vs plain: one rnnt-v1 train step on the serving batch, as
   phase 4 (the encoder output in place of the logits);
10. RNN-T training: `cat_tpu_torch.rnnt.train.make_train_step` trains the
   full rnnt-v1 model (SpecAugment, dropout 0.1, Noam + Adam, clipping at
   5) on the training batch's 32 utterances: 2 warm-up and 5 timed steps;
   exactly the encoder launches of phase 6, 2 dropout, 1 rnnt_alpha, 1
   rnnt_beta and no CTC or den kernel per step; step time, audio-s/s,
   peak memory and the split of one step;
10b. cuside: egs/aishell/exp/rnnt-cuside's model (a 12-cell, d = 256,
   4-head, conv kernel 15, bf16 conformer under CUSIDE chunking: chunk
   64, left 64, right 16, SimuNet; LSTM predictor of 256, LogAdd joiner;
   V = CUSIDE_V) with seeded random weights: the encoder kernels (rows
   2-3, 12-17, fwd and bwd) against their plain versions at its widths
   (D = 256, F = 1024, H = 4, Dh = 64, the wgmma routes) on the training
   batch's chunk windows (32 x 31 windows of T' = 35, every row valid)
   and on its full pass, as phase 2 checks D = 512 (rates 0 and 0.1, two
   calls bit for bit, each time beside its bound; the profiler's split
   of the launches only at D = 512); one unified step
   (`rnnt.train_unified`, dropout 0.1, SpecAugment) on the training
   batch (U = T'//6 ids) against the plain bf16 and float32 steps with
   phase 4's gates, loss_full, loss_chunk and loss_simu held as the
   loss, launches pinned (CUSIDE_STEP: 12 cells x 2 passes of crf-v1's
   per-cell counts, 4 dropout, 2 rnnt_alpha, 2 rnnt_beta); 2 warm-up and
   5 timed steps (ms, audio-s/s, peak after reset_peak_memory_stats) and
   the split of one (SpecAugment, full pass, chunk pass, SimuNet alone,
   the two losses, backward, Adam); a CUSIDE CTC step
   (`ctc.train_unified`, the same encoder with a head) against its plain
   steps (CUSIDE_CTC_STEP: rows 18-19 once a pass); the monotonic RNA
   loss (topo rna/ctct, a plain PyTorch scan) forward + backward timed
   at the rnnt-v1 training batch's lattice beside rows 20-21, its NLL
   within RNA_RTOL of float64;
11. pipeline: `cat_tpu_torch.pipeline.asr.main` in-process, on data the
   script synthesizes in a temporary directory under build/ (removed at
   the end). (A) egs/libri/exp/crf-v1 at full width (17 cells, d = 512,
   bf16, V = 72) through its four stages on a corpus of 70 phone tones
   (a 200-word lexicon; 192 train and 32 dev utterances of 15-45 words,
   16 kHz), cut to grad_accum_fold 2, one epoch and check_freq 2: the
   files of every stage, one hypothesis per dev utterance and finite WER
   numbers; four utterances' packed features within 1e-3 + 1e-4·|x| of
   the CPU fbank of the same WAVs in the mel bins within 16 nats of their
   frame's largest, the others' mel power within 1e-9 of the frame's
   largest against a float64 witness; every micro-step `PER_STEP` and
   every eval batch `EVAL` launches, finite losses and no micro-step
   skipped by the NaN/Inf guard; every decode batch the four
   encoder forward kernels and nothing else; the best-5 average equal to
   the f64 mean of the chosen checkpoints, in the decode model too; the
   device beam (width 17) of the first decode batch against the same
   function in float64 on the CPU, its witness (`judge_device_beam`:
   prefixes of live lanes equal, scores within 1e-4 + 1e-5·|s|, except an
   utterance that differs where the witness's lane selection had a
   near-tie within that tolerance, whose best lane is held to the
   witness's score of its prefix or to its exact float64 CTC
   log-likelihood; at most half of the batch exempt) and two calls bit
   for bit; each stage's seconds, the
   features' audio-s/s, the denominator's seconds, micro-step ms,
   checkpoint writes, averaging, the beam's ms a batch and share of stage
   4, and the RTF. [lm] then, on (A)'s expdir and corpus: the
   `CausalTransformer` at its declared widths (hdim 512, 6 layers, 8
   heads, ff 2048, max_len 2048; V = 1024, tied) from a seed, its forward
   and masked CE loss on the first `LmLoader` batch of a seeded token
   corpus against the same weights on the CPU (logits within 1e-4
   relative norm, loss within 1e-5 relative), 3 train steps at the
   loader's defaults (token budget 8000, max_len 512; 14 dropout launches
   a step and nothing else; ms, tokens/s, peak); rnnt-v1's width-16 beam
   on the 2 shortest serving utterances with decode.lm "nn" and "lodr"
   (that LM, and with a token 2-gram of weight -0.3): at alpha = 0 the
   unfused beam's result, at alpha 0.3, beta 0.5 the 1-best's LM term
   as the beam took it within 1e-4 of one CPU forward, SERVE launches
   a decode, ms and LM forwards an utterance;
   egs/template/exp/lm-nn and lm-trf through `pipeline.lm` stages 1-4
   on (A)'s transcripts (cut: the data paths): every stage's files,
   lm-nn's dev ppl finite and below V, lm-trf's mean TRF score finite;
   (A)'s dev n-best rescored by an lm-nn LM trained by `pipeline.lm` on
   the transcripts with the expdir's tokenizer (2 epochs, cut from 10):
   stage 4's decode.rescore
   path on the text n-best, and on the hypotheses as phone ids each
   rescored score = am - alpha·nll + beta·len with nll within 1e-4 of the
   CPU's. (B) egs/template/exp/asr-ctc as its files stand on
   yes/no tones (64 train, 20 dev, seed 0) until its run ends: at most 2
   word errors on the dev set, 1 CTC alpha and 1 beta a step. (C)
   egs/aishell/exp/rnnt-cuside's own files on (A)'s corpus (its
   SimpleTokenizer at char level): the four stages, cut to max_epochs 1
   and check_freq 2; CUSIDE_STEP a step, CUSIDE_EVAL an eval batch, none
   skipped; stage 4 in mode "streaming" at beam 16 over a split of the
   first 8 dev utterances in one batch (CUSIDE_UTTS, cut from 32 in 4
   batches: the host beam),
   each batch encoded by the chunk pass (CUSIDE_DECODE launches, every
   attention call at T' = 35); then the averaged checkpoint greedy,
   offline and streaming, over the same split: both decodes' RTF and
   the streaming gap printed, no WER gated;
11a. sharded: (A)'s corpus as npz shards of 32 utterances (6 shards),
   written by `python -m cat_tpu_torch.utils.data_prep --format shards`
   in-process with the fbank on the card, the train text beside them, and
   egs/wenetspeech/exp/crf-wds (17 cells, d = 512, bf16, CTC-CRF) through
   stages 1-3 from them with its loader options (shuffle buffer 4000,
   frame budget 40,960, seed 0, the default buckets): only dev packed;
   den_dense.npz of the label-only pass over the shards within 1e-6 of
   (A)'s; epoch 1 alike bit for bit over two iterations, each utterance
   at most once, exactly those of at most 1700 frames with frames // 4 >
   labels, in the Manager's order; `PER_STEP` a micro-step and `EVAL` an
   eval batch, none skipped; dropped utterances, cut labels, data_s
   against step_s. Then egs/wenetspeech/exp/rnnt-wds (12 cells, d = 512,
   JointNet) on shards written with a BPE of the train text (V printed)
   through stage 3: RNNT_WDS_STEP a step, checkpoints written. Cuts: fold
   16 -> 2, max_epochs 3 -> 1, check_freq 5000 -> at most 3 rounds, the
   BPE's V;
11b. wfst: on 11a's trained crf-wds expdir, stage 4 with
   egs/wenetspeech/exp/crf-wds's decode block (mode "wfst": a word
   3-gram TLG over the train transcripts, built and cached as tlg.npz;
   beam 17, max_active 7000), cut from n-best 8 to 1 over the 32 dev
   utterances through the C++ `wfst_viterbi`: every forward the four
   encoder kernels and nothing else; then `wfst_nbest` at K = 8 on two
   dev utterances (its first entry the 1-best, scores sorted, hypotheses
   distinct) and the Python `WfstDecoder.decode` on their first 30
   frames (the native 1-best's words, scores within 1e-3). Stage 4 again
   on a split of the first 4 dev utterances (cut from 32: the host beam
   takes seconds an utterance) with decode.lm (a token 3-gram, alpha
   0.3, beam 17, n-best 8) and decode.rescore (a word 3-gram, alpha 0.2,
   beta 0.5): its files, the rescored hypotheses, the fused beam alike
   bit for bit over two runs and, at alpha = beta = 0, equal to the
   unfused host beam. The expdir's denominator 3-gram written to ARPA
   and read back through `den_lm.path` into a `DenseDen`: the den
   forward kernel's logZ on the training batch within 1e-5 relative of
   the cached den_dense.npz's. TLG build and load seconds, states and
   arcs, native ms an utterance, the host share of stage 4 and its RTF;
12. device: the card's name and power limit.
With --profile, one serving forward and the three train steps (crf-v1,
rnnt-v1, aishell rnnt-cuside) also run under torch.profiler; the device
time by kernel is printed and written to chiprun_out/profile.txt,
profile_train.txt, profile_rnnt_train.txt and profile_cuside_train.txt.
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
# there: the depthwise conv bias (re-centred by batch normalisation), the
# key bias (the softmax cancels a score shared by every key) and the
# JoinAP layers' last bias (A·P's bias adds h·b to every class's logit,
# which the log-softmax cancels)
NOISE_GRADS = ("conv.depthwise.bias", "mhsa.k.bias", "A.bias", "A2.bias")
# a float32 model's kernel train step (the dropout and the loss kernels)
# against its plain step, which is the float32 step: relative distance of
# the gradient and of the logits (the loss kernels' gradient rows agree
# within 1e-3 + 1e-3·|plain| elementwise)
STEP_F32_REL = 1e-3
# output length of T input frames, and receptive field (window, stride,
# left pad) of an output frame: the conv2d subsampling, TDNN_NAS
CONV2D_FIELD = (lambda T: subsampled(T), 7, 4, 0)
TDNN_FIELD = (lambda T: (T + 1) // 2, 39, 2, 19)
JOINAP_CELLS = 14   # egs/iumien/exp/crf-joinap's head: 14 cells, kernel 15
JOINAP_V = 72       # P drawn (72, 51) as tests/test_recipes.py draws it
# launches per train step: crf-joinap (the encoder kernels of 14 cells),
# crf-tdnn (the dropout after each of its 7 layers, both ways, and the
# loss kernels), a 12-cell rnnt-wds step and eval batch
JOINAP_STEP = {k: (v // 17 * JOINAP_CELLS if k in KERNELS[:8] else v)
               for k, v in PER_STEP.items()}
TDNN_STEP = {k: {"dropout": 14, "ctc_alpha": 1, "ctc_beta": 1, "den_fwd": 1,
                 "den_bwd": 1}.get(k, 0) for k in KERNELS}
JOINAP_SERVE = {k: v // 17 * JOINAP_CELLS for k, v in SERVE.items()}
RNNT_WDS_STEP = {k: (v // 17 * 12 if k in KERNELS[:8] else v)
                 for k, v in RNNT_STEP.items()}
RNNT_WDS_EVAL = {k: (v // 17 * 12 if k in KERNELS[:4] else
                     int(k == "rnnt_alpha")) for k, v in SERVE.items()}
# aishell rnnt-cuside (egs/aishell/exp/rnnt-cuside): 12 cells, d = 256, 4
# heads, conv kernel 15, chunk 64, left 64, right 16, a SimuNet GRU of 256,
# LogAdd joiner; V = 4,233: AISHELL-1's 4,231 characters, as the common
# aishell recipes build the vocabulary, plus blank and <unk>
CUSIDE_V = 4233
CUSIDE_CELLS = 12
# launches per unified step: crf-v1's per-cell counts (two FF launches a
# cell, one of each other encoder kernel) for 12 cells in each of the two
# passes, the subsampling's dropout both ways in each pass, and each pass's
# lattice recursions; the CUSIDE CTC step has the CTC ones instead; an
# eval batch runs both passes forward and each loss's alphas, a streaming
# decode batch the chunk pass's forward kernels
CUSIDE_STEP = {k: (v // 17 * 2 * CUSIDE_CELLS if k in KERNELS[:8] else 0)
               for k, v in PER_STEP.items()}
CUSIDE_STEP.update(dropout=4, rnnt_alpha=2, rnnt_beta=2)
CUSIDE_CTC_STEP = dict(CUSIDE_STEP, rnnt_alpha=0, rnnt_beta=0, ctc_alpha=2,
                       ctc_beta=2)
CUSIDE_EVAL = {k: (v if k in KERNELS[:4] else 2 * int(k == "rnnt_alpha"))
               for k, v in CUSIDE_STEP.items()}
CUSIDE_DECODE = {k: (v // 2 if k in KERNELS[:4] else 0)
                 for k, v in CUSIDE_STEP.items()}
UNIFIED_TERMS = ("loss_full", "loss_chunk", "loss_simu")
# aishell rnnt-cuside's stage 4 decodes 8 dev utterances in one batch, not
# 32 in 4: the host beam (width 16) over a random model's long hypotheses
# takes seconds a batch (stage 4 over 32 took 53.0 s on an H100 80GB HBM3
# at 700 W)
CUSIDE_UTTS = 8
# the f32 RNA scan's NLL against float64 (about 3.4e3 nats at T' = 493,
# where one f32 rounding is 2.4e-4 and 493 steps add up to 1e-4 relative)
RNA_RTOL = 1e-4


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


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


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
    70..74 zero; below T = 75 the same pattern over rows scaled by T / 75
    (T = 35: rows 10..27 equal to row 9, 28..31 constant, 32..34 zero)."""
    t = t.clone()
    N, T = t.shape[:2]
    a, b, c, e = (int(r * min(1.0, T / 75)) for r in (20, 60, 70, 75))
    t[:, a + 1:b] = t[:, a:a + 1]
    const = t[:, b:c].reshape(N, c - b, -1)
    t[:, b:c] = const[..., :1].expand_as(const).reshape(t[:, b:c].shape)
    t[:, c:e] = 0
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


def split_and_repro(name, call, what, calls=5, split=True):
    """The launches inside one call of a staged kernel (`STAGES`), device
    ms by kernel name from torch.profiler over `calls` calls, where each
    stage must show device time and no other kernel of its own (named
    `name`_...) may run (skipped when not `split`); and two calls on the
    same inputs, which must give the same bits (no atomics)."""
    import torch

    call()
    torch.cuda.synchronize()
    if split:
        profile_split(name, call, what, calls)
    first, second = call(), call()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[kernel] {name} bitwise reproducible over two calls ({what}): "
        f"{same}")
    if not same:
        fail(f"{name}: two calls on the same inputs differ")


def profile_split(name, call, what, calls):
    """The device ms of each launch of `name`'s stages over `calls` calls
    (torch.profiler); fails unless each stage shows device time and no
    other kernel of its own runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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


def phase_backward_kernels(gen, rec, D=512, F=2048, H=8, tl=None,
                           where="training batch", splits=True):
    """Backward kernels, and the forward kernels with dropout, against their
    plain versions at the shapes of `where`: model width D, FF width F, H
    heads, the T' of each utterance `tl` (the training batch's by
    default); rates 0 and 0.1, on inputs with identical, constant and
    zero rows (`special_rows`); `rec`'s records of all eight kernels are
    timed here at rate 0.1. With `splits`, each staged kernel's launches
    are also split by torch.profiler (`split_and_repro`). (The conv
    module's kernel size does not enter rows 14-17: the depthwise conv
    runs between them, outside the kernels.)"""
    import torch
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops import attention, conv_module, ffn

    dev, bf = "cuda", torch.bfloat16
    Dh = D // H

    def repro(*args):
        split_and_repro(*args, split=splits)

    tl = tl or [subsampled(f) for f in TRAIN_FRAMES]
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
        before = attention.relpos_attention_forward.routes["wgmma"]
        out, lse = attention.relpos_attention_forward(*att, **kw)
        if attention.relpos_attention_forward.routes["wgmma"] != before + 1:
            fail("relpos_attention_fwd: Dh = 64 did not take the wgmma "
                 "route")
        ref_out, ref_lse = attention.relpos_attention_reference_lse(*att,
                                                                    **kw)
        compare(f"relpos_attention_fwd {tag}", out, ref_out, mask)
        vm = mask[:, None, :].expand_as(lse)
        compare(f"relpos_attention_fwd lse {tag}", lse[vm], ref_lse[vm])
        log(f"[kernel] forward kernels with dropout at the {where}, "
            f"{tag}: ffn, bn_out, attention (out and lse) agree")
        repro("relpos_attention_fwd",
                        lambda: attention.relpos_attention_forward(*att, **kw),
                        f"{where}, {tag}")

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
        log(f"[kernel] backward kernels at the {where}, {tag}: max "
            f"err ffn {e_ff:.4g}, glu_in {e_glu:.4g}, bn_out {e_bn:.4g}, "
            f"attention {e_att:.4g} (max abs err over all outputs)")
        del got, want
        torch.cuda.empty_cache()
        repro("relpos_attention_bwd",
                        lambda: attention.relpos_attention_backward(
                            *att, out, lse, dao, **kw),
                        f"{where}, {tag}")
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
        repro("ffn_bwd",
                        lambda: ffn.ff_backward(x, *ffp, do, **kw),
                        f"{where}, rate {rate}")
        repro("ffn_fwd", lambda: ffn.ff_forward(x, *ffp, **kw),
                        f"{where}, rate {rate}")
        ffn_fwd_products(x, ffp, where)
        rec.add("glu_in_bwd", "cat_tpu_torch/csrc/glu_in.cu",
                "cat_tpu/ops/conv_module_pallas.py:71", e_glu,
                timed(lambda: conv_module.glu_in_backward(x, mask, *glp, do),
                      10, 2),
                timed(lambda: conv_module.glu_in_backward_reference(
                    x, mask, *glp, do), 3, 1),
                12 * Rv * D * D,
                3 * Rv * D * 2 + Rv * 4 + 2 * D * D * (2 + 4) + 8 * D * 4,
                what)
        repro("glu_in_bwd",
                        lambda: conv_module.glu_in_backward(x, mask, *glp, do),
                        where)
        repro("glu_in_fwd",
                        lambda: conv_module.glu_in_forward(x, mask, *glp),
                        where)
        rec.add("bn_out_bwd", "cat_tpu_torch/csrc/bn_out.cu",
                "cat_tpu/ops/conv_module_pallas.py:261", e_bn,
                timed(lambda: conv_module.bn_out_backward(c, x, mask, *bnp, do,
                                                          **kw), 10, 2),
                timed(lambda: conv_module.bn_out_backward_reference(
                    c, x, mask, *bnp, do, **kw), 3, 1),
                4 * Rv * D * D,
                3 * Rv * D * 2 + Rv * 4 + D * D * (2 + 4) + 10 * D * 4, what)
        repro("bn_out_bwd",
                        lambda: conv_module.bn_out_backward(c, x, mask, *bnp,
                                                            do, **kw),
                        f"{where}, rate {rate}, "
                        f"{conv_module.bn_out_plan(R, D).splits} wgrad "
                        f"splits")
        repro("bn_out_fwd",
                        lambda: conv_module.bn_out_forward(c, x, mask, *bnp,
                                                           **kw),
                        f"{where}, rate {rate}")
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


def time_masked(masks, frames, Tp, field=None):
    """(N, T') bool on the CPU: the output frames whose whole receptive
    field lies in a SpecAugment time mask. field = (output length of T
    frames, window, stride, left pad): output frame t' sees input frames
    stride·t' - pad .. stride·t' - pad + window - 1 (CONV2D_FIELD: 4t' ..
    4t' + 6)."""
    import torch
    import torch.nn.functional as F
    _, window, stride, pad = field or CONV2D_FIELD
    pos = torch.arange(max(frames))[None, None, :]
    s, w = masks["time_starts"][:, :, None], masks["time_widths"][:, :, None]
    tm = F.pad(((pos >= s) & (pos < s + w)).any(1).float(), (pad, pad))
    win = tm.unfold(1, window, stride).amin(-1) > 0
    out = torch.zeros(tm.shape[0], Tp, dtype=torch.bool)
    n = min(Tp, win.shape[1])
    out[:, :n] = win[:, :n]
    return out


def forward32(encoder):
    """The ConformerNet `encoder`'s forward in float32 throughout (its fused
    ops then take their plain versions in float32); a JoinAP encoder's,
    its conformer head's."""
    import torch
    if hasattr(encoder, "enc_head"):
        head = forward32(encoder.enc_head)

        def joinap(x, lengths, gen=None):
            h, lengths = head(x, lengths, gen)
            return h.float() @ encoder.ap().t(), lengths

        return joinap

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
    Returns the loss, grad norm and skipped flag, the unified trainers'
    loss terms, the unclipped gradients, the updated buffers, and under
    "logits" and "dlogits" the encoder's output at its first call (a CTC
    model's logits; a unified model's full pass) and the loss's gradient
    at it."""
    import torch
    from cat_tpu_torch.ctc.train import init_state

    model.load_state_dict(start)
    seen = {}

    def hook(_m, _i, out):
        if "out" not in seen:
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
            "terms": {t: m[t].item() for t in UNIFIED_TERMS if t in m},
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


def steps_agree(what, run, batch, specaug_cfg, per_step, out_name,
                field=None, float32_model=False, judge_float32=False,
                where="serving batch"):
    """One train step with the kernels, `run(None, False)`, against the
    same step on every kernel's plain version (the encoder's fused ops,
    the dropout and the losses) in bf16, `run(plain_patches(), False)`,
    and in float32, `run(plain_patches(), True)`, all from the same
    weights and generator (the same SpecAugment masks and dropout seeds);
    fails unless they meet the gates of STEP_* and STEP_CONTROL. A model
    that computes in float32 (`float32_model`) has no bf16 step: its plain
    step is the float32 step, and the kernel step's distance to it is held
    to STEP_F32_REL. `field` is the encoder's receptive field
    (`time_masked`). With `judge_float32`, a tensor whose gradient
    cosine to the plain bf16 step is below STEP_COS passes only if its
    cosine to the float32 step is at least STEP_COS and at least the
    plain bf16 step's: the float32 step judges where the two bf16 steps
    disagree (the random JoinAP models, whose logits are an order of
    magnitude larger than crf-v1's). A unified trainer's loss terms
    (loss_full, loss_chunk, loss_simu) are held as the loss is. `where`
    names the batch."""
    import torch
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops.specaug import draw_masks

    reset_counts()
    k = run(None, False)
    if counts() != per_step:
        fail(f"{what} train step launch counts {counts()} != {per_step}")
    p = run(plain_patches(), False)
    r = p if float32_model else run(plain_patches(), True)
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
    low = {n: (cosine(k["grads"][n], r["grads"][n]),
               cosine(p["grads"][n], r["grads"][n]))
           for n in names if cos[n] < STEP_COS}
    unjudged = [n for n, (ck, cp) in low.items() if not (
        judge_float32 and ck >= STEP_COS and ck >= cp)]
    flat = lambda d: torch.cat([d["grads"][n].flatten() for n in names])
    gk, gp, gr = flat(k), flat(p), flat(r)
    dist = {"kernels": (gk - gr).norm().item() / gr.norm().item(),
            "plain": (gp - gr).norm().item() / gr.norm().item()}
    # the encoder's output, frame by frame, in the frames a SpecAugment
    # time mask covered (the step's own draw, the first from its
    # generator) and in the other valid frames
    frames = batch["feat_lengths"].tolist()
    Tp = k["logits"].shape[1]
    out_len = (field or CONV2D_FIELD)[0]
    valid = length_mask(torch.tensor([out_len(f) for f in frames],
                                     device="cuda"), Tp)
    masks = draw_masks(torch.Generator().manual_seed(5),
                       batch["feat_lengths"], 80, **specaug_cfg)
    tm = time_masked(masks, frames, Tp, field).to("cuda")
    out_dist = {}
    for region, m in (("time-masked", tm & valid), ("other", ~tm & valid)):
        if not m.any():
            continue
        ref = r["logits"][m]
        ek, ep = ((d["logits"][m] - ref).norm() / ref.norm() for d in (k, p))
        out_dist[region] = (int(m.sum()), ek.item(), ep.item())
    stats_rel = max((((k["buffers"][n] - p["buffers"][n]).norm()
                      / p["buffers"][n].norm()).item() for n in k["buffers"]),
                    default=0.0)
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    terms_rel = {t: abs(v - p["terms"][t]) / abs(p["terms"][t])
                 for t, v in k["terms"].items()}
    gn_rel = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
    if terms_rel:
        log(f"[step] {what} loss terms, kernels / plain bf16 / plain "
            f"float32 (kernels vs plain rel, tol {STEP_LOSS_REL}): "
            + "; ".join(f"{t} {k['terms'][t]:.6g} / {p['terms'][t]:.6g} / "
                        f"{r['terms'][t]:.6g} ({e:.3g})"
                        for t, e in terms_rel.items()))
    log(f"[step] {what} train step on the {where} (dropout, "
        f"SpecAugment), kernels / plain bf16 / plain float32: loss "
        f"{k['loss']:.6g} / {p['loss']:.6g} / {r['loss']:.6g} (kernels vs "
        f"plain rel {loss_rel:.3g}, tol {STEP_LOSS_REL}); grad norm "
        f"{k['grad_norm']:.6g} / {p['grad_norm']:.6g} / "
        f"{r['grad_norm']:.6g} (rel {gn_rel:.3g}, tol {STEP_GNORM_REL}); "
        f"running statistics rel {stats_rel:.3g} (tol {STEP_STATS_REL})")
    log(f"[step] {what} gradient cosine, kernels vs plain bf16, over "
        f"{len(cos)} tensors: min {cos[worst]:.5f} ({worst}; against the "
        f"float32 step: kernels {cosine(k['grads'][worst], r['grads'][worst]):.5f}"
        f", plain {cosine(p['grads'][worst], r['grads'][worst]):.5f}), "
        f"median {sorted(cos.values())[len(cos) // 2]:.5f} (tol {STEP_COS}; "
        f"exact-zero bias gradients not gated)")
    if low:
        log(f"[step] {what} {len(low)} tensors below {STEP_COS} against "
            f"plain bf16; their cosines to the float32 step, kernels / "
            f"plain bf16: " + ", ".join(
                f"{n} {ck:.5f} / {cp:.5f}" for n, (ck, cp) in low.items())
            + (f" (judged by the float32 step: each kernel cosine at least "
               f"{STEP_COS} and at least the plain one's)" if judge_float32
               else ""))
    log(f"[step] {what} distance to the float32 step: gradient kernels "
        f"{dist['kernels']:.4g}, plain bf16 {dist['plain']:.4g}; {out_name} "
        + "; ".join(f"{reg} frames ({n}) kernels {ek:.4g}, plain {ep:.4g}"
                    for reg, (n, ek, ep) in out_dist.items())
        + (f" (kernels within {STEP_F32_REL}: the model is float32, its "
           f"plain step the float32 step)" if float32_model
           else f" (kernels within {STEP_CONTROL}x plain)"))
    if loss_rel > STEP_LOSS_REL or gn_rel > STEP_GNORM_REL \
            or stats_rel > STEP_STATS_REL or unjudged \
            or any(e > STEP_LOSS_REL for e in terms_rel.values()):
        fail(f"the {what} kernel train step does not agree with the plain "
             "one")
    if float32_model:
        if dist["kernels"] > STEP_F32_REL or any(
                ek > STEP_F32_REL for _, ek, _ in out_dist.values()):
            fail(f"the {what} kernel train step is farther than "
                 f"{STEP_F32_REL} from the float32 step")
    elif dist["kernels"] > STEP_CONTROL * dist["plain"] or any(
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


def time_train_steps(tag, what, step, state, sched, batch, gen, per_step):
    """2 warm-up and 5 timed train steps of `step` on `batch`: each step's
    launches must equal `per_step`, its loss and grad norm be finite and
    nothing be skipped. Returns (state, the launches of the 7 steps, the
    CUDA-event ms and host wall ms of each timed step, peak GiB)."""
    import torch
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
        log(f"[{tag}] {what}step {i + 1} "
            f"({'warm-up' if i < 2 else 'timed'}): loss {loss:.5g}, grad "
            f"norm {gn:.5g}, skipped {m['skipped']}, {ms:.1f} ms (CUDA "
            f"events), {wall * 1e3:.1f} ms host wall")
        if per != per_step:
            fail(f"{what}train step launch counts {per} != {per_step}")
        if m["skipped"] or not (torch.isfinite(m["loss"])
                                and torch.isfinite(m["grad_norm"])):
            fail(f"{what}train step {i + 1}: non-finite loss or grad norm")
        if i >= 2:
            events.append(ms)
            walls.append(wall)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return state, counts(), events, [1e3 * w for w in walls], peak


def steps_line(events, walls, audio_s, peak):
    """The summary of `time_train_steps`' timed steps."""
    mean_ms = sum(events) / len(events)
    return (f"{len(events)} timed steps: {mean_ms:.1f} ms per step (CUDA "
            f"events; {min(events):.1f}..{max(events):.1f}), host wall "
            f"{sum(walls) / len(walls):.1f} ms; "
            f"{audio_s / (mean_ms / 1e3):.1f} audio-s/s trained; peak memory "
            f"{peak:.2f} GiB")


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
    state, launches, events, walls, peak = time_train_steps(
        "train", "", step, state, sched, batch, gen, PER_STEP)
    log(f"[train] {steps_line(events, walls, audio_s, peak)}; launches per "
        f"step {PER_STEP}")

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


def recipe_config(name, **kwargs):
    """egs/<name>/config.json with `kwargs` set in its encoder's kwargs."""
    with open(os.path.join(REPO, "egs", name, "config.json")) as f:
        cfg = json.load(f)
    cfg["encoder"]["kwargs"].update(kwargs)
    return cfg


def write_phono_vec(path):
    """A seeded (JOINAP_V, 51) float32 P, drawn as tests/test_recipes.py
    draws it (the recipes' phono_vec.npy is corpus data, not in the repo)."""
    import numpy as np
    np.save(path, np.random.default_rng(0).standard_normal(
        (JOINAP_V, 51)).astype(np.float32))
    return path


def encoder_timing(tag, cfg, den, per_step):
    """`time_train_steps` of the recipe model of `cfg` (seed 0, not
    perturbed) with CTC-CRF over `den` on the training batch; logs the
    summary."""
    import torch
    from cat_tpu_torch.ctc.train import (build_model, init_state,
                                         make_train_step)
    from cat_tpu_torch.utils.scheduler import build_scheduler
    model = build_model(cfg, num_classes=JOINAP_V, device="cuda", seed=0)
    sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
    tr = cfg["trainer"]
    step = make_train_step(model, opt, tr["loss"], den, tr["lamb"],
                           cfg["specaug"], grad_clip=5.0)
    batch = make_batch(TRAIN_FRAMES, seed=6)
    _, _, events, walls, peak = time_train_steps(
        "encoders", tag + " ", step, init_state(model, opt), sched, batch,
        torch.Generator().manual_seed(7), per_step)
    log(f"[encoders] {tag} on the training batch ({len(TRAIN_FRAMES)} "
        f"utterances, {sum(TRAIN_FRAMES)} frames): "
        f"{steps_line(events, walls, sum(TRAIN_FRAMES) * 0.01, peak)}; "
        f"launches per step {per_step}")
    del model, opt, step
    torch.cuda.empty_cache()


def eval_vs_plain(what, model, feats, lengths):
    """The eval forward of `model`, a JoinAP encoder over the crf-joinap
    head (JOINAP_SERVE launches: the four encoder forward kernels of each
    cell), against the same forward on the plain versions. The kernels
    compute the head's output h, which is gated within LOGIT_TOL (the
    serving gate); the logits are h @ (A·P)ᵀ with A·P the same float32
    product in both forwards (checked bit for bit), so their difference is
    h's scaled by A·P, whose logits are an order of magnitude larger than
    a conformer classifier's at this random init (P and A drawn as the JAX
    package draws them): it is printed."""
    import torch
    model.eval()
    heads = []
    hook = model.enc_head.register_forward_hook(
        lambda m, i, out: heads.append(out[0].float()))
    try:
        reset_counts()
        with torch.inference_mode():
            logits, olen = model(feats, lengths)
            ap = model.ap()
            torch.cuda.synchronize()
            if counts() != JOINAP_SERVE:
                fail(f"{what}: eval forward launches {counts()} != "
                     f"{JOINAP_SERVE}")
            plain, plain_len = patched(plain_patches(),
                                       lambda: model(feats, lengths))
            plain_ap = patched(plain_patches(), model.ap)
    finally:
        hook.remove()
    valid = torch.arange(logits.shape[1], device="cuda")[None, :] \
        < olen[:, None]
    h_diff = (heads[0] - heads[1]).abs()[valid].max().item()
    diff = (logits - plain).abs()[valid].max().item()
    scale = plain.abs()[valid].max().item()
    log(f"[encoders] {what} eval forward vs plain forward: head output "
        f"max abs diff {h_diff:.4g} (tol {LOGIT_TOL}; max |h| "
        f"{heads[1].abs()[valid].max().item():.3g}); A·P alike bit for bit; "
        f"logits max abs diff {diff:.4g} ({diff / scale:.3%} of max |logit| "
        f"{scale:.3g}), {tuple(logits.shape)} {logits.dtype}")
    if not (torch.equal(olen, plain_len) and torch.equal(ap, plain_ap)
            and logits.dtype == torch.float32 and torch.isfinite(logits).all()
            and h_diff <= LOGIT_TOL):
        fail(f"{what}: eval forward differs from the plain forward (head "
             f"output by {h_diff})")


def phase_encoders(den, card):
    """[encoders] The recipes' encoders at full width, each train step
    against its plain versions (`steps_agree`; CTC-CRF over `den`, the
    recipe's lambda, SpecAugment and scheduler): crf-joinap
    (egs/iumien/exp/crf-joinap: `JoinAPLinearEncoder` over a 14-cell, d =
    512, kernel-15 bf16 conformer, V = 72), then timed on the training
    batch; `JoinAPNonLinearEncoder` (ap_hdim 512) on the same head, its
    eval forward against the plain forward and one step; crf-tdnn
    (egs/wsj/exp/crf-tdnn: `TDNN_NAS`, hdim 640, dropout 0.5, float32),
    then timed. P is written under build/ and removed at the end."""
    import shutil
    import tempfile
    import torch
    from cat_tpu_torch.ctc.train import build_model
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="encoders-",
                            dir=os.path.join(REPO, "build"))
    try:
        pv = write_phono_vec(os.path.join(root, "phono_vec.npy"))
        batch = make_batch(FRAMES, seed=3)
        joinap = recipe_config("iumien/exp/crf-joinap", pv_path=pv)
        nonlinear = recipe_config("iumien/exp/crf-joinap", pv_path=pv,
                                  ap_hdim=512)
        nonlinear["encoder"]["type"] = "JoinAPNonLinearEncoder"
        tdnn = recipe_config("wsj/exp/crf-tdnn")
        for name, cfg, per_step, field in (
                ("crf-joinap", joinap, JOINAP_STEP, None),
                ("JoinAPNonLinearEncoder", nonlinear, JOINAP_STEP, None),
                ("crf-tdnn", tdnn, TDNN_STEP, TDNN_FIELD)):
            t = time.perf_counter()
            model = build_model(cfg, num_classes=JOINAP_V, device="cuda",
                                seed=0)
            perturb(model, torch.Generator().manual_seed(1))
            kw = cfg["encoder"]["kwargs"]
            log(f"[encoders] {name}: {cfg['encoder']['type']} "
                f"{ {k: v for k, v in kw.items() if k != 'pv_path'} }, "
                f"V={JOINAP_V}: "
                f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
                f"params, built in {time.perf_counter() - t:.1f} s")
            if name == "JoinAPNonLinearEncoder":
                eval_vs_plain(name, model, batch["feats"],
                              batch["feat_lengths"])
            start = {k: v.clone() for k, v in model.state_dict().items()}
            steps_agree(name, lambda patches, f32: train_step_once(
                model, start, cfg, den, batch, patches, f32), batch,
                cfg["specaug"], per_step, "logits", field,
                float32_model=field is TDNN_FIELD,
                judge_float32=field is None)
            del model, start
            torch.cuda.empty_cache()
            if name != "JoinAPNonLinearEncoder":
                encoder_timing(name, cfg, den, per_step)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[encoders] phase {time.perf_counter() - t_phase:.1f} s ({card})")


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
    rnnt_fusion(model, feats[:2], lengths[:2], beam)
    del model
    torch.cuda.empty_cache()


def token_lm(V, seed, path):
    """A token 3-gram over ids 1..V-1 trained on 400 seeded random
    sequences of 5-40 tokens, written to the ARPA file `path` and read
    back (tokens as ids), as `rnnt.decode --lm` reads it."""
    import numpy as np
    from cat_tpu_torch.fst.ngram import read_arpa, train_ngram, write_arpa
    rng = np.random.default_rng(seed)
    seqs = [list(map(int, rng.integers(1, V, size=int(rng.integers(5, 41)))))
            for _ in range(400)]
    write_arpa(train_ngram(seqs, order=3), path)
    return read_arpa(path, to_int=True)


def rnnt_fusion(model, feats, lengths, unfused):
    """rnnt-v1's width-16 beam over two utterances fused with a token
    3-gram (alpha 0.3, beta 0.5): two calls alike bit for bit; at alpha
    = beta = 0 the unfused beam's result."""
    import tempfile
    from cat_tpu_torch.rnnt.decode import RNNTBeamDecoder
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        t = time.perf_counter()
        lm = token_lm(RNNT_V, 20, os.path.join(d, "tokens.arpa"))
        lm_s = time.perf_counter() - t
    fused, walls = [], []
    for _ in range(2):
        reset_counts()
        t = time.perf_counter()
        fused.append(RNNTBeamDecoder(model, beam_width=16, lm=lm, alpha=0.3,
                                     beta=0.5).decode(feats, lengths))
        walls.append(time.perf_counter() - t)
        if counts() != SERVE:
            fail(f"rnnt fused beam launch counts {counts()} != {SERVE}")
    zero = RNNTBeamDecoder(model, beam_width=16, lm=lm, alpha=0.0,
                           beta=0.0).decode(feats, lengths)
    if fused[0] != fused[1]:
        fail("rnnt fused beam: two calls differ")
    if zero != unfused:
        fail("rnnt beam fused at alpha = beta = 0 differs from the unfused "
             "beam")
    log(f"[rnnt-serve] beam16 fused with a token 3-gram over V={RNNT_V} "
        f"({sum(len(lm.probs[k]) for k in (1, 2, 3))} n-grams, trained, "
        f"written to ARPA and read back in {lm_s:.2f} s; alpha 0.3, beta "
        f"0.5): {[round(w * 1e3 / 2, 1) for w in walls]} ms an utterance "
        f"(host wall, encoder included); best scores "
        f"{[round(b[0][0], 3) for b in fused[0]]}; two calls alike bit for "
        f"bit; alpha = beta = 0 gives the unfused beam's result")


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


def cuside_config():
    with open(os.path.join(REPO, "egs/aishell/exp/rnnt-cuside/config.json")) \
            as f:
        return json.load(f)


def cuside_model(task, cfg, perturbed=True):
    """The model of `task` (`rnnt.train_unified` or `ctc.train_unified`)
    for aishell rnnt-cuside's config over V = CUSIDE_V, seeded random
    weights (and random biases, norms and statistics, SimuNet's recurrent
    r and z biases kept at zero)."""
    import torch
    model = task.build_model(cfg, num_classes=CUSIDE_V, device="cuda",
                             seed=0)
    if perturbed:
        perturb(model, torch.Generator().manual_seed(1))
        simu = model.uenc.simu if hasattr(model, "uenc") else model.simu
        with torch.no_grad():
            simu.gru.bias_hh_l0[:2 * simu.hidden] = 0
    return model


def phase_cuside(card, profile=False):
    """[cuside] aishell rnnt-cuside on the card: rows 2-3 and 12-17 against
    their plain versions at its widths (D = 256, F = 1024, H = 4, Dh = 64)
    on the chunk windows of the training batch (N·C windows of T' = 35,
    every row valid) and on its full pass (T' = 299..493); the unified
    transducer step at full width against the plain bf16 and float32 steps
    with its launches pinned, then timed; a CUSIDE CTC step (the same
    encoder with a head) against its plain steps; the monotonic RNA loss
    (a plain PyTorch scan) timed at the rnnt-v1 shapes."""
    import torch
    import torch.nn.functional as F
    from cat_tpu_torch.ctc import streaming
    from cat_tpu_torch.ctc import train_unified as ctc_unified
    from cat_tpu_torch.ops.rnnt import rnnt_loss
    from cat_tpu_torch.ops.rnnt_rna import rnnt_loss_rna
    from cat_tpu_torch.ops.specaug import specaug
    from cat_tpu_torch.rnnt import train_unified
    from cat_tpu_torch.rnnt.train import transducer_nll
    from cat_tpu_torch.utils.scheduler import build_scheduler

    t_phase = time.perf_counter()
    cfg = cuside_config()
    enc, u = cfg["encoder"]["kwargs"], cfg["unified"]
    D, H = enc["hdim"], enc["num_heads"]
    win = u["left_context"] + u["chunk"] + u["right_context"]
    tw = subsampled(win)
    C = -(-max(TRAIN_FRAMES) // u["chunk"])
    n_win = len(TRAIN_FRAMES) * C
    log(f"[cuside] aishell rnnt-cuside ({card}): encoder {enc}, unified "
        f"{u}; the training batch's {len(TRAIN_FRAMES)} utterances make "
        f"{C} chunks each, {n_win} windows of {win} frames, T' = {tw}")

    # 1. the encoder kernels at the recipe's widths, both passes' shapes
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)
    rec = Records()  # logged beside their bounds, not in the JSON line
    # the profiler's split stays with the D = 512 checks: a capture here
    # once lost most of its events (no stage's launch missing from the
    # CUDA-event timings or the bit-for-bit calls)
    phase_backward_kernels(gen, rec, D, 4 * D, H, [tw] * n_win,
                           f"CUSIDE chunk windows ({n_win} of T'={tw})",
                           splits=False)
    phase_backward_kernels(gen, rec, D, 4 * D, H, None,
                           "CUSIDE full pass (the training batch)",
                           splits=False)
    log(f"[cuside] kernels at D={D}, F={4 * D}, H={H}, Dh={D // H} on both "
        f"passes' shapes agree with their plain versions, two calls bit for "
        f"bit; {time.perf_counter() - t:.1f} s")

    # 2. the unified transducer step at full width
    t = time.perf_counter()
    batch = make_batch(TRAIN_FRAMES, seed=6, vocab=CUSIDE_V,
                       frames_per_label=6)
    tr = cfg["trainer"]
    kw = dict(lamb_chunk=tr["lamb_chunk"], future=tr["future"])
    model = cuside_model(train_unified, cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def make_step():
        sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
        return train_unified.make_train_step(
            model, opt, cfg["specaug"], grad_clip=5.0, **kw), sched.lr, opt

    steps_agree("aishell rnnt-cuside", lambda patches, f32: step_once(
        model, start, make_step, batch, model.uenc.encoder, patches, f32),
        batch, cfg["specaug"], CUSIDE_STEP, "full-pass encoder output",
        where="training batch")
    del model, start
    torch.cuda.empty_cache()
    log(f"[cuside] unified step vs plain bf16 and float32: "
        f"{time.perf_counter() - t:.1f} s; launches a step {CUSIDE_STEP}")

    model = cuside_model(train_unified, cfg, perturbed=False)
    sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
    step = train_unified.make_train_step(model, opt, cfg["specaug"],
                                         grad_clip=5.0, **kw)
    gen = torch.Generator().manual_seed(7)
    audio_s = sum(TRAIN_FRAMES) * 0.01
    state, _, events, walls, peak = time_train_steps(
        "cuside", "aishell rnnt-cuside ", step,
        train_unified.init_state(model, opt), sched, batch, gen, CUSIDE_STEP)
    log(f"[cuside] aishell rnnt-cuside, V = {CUSIDE_V}, training batch: "
        f"{steps_line(events, walls, audio_s, peak)} (peak since "
        f"reset_peak_memory_stats at the phase's first step)")
    if profile:
        phase_profile(lambda: step(state, batch, sched.lr, gen),
                      "one aishell rnnt-cuside train step",
                      "chiprun_out/profile_cuside_train.txt")

    # the split of one step (CUDA events): SpecAugment, the full pass and
    # the chunk pass (encoder, predictor and joiner each; the chunk pass
    # with SimuNet), the two losses, the backward, Adam
    model.train()
    opt.zero_grad(set_to_none=True)
    labels, llens = batch["labels"], batch["label_lengths"]
    flens, w = batch["feat_lengths"], batch["weight"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    torch.cuda.synchronize()
    ev[0].record()
    feats = specaug(gen, batch["feats"], flens, **cfg["specaug"])
    ev[1].record()
    f_out, f_lens = model.full_forward(feats, flens, labels, llens, gen)
    ev[2].record()
    c_out, c_lens, l1 = model.chunk_forward(feats, flens, labels, llens, gen,
                                            tr["future"])
    ev[3].record()
    lf = (transducer_nll(model, f_out, labels, f_lens, llens) * w).mean()
    ev[4].record()
    lc = (transducer_nll(model, c_out, labels, c_lens, llens) * w).mean()
    ev[5].record()
    ((1 - kw["lamb_chunk"]) * lf + kw["lamb_chunk"] * lc + l1).backward()
    ev[6].record()
    opt.step()
    ev[7].record()
    torch.cuda.synchronize()
    part = [ev[i].elapsed_time(ev[i + 1]) for i in range(7)]
    windows, _ = streaming.make_chunks(feats, u["chunk"], u["left_context"],
                                       u["right_context"])
    chunks = windows[:, :, u["left_context"]:u["left_context"] + u["chunk"]]
    chunks = chunks.reshape(-1, u["chunk"], feats.shape[-1]).contiguous()
    with torch.no_grad():
        simu_ms = timed(lambda: model.uenc.simu(chunks), 5, 1)
    log(f"[cuside] one step split (CUDA events, ms): SpecAugment "
        f"{part[0]:.1f}, full pass {part[1]:.1f}, chunk pass {part[2]:.1f} "
        f"(SimuNet's forward alone on its {chunks.shape[0]} chunks "
        f"{simu_ms:.1f}), loss full {part[3]:.1f}, loss chunk {part[4]:.1f}, "
        f"backward {part[5]:.1f}, Adam {part[6]:.1f}; sum "
        f"{sum(part):.1f}")
    del model, opt, state, step, f_out, c_out, lf, lc, l1, feats, windows
    del chunks
    torch.cuda.empty_cache()

    # 3. a CUSIDE CTC step (the same encoder with a head)
    t = time.perf_counter()
    model = cuside_model(ctc_unified, cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def make_ctc_step():
        sched, opt = build_scheduler(cfg["scheduler"], model.parameters())
        return ctc_unified.make_train_step(
            model, opt, specaug_cfg=cfg["specaug"], grad_clip=5.0, **kw), \
            sched.lr, opt

    steps_agree("CUSIDE CTC", lambda patches, f32: step_once(
        model, start, make_ctc_step, batch, model.encoder, patches, f32),
        batch, cfg["specaug"], CUSIDE_CTC_STEP, "full-pass logits",
        where="training batch")
    del model, start
    torch.cuda.empty_cache()
    log(f"[cuside] CUSIDE CTC step vs plain: {time.perf_counter() - t:.1f} "
        f"s; launches a step {CUSIDE_CTC_STEP}")

    # 4. the monotonic loss at the rnnt-v1 shapes, beside rows 20-21
    g = torch.Generator(device="cuda").manual_seed(22)
    rb = make_batch(TRAIN_FRAMES, seed=6, vocab=RNNT_V, frames_per_label=6)
    tl = torch.tensor([subsampled(f) for f in TRAIN_FRAMES], device="cuda")
    lab, ll = rb["labels"], rb["label_lengths"]
    lp = torch.log_softmax(torch.randn(len(TRAIN_FRAMES), int(tl.max()),
                                       lab.shape[1] + 1, RNNT_V, generator=g,
                                       device="cuda"), -1)
    lp.requires_grad_()

    def fwd_bwd(loss):
        lp.grad = None
        loss(lp, lab, tl, ll).backward()

    rna_ms = timed(lambda: fwd_bwd(rnnt_loss_rna), 3, 1)
    rnnt_ms = timed(lambda: fwd_bwd(rnnt_loss), 3, 1)
    nll = rnnt_loss_rna(lp.detach(), lab, tl, ll, reduction="none")
    want = rnnt_loss_rna(lp.detach()[:2].double().cpu(), lab[:2].cpu(),
                         tl[:2].cpu(), ll[:2].cpu(), reduction="none")
    err = ((nll[:2].double().cpu() - want).abs() / want.abs()).max().item()
    if not (torch.isfinite(nll).all() and torch.isfinite(lp.grad).all()) \
            or err > RNA_RTOL:
        fail(f"rnnt_loss_rna at the rnnt-v1 shapes: finite "
             f"{bool(torch.isfinite(nll).all())}, rel err to float64 {err}")
    log(f"[cuside] rnnt_loss_rna (topo rna/ctct; a plain PyTorch scan, no "
        f"kernel) at the rnnt-v1 training batch's lattice {tuple(lp.shape)}: "
        f"forward + backward {rna_ms:.2f} ms (CUDA events, 3 calls), "
        f"rnnt_loss (rows 20-21) on the same tables {rnnt_ms:.2f} ms; "
        f"NLL within {err:.3g} relative of float64 on the CPU (2 "
        f"utterances)")
    del lp, nll
    torch.cuda.empty_cache()
    log(f"[cuside] phase {time.perf_counter() - t_phase:.1f} s ({card})")


def pipeline_cuside(root, data, card):
    """aishell rnnt-cuside's own files (12 cells, d = 256, bf16, LogAdd,
    SpecAugment, Noam + Adam, best-5 averaging, decode mode "streaming"
    at beam 16, CER) through stages 1-3 on the crf-v1 corpus at `data`,
    its SimpleTokenizer at char level, then stage 4 on a split of the
    first CUSIDE_UTTS dev utterances; then the averaged model greedy,
    offline and streaming, over that split. Cuts: the data paths,
    max_epochs 60 -> 1, check_freq 2000 -> 2, the decoded dev utterances
    32 -> CUSIDE_UTTS in one batch (decode.num_buckets 4 -> 1)."""
    import torch
    from cat_tpu_torch.models.layers import RelPositionMultiHeadAttention
    from cat_tpu_torch.pipeline import asr, tasks
    from cat_tpu_torch.rnnt.decode import RNNTBeamDecoder, make_greedy_decoder
    from cat_tpu_torch.utils import checkpoint
    from cat_tpu_torch.utils import tokenizer as tknz
    from cat_tpu_torch.utils.data import (BucketedLoader, SpeechDataset,
                                          pack_speech_data)
    from cat_tpu_torch.utils.wer import wer

    def edit(hyper, config):
        hyper["train"]["option"].update(max_epochs=1, check_freq=2)

    expdir = os.path.join(root, "exp")
    hyper, config = recipe("aishell/exp/rnnt-cuside", expdir, data, edit)
    watch = Stopwatch()
    # each decode batch's launches, whether it encoded by the chunk pass,
    # and the T' of every attention call while stage 4 decodes
    decodes, streaming, shapes, averaged = [], [], set(), {}
    decoding = []
    beam_decode = RNNTBeamDecoder.decode
    attend = RelPositionMultiHeadAttention.forward

    def decode(self, feats, flens, nbest=1):
        before = counts()
        streaming.append(self.encode == self.model.encode_streaming)
        decoding.append(True)
        try:
            out = beam_decode(self, feats, flens, nbest)
        finally:
            decoding.clear()
        torch.cuda.synchronize()
        decodes.append({k: v - before[k] for k, v in counts().items()})
        return out

    def attention_forward(self, x, *args, **kwargs):
        if decoding:
            shapes.add(x.shape[1])
        return attend(self, x, *args, **kwargs)

    def keep_average(out, paths, model=None):
        averaged.update(paths=list(paths), state=out)

    extra = {RNNTBeamDecoder: {"decode": decode},
             RelPositionMultiHeadAttention: {"forward": attention_forward},
             checkpoint: {"average_checkpoints": watch.wrap(
                 "average_checkpoints", checkpoint.average_checkpoints,
                 after=keep_average)}}
    probes, total = run_pipeline(expdir, watch, extra, ["--stop_stage", "3"])
    main_s = watch.s["main"]
    dev = SpeechDataset(os.path.join(expdir, "pkl", "dev"))
    split = f"dev{CUSIDE_UTTS}"
    pack_speech_data(os.path.join(expdir, "pkl", split),
                     [(dev.uids[i], *dev[i]) for i in range(CUSIDE_UTTS)])
    # one decode batch: the host beam's cost goes by frames and batches
    hyper["inference"]["split"] = split
    hyper["inference"]["decode"]["num_buckets"] = 1
    with open(os.path.join(expdir, "hyper-p.json"), "w") as f:
        json.dump(hyper, f, indent=1)
    _, total4 = run_pipeline(expdir, watch, extra, ["--start_stage", "4"])
    total = {k: v + total4[k] for k, v in total.items()}
    res = check_outputs(expdir, CUSIDE_UTTS, "aishell rnnt-cuside pipeline",
                        split)
    if len(probes) != 1:
        fail(f"aishell rnnt-cuside pipeline built {len(probes)} Managers")
    pr = probes[0]
    check_probe(pr, CUSIDE_STEP, CUSIDE_EVAL, "aishell rnnt-cuside pipeline")
    n_steps, n_evals, n_dec = len(pr.train), len(pr.evals), len(decodes)
    tw = subsampled(sum(config["unified"][k] for k in (
        "chunk", "left_context", "right_context")))
    if (res["mode"] != "streaming" or not n_steps or not n_dec
            or not all(streaming) or shapes != {tw}
            or any(d != CUSIDE_DECODE for d in decodes)):
        fail(f"aishell rnnt-cuside stage 4: mode {res['mode']}, {n_steps} "
             f"micro-steps, {n_dec} decode batches (streaming {streaming}), "
             f"attention T' {shapes}, launches {decodes}")
    want = {k: n_steps * CUSIDE_STEP[k] + n_evals * CUSIDE_EVAL[k]
            + n_dec * CUSIDE_DECODE[k] for k in KERNELS}
    if total != want:
        fail(f"aishell rnnt-cuside pipeline launches {total} != {want}")

    # the averaged checkpoint, greedy: offline (the full pass) and
    # streaming (the chunk pass)
    tok = tknz.load(os.path.join(expdir, "tokenizer.tknz"))
    dev = SpeechDataset(os.path.join(expdir, "pkl", split))
    model = tasks.train_module(hyper["train"]["bin"]).build_model(
        asr._with_feat_dim(config, dev.feat_dim), num_classes=tok.vocab_size,
        device="cuda")
    model.load_state_dict(averaged["state"])
    model.eval()
    opts = hyper["train"]["option"]
    loader = BucketedLoader(dev, shuffle=False,
                            frame_budget=opts["frame_budget"], num_buckets=1)
    audio_s = sum(dev.frame_length(i) for i in range(len(dev))) * 0.01
    greedy = {}
    for mode in ("offline", "streaming"):
        dec = make_greedy_decoder(model, streaming=mode == "streaming")
        refs, hyps = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in loader:
            toks, cnt = (x.cpu().numpy() for x in dec(b.feats,
                                                      b.feat_lengths))
            for n in range(len(cnt)):
                if b.weight[n] > 0:
                    refs.append(tok.decode([int(x) for x in b.labels[
                        n, :b.label_lengths[n]]]))
                    hyps.append(tok.decode([int(x) for x in
                                            toks[n, :cnt[n]]]))
        wall = time.perf_counter() - t
        r = wer(refs, hyps, char_level=True)
        greedy[mode] = (r["wer"], wall / audio_s, len(refs))
    if any(n != CUSIDE_UTTS for _, _, n in greedy.values()):
        fail(f"aishell rnnt-cuside greedy decoding: {greedy}")
    s = watch.s
    log(f"[cuside] aishell rnnt-cuside pipeline ({card}): stages 1-3 in "
        f"{main_s:.1f} s, stage 4 {s['main']:.1f} s: pack "
        f"{s['stage_pack']:.1f}, train "
        f"{s['stage_train']:.1f}, decode {s['stage_decode']:.1f}; V = "
        f"{tok.vocab_size} (chars of the corpus); {n_steps} steps (ms "
        f"{[round(r['ms'], 1) for r in pr.train]}, CUDA events), losses "
        f"{[round(r['loss'], 2) for r in pr.train]}, none skipped; "
        f"{n_evals} eval batches; launches {CUSIDE_STEP} a step, "
        f"{CUSIDE_EVAL} an eval batch; {len(pr.saves)} checkpoint writes, "
        f"{len(averaged['paths'])} averaged")
    log(f"[cuside] stage 4, mode streaming, beam 16 over {CUSIDE_UTTS} dev "
        f"utterances: {n_dec} batches, each the chunk pass's forward "
        f"kernels ({CUSIDE_DECODE}) at attention T' = {tw}; CER "
        f"{res['wer']:.2f} %, RTF {res['rtf']:.4f}. The same averaged "
        f"checkpoint greedy: offline CER {greedy['offline'][0]:.2f} %, RTF "
        f"{greedy['offline'][1]:.4f}; streaming CER "
        f"{greedy['streaming'][0]:.2f} %, RTF {greedy['streaming'][1]:.4f}; "
        f"streaming gap {greedy['streaming'][0] - greedy['offline'][0]:+.2f} "
        f"CER points (a random model after {n_steps} steps: not gated)")
    del model
    torch.cuda.empty_cache()


PIPE_FOLD = 2       # crf-v1 trains at grad_accum_fold 16: cut to 2
# packed features vs the CPU fbank (the tolerance of
# tests/test_torch_fbank.py): within FEAT_ATOL + FEAT_RTOL·|x| in every
# mel bin within 16 nats of its frame's largest; in the others, which an
# f32 FFT cannot resolve, the mel power within FEAT_POWER of the frame's
# largest mel power of a float64 witness
FEAT_ATOL, FEAT_RTOL, FEAT_POWER = 1e-3, 1e-4, 1e-9
BEAM_ATOL, BEAM_RTOL = 1e-4, 1e-5   # device beam scores, card vs witness
WFST_SCORE_ATOL = 1e-3  # native vs Python WFST search scores (f32 vs f64)
WFST_NBEST = 8      # crf-wds's n-best, min(beam 16, 8); cut to 1 over dev
WFST_FRAMES = 30    # frames of the Python search's gate
FUSION_UTTS = 4     # the host-fused beam decodes 4 dev utterances, not 32
TOY_MAX_ERRORS = 2  # asr-ctc on the yes/no dev set: word errors at most
YESNO_SR = 8000
YESNO_TONES = {"yes": 440.0, "no": 880.0}


def yesno_utt(rng, words):
    """One yes/no utterance: 'yes' a 440 Hz and 'no' an 880 Hz tone of
    0.2 s, Hann-windowed, noise of 0.01 on the tones, 0.1 s of silence
    after each word and 0.05 s before the first; 8 kHz (the toy recipe's
    data, egs/template/local/make_data.py)."""
    import numpy as np
    chunks = [np.zeros(int(YESNO_SR * 0.05), np.float32)]
    for w in words:
        t = np.arange(int(YESNO_SR * 0.2)) / YESNO_SR
        tone = 0.5 * np.sin(2 * np.pi * YESNO_TONES[w] * t).astype(np.float32)
        tone *= np.hanning(len(tone)).astype(np.float32)
        chunks.append(tone + rng.standard_normal(len(tone)).astype(
            np.float32) * 0.01)
        chunks.append(np.zeros(int(YESNO_SR * 0.1), np.float32))
    return np.concatenate(chunks)


def write_split(d, utts, sr):
    """wav.scp and text of `utts` [(uid, samples, words)] under d."""
    from cat_tpu_torch.utils.audio import write_wav
    os.makedirs(os.path.join(d, "wav"))
    scp, text = [], []
    for uid, wav, words in utts:
        path = os.path.join(d, "wav", uid + ".wav")
        write_wav(path, wav, sr)
        scp.append(f"{uid} {path}")
        text.append(f"{uid} {' '.join(words)}")
    for name, lines in (("wav.scp", scp), ("text", text)):
        with open(os.path.join(d, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def make_yesno(root):
    """64 train and 20 dev yes/no utterances of 1-3 words, drawn from
    seed 0 as the JAX package's pipeline test draws them."""
    import numpy as np
    rng = np.random.default_rng(0)
    for split, n in (("train", 64), ("dev", 20)):
        utts = []
        for i in range(n):
            words = list(rng.choice(["yes", "no"],
                                    size=int(rng.integers(1, 4))))
            utts.append((f"{split}_{i:03d}", yesno_utt(rng, words), words))
        write_split(os.path.join(root, split), utts, YESNO_SR)


def make_phone_corpus(root, seed=19):
    """The crf-v1 stand-in for LibriSpeech: a lexicon of 200 words of 2-6
    of 70 phones (every phone used, so V = 72 with <s> and <unk>); phone p
    a 70 ms Hann-windowed tone of 200 + 50p Hz, 100 ms of silence after
    each word and 50 ms before the first, noise of sigma 0.01 over all;
    16 kHz. 192 train and 32 dev utterances of 15-45 words."""
    import numpy as np
    sr = 16000
    rng = np.random.default_rng(seed)
    phones = [f"p{i:02d}" for i in range(70)]
    while True:
        spell = [list(rng.integers(0, 70, int(rng.integers(2, 7))))
                 for _ in range(200)]
        if len({p for s in spell for p in s}) == 70:
            break
    words = [f"w{i:03d}" for i in range(200)]
    os.makedirs(root)
    lexicon = os.path.join(root, "lexicon.txt")
    with open(lexicon, "w") as f:
        for w, s in zip(words, spell):
            f.write(w + " " + " ".join(phones[p] for p in s) + "\n")
    n_tone, n_gap = int(0.07 * sr), int(0.1 * sr)
    win = np.hanning(n_tone)
    tone = [0.5 * np.sin(2 * np.pi * (200 + 50 * p) * np.arange(n_tone) / sr)
            * win for p in range(70)]
    for split, n in (("train", 192), ("dev", 32)):
        utts = []
        for i in range(n):
            ws = list(rng.integers(0, 200, int(rng.integers(15, 46))))
            parts = [np.zeros(int(0.05 * sr))]
            for w in ws:
                parts += [tone[p] for p in spell[w]] + [np.zeros(n_gap)]
            wav = np.concatenate(parts)
            wav = (wav + 0.01 * rng.standard_normal(len(wav))).astype(
                np.float32)
            utts.append((f"{split}{i:03d}", wav, [words[w] for w in ws]))
        write_split(os.path.join(root, split), utts, sr)
    return lexicon


def fbank_witness(wav, sr, bins):
    """The log-mel of `cat_tpu_torch.ops.fbank.log_fbank` (25 ms windows
    every 10 ms, a 512-point FFT) in float64 numpy, without CMVN."""
    import numpy as np
    from cat_tpu_torch.ops import fbank
    n, hop = int(sr * 0.025), int(sr * 0.010)
    x = np.asarray(wav, np.float64)
    T = 1 + (len(x) - n) // hop
    fr = x[np.arange(T)[:, None] * hop + np.arange(n)[None, :]]
    fr = fr - fr.mean(-1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[:, :1], fr[:, :-1]], -1)
    fr = fr * fbank.povey_window(n).astype(np.float64)
    power = np.abs(np.fft.rfft(fr, n=512, axis=-1)) ** 2
    mel = power @ fbank.mel_filterbank(bins, 512, sr).astype(np.float64)
    return np.log(np.maximum(mel, 1e-10))


def feature_errors(got, ref, wav, sr):
    """(max abs err of the CMVN features `got` against `ref` in the
    resolved bins, their share, the largest power error in the others);
    fails beyond the FEAT_* tolerances."""
    import numpy as np
    exact = fbank_witness(wav, sr, got.shape[1])
    top = exact.max(-1, keepdims=True)
    res = exact >= top - 16.0
    err = np.where(res, np.abs(got - ref), 0.0)
    bad = int((err > FEAT_ATOL + FEAT_RTOL * np.abs(ref)).sum())
    # CMVN undone with the witness's means
    lm = got.astype(np.float64) + exact.mean(0)
    power = np.where(res, 0.0, np.abs(np.exp(lm) - np.exp(exact))
                     / np.exp(top)).max()
    if got.shape != ref.shape or bad or power > FEAT_POWER:
        fail(f"packed features differ from the CPU fbank: {bad} resolved "
             f"bins beyond {FEAT_ATOL} + {FEAT_RTOL}|x| (max {err.max():.3g})"
             f", power error {power:.3g} in the others (tol {FEAT_POWER})")
    return float(err.max()), float(res.mean()), float(power)


class Stopwatch:
    """Seconds and calls of the functions it wraps (each call ends in a
    device synchronisation, so its time is the card's too)."""

    def __init__(self):
        self.s, self.n = {}, {}

    def wrap(self, name, fn, before=None, after=None):
        import torch

        def timed_fn(*args, **kwargs):
            if before:
                before(*args, **kwargs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t
            self.n[name] = self.n.get(name, 0) + 1
            if after:
                after(out, *args, **kwargs)
            return out

        return timed_fn


def run_pipeline(expdir, watch, extra=None, args=()):
    """`cat_tpu_torch.pipeline.asr.main([expdir, *args])` with its stages, the
    feature extraction, the denominator and the averaging timed by
    `watch`, and every Manager it builds probed (`Probe`); `extra`: more
    patches. Returns the probes and the launch counts of the run, set to 0
    just before it."""
    import torch
    from cat_tpu_torch.pipeline import asr
    from cat_tpu_torch.utils import manager
    probes = []

    class ProbedManager(manager.Manager):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            probes.append(Probe(self))

    patches = {manager: {"Manager": ProbedManager},
               asr: {name: watch.wrap(name, getattr(asr, name)) for name in
                     ("stage_pack", "stage_train", "stage_decode",
                      "wav_features", "build_den")}}
    for mod, fns in (extra or {}).items():
        patches.setdefault(mod, {}).update(fns)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    patched(patches, lambda: asr.main([expdir, *args]))
    torch.cuda.synchronize()
    watch.s["main"] = time.perf_counter() - t
    return probes, counts()


def check_outputs(expdir, n_dev, what, split="dev", train_packed=True):
    """The four stages' files (pkl/train unless the train set streams from
    shards), one hypothesis (a line with a tab: a char-level tokenizer's
    units include the corpus file's newline, which a hypothesis may hold)
    and one n-best entry per utterance of the decoded split, every number
    of wer_<split>.json finite; returns the WER record."""
    from cat_tpu_torch.utils.nbest import read_nbest
    for name in ("tokenizer.tknz",
                 *(("pkl/train/meta.npz",) if train_packed else ()),
                 f"pkl/{split}/meta.npz", "check/checkpoint.list",
                 "check/metrics.jsonl", "readme.md",
                 f"decode_{split}.txt", f"nbest_{split}.pkl",
                 f"wer_{split}.json"):
        if not os.path.exists(os.path.join(expdir, name)):
            fail(f"{what}: no {name}")
    with open(os.path.join(expdir, f"decode_{split}.txt")) as f:
        lines = [line for line in f.read().splitlines() if "\t" in line]
    nbest = read_nbest(os.path.join(expdir, f"nbest_{split}.pkl"))
    with open(os.path.join(expdir, f"wer_{split}.json")) as f:
        res = json.load(f)
    nums = [v for v in res.values() if isinstance(v, (int, float))]
    if len(lines) != n_dev or len(nbest) != n_dev or not all(
            math.isfinite(v) for v in nums):
        fail(f"{what}: {len(lines)} hypotheses, {len(nbest)} n-best entries "
             f"for {n_dev} {split} utterances; wer_{split}.json {res}")
    return res


def check_probe(probe, step_want, eval_want, what):
    for i, r in enumerate(probe.train):
        if r["launches"] != step_want or r["skipped"] \
                or not math.isfinite(r["loss"]):
            fail(f"{what} micro-step {i + 1}: launches {r['launches']} != "
                 f"{step_want}, loss {r['loss']}, skipped {r['skipped']}")
    for i, r in enumerate(probe.evals):
        if r["launches"] != eval_want or not math.isfinite(r["loss_sum"]):
            fail(f"{what} eval batch {i + 1}: launches {r['launches']} != "
                 f"{eval_want}, loss {r['loss_sum']}")


def phase_pipeline(card):
    """[pipeline] `python -m cat_tpu_torch.pipeline.asr` in-process on
    synthesized data in a temporary directory under build/, removed at the
    end: crf-v1's recipe at full width through its four stages, then the
    asr-ctc toy recipe to the end of its training, aishell rnnt-cuside's
    four stages on crf-v1's corpus ([cuside]), then [sharded] (crf-wds
    and rnnt-wds from shards of crf-v1's corpus), then [wfst] on the
    crf-wds expdir (the phase's seconds include both)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="pipeline-", dir=os.path.join(REPO,
                                                                  "build"))
    try:
        pipeline_crf_v1(os.path.join(root, "crf-v1"), card)
        phase_lm(os.path.join(root, "lm"), os.path.join(root, "crf-v1"), card)
        pipeline_toy(os.path.join(root, "asr-ctc"), card)
        t = time.perf_counter()
        pipeline_cuside(os.path.join(root, "cuside"),
                        os.path.join(root, "crf-v1", "data"), card)
        log(f"[cuside] pipeline {time.perf_counter() - t:.1f} s ({card})")
        pipeline_sharded(root, card)
        t = time.perf_counter()
        pipeline_wfst(os.path.join(root, "crf-wds"), card)
        log(f"[wfst] phase {time.perf_counter() - t:.1f} s ({card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[pipeline] phase {time.perf_counter() - t_phase:.1f} s ({card})")


def recipe(name, expdir, data, edit):
    """The recipe egs/<name>'s two JSON files, the data paths set to
    `data` and `edit`(hyper, config) applied, written to expdir."""
    src = os.path.join(REPO, "egs", name)
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    hyper["data"] = {"train": os.path.join(data, "train"),
                     "dev": os.path.join(data, "dev")}
    edit(hyper, config)
    os.makedirs(expdir)
    for fname, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(os.path.join(expdir, fname), "w") as f:
            json.dump(obj, f, indent=1)
    return hyper, config


def pipeline_crf_v1(root, card):
    """crf-v1 (egs/libri/exp/crf-v1, 17 cells, d = 512, bf16, the dense
    3-gram denominator, Noam + Adam, SpecAugment, best-5 averaging, beam
    17) through the four stages on the phone corpus. Cuts: grad_accum_fold
    16 -> 2, max_epochs 80 -> 1, check_freq 2000 -> 2, the data and
    lexicon paths."""
    import numpy as np
    import torch
    from cat_tpu_torch.ctc import decode_device
    from cat_tpu_torch.pipeline import asr
    from cat_tpu_torch.utils.audio import read_wav
    from cat_tpu_torch.utils.data import SpeechDataset
    from cat_tpu_torch.utils.data_prep import wav_features

    t = time.perf_counter()
    data = os.path.join(root, "data")
    lexicon = make_phone_corpus(data)
    synth_s = time.perf_counter() - t

    def edit(hyper, config):
        hyper["tokenizer"]["option-init"]["lexicon"] = lexicon
        hyper["train"]["option"].update(max_epochs=1, check_freq=2)
        config["trainer"]["grad_accum_fold"] = PIPE_FOLD

    expdir = os.path.join(root, "exp")
    hyper, config = recipe("libri/exp/crf-v1", expdir, data, edit)
    watch = Stopwatch()
    beams, decodes, averaged = [], [], {}

    def keep_beam(out, lp, olens, **kw):
        if not beams:
            beams.append((lp.clone(), olens.clone(), kw,
                          [x.clone() for x in out]))

    def before_forward(model, feats, flens, *_):
        decodes.append(counts())
        averaged.setdefault("model", model)

    def after_forward(out, model, feats, flens, *_):
        before = decodes.pop()
        decodes.append({k: v - before[k] for k, v in counts().items()})

    def keep_average(out, paths, model=None):
        averaged.update(paths=list(paths), state=out)

    from cat_tpu_torch.utils import checkpoint
    extra = {decode_device: {"ctc_beam_search_device": watch.wrap(
                 "beam", decode_device.ctc_beam_search_device,
                 after=keep_beam)},
             asr: {"ctc_log_probs": watch.wrap(
                 "forward", asr.ctc_log_probs, before=before_forward,
                 after=after_forward)},
             checkpoint: {"average_checkpoints": watch.wrap(
                 "average_checkpoints", checkpoint.average_checkpoints,
                 after=keep_average)}}
    probes, total = run_pipeline(expdir, watch, extra)

    # the files, and the result of every dev utterance
    res = check_outputs(expdir, 32, "crf-v1 pipeline")
    # stage 2: packed features against the CPU fbank of the same WAVs
    ds = SpeechDataset(os.path.join(expdir, "pkl", "train"))
    feat = []
    for i in range(4):
        wav, sr = read_wav(os.path.join(data, "train", "wav",
                                        ds.uids[i] + ".wav"))
        feat.append(feature_errors(np.asarray(ds[i][0]),
                                   wav_features(wav, sr, 80, "cpu"), wav, sr))
    # stage 3: the Manager's steps and eval batches
    if len(probes) != 1:
        fail(f"crf-v1 pipeline built {len(probes)} Managers")
    pr = probes[0]
    check_probe(pr, PER_STEP, EVAL, "crf-v1 pipeline")
    n_steps, n_evals, n_dec = len(pr.train), len(pr.evals), len(decodes)
    if n_steps == 0 or any(d != SERVE for d in decodes) or n_dec == 0:
        fail(f"crf-v1 pipeline: {n_steps} micro-steps; decode batches' "
             f"launches {decodes}")
    want = {k: n_steps * PER_STEP[k] + n_evals * EVAL[k] + n_dec * SERVE[k]
            for k in PER_STEP}
    if total != want:
        fail(f"crf-v1 pipeline launches {total} != {want}")
    # stage 4: the averaged weights against the f64 mean of the chosen
    # checkpoints, read anew; the decode model holds them
    paths = averaged.get("paths") or []
    n_ck = len(pr.saves)
    if len(paths) != min(hyper["inference"]["avgmodel"]["num"], n_ck):
        fail(f"crf-v1 pipeline averaged {len(paths)} of {n_ck} checkpoints")
    acc = None
    for p in paths:
        sd = torch.load(p, map_location="cpu", weights_only=True,
                        mmap=True)["state"]["model"]
        if acc is None:
            acc = {k: v.double() for k, v in sd.items()}
        else:
            for k, v in sd.items():
                acc[k] += v.double()
    mean = {k: (v / len(paths)).float() for k, v in acc.items()}
    held = averaged["model"].state_dict()
    bad = [k for k, v in mean.items()
           if not (torch.equal(averaged["state"][k], v)
                   and torch.equal(held[k].cpu(), v))]
    if bad:
        fail(f"averaged weights differ from the f64 mean: {bad[:5]}")
    # the device beam: the first batch twice on the card, and against
    # its float64 witness on the CPU
    lp, olens, kw, out = beams[0]
    again = decode_device.ctc_beam_search_device(lp, olens, **kw)
    bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
    judged = judge_device_beam(out, lp, olens, kw)
    if not bitwise:
        fail("device beam: two calls on the card differ")

    s, n = watch.s, watch.n
    dev = SpeechDataset(os.path.join(expdir, "pkl", "dev"))
    audio_s = sum(d.frame_length(i) for d in (ds, dev)
                  for i in range(len(d))) * 0.01
    ms = [r["ms"] for r in pr.train]
    log(f"[pipeline] crf-v1 ({card}): corpus of 192 + 32 utterances "
        f"({audio_s:.1f} audio s) synthesized in "
        f"{synth_s:.1f} s; stages 1-4 in {s['main']:.1f} s: pack "
        f"{s['stage_pack']:.1f}, train {s['stage_train']:.1f}, decode "
        f"{s['stage_decode']:.1f}")
    log(f"[pipeline] crf-v1 features on the card: {n['wav_features']} "
        f"utterances in {s['wav_features']:.2f} s "
        f"({audio_s / s['wav_features']:.0f} "
        f"audio-s/s, fbank + CMVN with the host copies); 4 utterances vs "
        f"the CPU fbank: max abs err {max(f[0] for f in feat):.3g} in the "
        f"{min(f[1] for f in feat):.1%}+ of bins within 16 nats of their "
        f"frame's largest (tol {FEAT_ATOL} + {FEAT_RTOL}|x|), power error "
        f"in the others {max(f[2] for f in feat):.3g} of the frame's "
        f"largest (tol {FEAT_POWER}, against a float64 witness)")
    log(f"[pipeline] crf-v1 stage 3: dense 3-gram denominator built in "
        f"{s['build_den']:.2f} s; {n_steps} micro-steps at fold {PIPE_FOLD} "
        f"(ms {[round(x, 1) for x in ms]}, CUDA events), losses "
        f"{[round(r['loss'], 2) for r in pr.train]}; {n_evals} eval "
        f"batches; launches {PER_STEP} a micro-step, {EVAL} an eval batch; "
        f"{n_ck} checkpoint writes s {[round(x, 2) for x in pr.saves]}")
    log(f"[pipeline] crf-v1 stage 4: averaging of {len(paths)} checkpoints "
        f"in {s['average_checkpoints']:.1f} s, equal to their f64 mean; "
        f"{n_dec} decode batches of {SERVE} launches each; beam 17 "
        f"{1e3 * s['beam'] / n['beam']:.1f} ms a batch ({n['beam']} batches, "
        f"{100 * s['beam'] / s['stage_decode']:.1f} % of stage 4); the "
        f"first batch's beam on the card against its float64 witness: "
        f"{judged}; two calls agree bit for bit; WER "
        f"{res['wer']:.2f} % ({res['errors']} errors of {res['num_words']} "
        f"phones, a random model after {n_steps // PIPE_FOLD} updates), RTF "
        f"{res['rtf']:.4f}")


def judge_device_beam(out, lp, olens, kw):
    """The card's device beam `out` over the log-probs `lp` against the
    same search in float64 on the CPU (the witness). Each utterance's
    live lanes must hold the witness's prefixes, with scores within
    BEAM_ATOL + BEAM_RTOL·|s|, unless the witness's lane selection has a
    near-tie (at a live frame the last kept lane and the best dropped one
    closer than that tolerance, which bounds the card's f32 rounding):
    such an utterance that differs is exempt from prefix equality, and
    its best lane's score must lie within the tolerance of the witness's
    score for the same prefix, or, where the witness dropped that prefix,
    at or below the prefix's exact float64 CTC log-likelihood (of which a
    pruned beam's score is a lower bound) plus the tolerance. Fails when
    more than half of the batch is exempt. Returns a summary."""
    import torch
    import torch.nn.functional as F
    from cat_tpu_torch.ctc import decode_device
    from cat_tpu_torch.ops.semiring import LOG_EPS
    W = kw["beam_width"]
    gaps = []
    top = decode_device._top

    def watched(x, k):
        if k == W and x.shape[1] > k:  # the lane selection, not the top-K
            v = torch.sort(x, dim=1, descending=True, stable=True)[0]
            gaps.append((v[:, k - 1], v[:, k - 1] - v[:, k]))
        return top(x, k)

    lp64, olens = lp.cpu().double(), olens.cpu()
    with mock.patch.object(decode_device, "_top", watched):
        wit = decode_device.ctc_beam_search_device(lp64, olens, **kw)
    tol = lambda s: BEAM_ATOL + BEAM_RTOL * abs(float(s))
    N = lp.shape[0]
    tie = torch.zeros(N, dtype=torch.bool)
    min_gap = math.inf
    for t, (kept, gap) in enumerate(gaps):
        live = (t < olens) & (kept > LOG_EPS / 2)
        tie |= live & (gap < BEAM_ATOL + BEAM_RTOL * kept.abs())
        if bool(live.any()):
            min_gap = min(min_gap, float(gap[live].min()))
    pref, plen, score = (x.cpu() for x in out)
    score = score.double()
    bad, exempt, s_err = [], [], 0.0
    for n in range(N):
        live = score[n] > LOG_EPS / 2
        lanes = [tuple(pref[n, k, :plen[n, k]].tolist())
                 for k in range(W) if live[k]]
        want = [tuple(wit[0][n, k, :wit[1][n, k]].tolist())
                for k in range(W) if wit[2][n, k] > LOG_EPS / 2]
        err = (score[n, live] - wit[2][n, live]).abs() if lanes == want \
            else None
        if err is not None and bool((err <= BEAM_ATOL + BEAM_RTOL
                                     * wit[2][n, live].abs()).all()):
            s_err = max(s_err, float(err.max()) if len(err) else 0.0)
            continue
        if not tie[n]:
            bad.append(f"utterance {n}: differs from the witness with no "
                       f"near-tie")
            continue
        exempt.append(n)
        best, s = lanes[0], float(score[n, 0])
        if best in want:
            ref = float(wit[2][n, want.index(best)])
            ok = abs(s - ref) <= tol(ref)
        else:
            T = int(olens[n])
            ref = -float(F.ctc_loss(
                lp64[n, :T, None], torch.tensor([best or [0]]),
                torch.tensor([T]), torch.tensor([len(best)]),
                reduction="none", zero_infinity=False)[0])
            ok = s <= ref + tol(ref)
        if not ok:
            bad.append(f"utterance {n} (near-tie): best score {s:.6f} vs "
                       f"{ref:.6f}")
    if bad or 2 * len(exempt) > N:
        fail(f"device beam against its float64 witness: {len(exempt)} of "
             f"{N} utterances exempt (near-ties); {bad[:5]}")
    return (f"{N - len(exempt)} of {N} utterances with the witness's "
            f"prefixes (max score diff {s_err:.3g}), {len(exempt)} exempt "
            f"{exempt} (near-ties in {int(tie.sum())}; smallest live gap "
            f"{min_gap:.3g} nats)")


def pipeline_toy(root, card):
    """egs/template/exp/asr-ctc as its JSON files stand (the LSTM of hdim
    32, a word tokenizer, 40 mel bins, SchedulerEarlyStop, beam 8) on the
    yes/no data, trained until the run ends; at most TOY_MAX_ERRORS word
    errors on the dev set."""
    data = os.path.join(root, "data")
    make_yesno(data)
    expdir = os.path.join(root, "exp")
    recipe("template/exp/asr-ctc", expdir, data, lambda h, c: None)
    watch = Stopwatch()
    probes, total = run_pipeline(expdir, watch)
    res = check_outputs(expdir, 20, "asr-ctc pipeline")
    step = {k: int(k in ("ctc_alpha", "ctc_beta")) for k in KERNELS}
    ev = {k: int(k == "ctc_alpha") for k in KERNELS}
    pr = probes[0]
    check_probe(pr, step, ev, "asr-ctc pipeline")
    want = {k: len(pr.train) * step[k] + len(pr.evals) * ev[k]
            for k in KERNELS}
    if len(probes) != 1 or total != want:
        fail(f"asr-ctc pipeline: {len(probes)} Managers, launches {total} "
             f"!= {want}")
    with open(os.path.join(expdir, "check", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    rounds = [m for m in logged if "dev_loss" in m]
    ms = sorted(r["ms"] for r in pr.train)
    log(f"[pipeline] asr-ctc ({card}): {len(pr.train)} steps in "
        f"{rounds[-1]['epoch']} epochs (last scheduler state "
        f"{rounds[-1]['sched']}, lr {rounds[-1]['lr']:.3g}), step ms median "
        f"{ms[len(ms) // 2]:.1f} (CUDA events); stages 1-4 in "
        f"{watch.s['main']:.1f} s (train {watch.s['stage_train']:.1f}); "
        f"dev: {res['errors']} word errors of {res['num_words']} (sub "
        f"{res['sub']} ins {res['ins']} del {res['del']}; gate <= "
        f"{TOY_MAX_ERRORS}), RTF {res['rtf']:.4f}; launches 1 CTC alpha and "
        f"1 beta a step, 1 alpha an eval batch")
    if res["errors"] > TOY_MAX_ERRORS:
        fail(f"asr-ctc pipeline: {res['errors']} word errors on the dev set "
             f"(at most {TOY_MAX_ERRORS})")


SHARD_SIZE = 32     # 192 train utterances -> 6 shards (the shard shuffle)
WDS_FOLD = 2        # crf-wds trains at grad_accum_fold 16: cut to 2
WDS_ROUNDS = 3      # checkpoint rounds at most (check_freq 5000 cut)


def write_recipe_shards(data, shard_dir, expdir):
    """`python -m cat_tpu_torch.utils.data_prep --format shards` (in this
    process; the features on the card) of data/train into shard_dir, with
    the expdir's tokenizer, SHARD_SIZE utterances a shard; returns its
    seconds and the shard count."""
    import torch
    from cat_tpu_torch.utils import data_prep
    from cat_tpu_torch.utils.data_sharded import expand_shards
    torch.cuda.synchronize()
    t = time.perf_counter()
    data_prep.main([os.path.join(data, "train"), shard_dir, "--tokenizer",
                    os.path.join(expdir, "tokenizer.tknz"), "--format",
                    "shards", "--shard-size", str(SHARD_SIZE)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t,
            len(expand_shards(os.path.join(shard_dir, "shard-*.npz"))))


def sharded_recipe(name, root, data, edit):
    """The recipe egs/<name> in root/exp with its train set streamed from
    shards in root/shards (`recipe`; data.train and sharded_data both that
    dir, data/train's text beside the shards, where stage 1 and stage 4's
    graph read it; max_epochs 1), `edit`(hyper, config) applied; stage 1
    run. Returns (expdir, shard dir, hyper, config)."""
    import shutil
    shard_dir = os.path.join(root, "shards")
    os.makedirs(shard_dir)
    shutil.copy(os.path.join(data, "train", "text"), shard_dir)

    def edit_all(hyper, config):
        hyper["data"]["train"] = shard_dir
        hyper["train"]["option"].update(sharded_data=shard_dir, max_epochs=1)
        edit(hyper, config)

    expdir = os.path.join(root, "exp")
    hyper, config = recipe(name, expdir, data, edit_all)
    run_pipeline(expdir, Stopwatch(), args=["--stop_stage", "1"])
    return expdir, shard_dir, hyper, config


def epoch_one(expdir, hyper):
    """Epoch 1 of the StreamingBucketLoader the pipeline builds for
    `hyper` (`asr.shard_loader`), iterated twice: fails unless the two give the same batches
    bit for bit, or unless it yields each train utterance at most once and
    exactly those of at most the largest bucket's frames with frames // 4
    > labels. Sets check_freq so that the epoch makes at most WDS_ROUNDS
    checkpoint rounds. Returns (uids of its batches, the loader's counts,
    the number of utterances)."""
    import numpy as np
    from cat_tpu_torch.pipeline import asr
    from cat_tpu_torch.utils.data_sharded import ShardedSpeechDataset
    first, again = asr.shard_loader(hyper, 80), asr.shard_loader(hyper, 80)
    a, b = list(first.epoch(1)), list(again.epoch(1))
    same = len(a) == len(b) and all(
        x.uids == y.uids and all(np.array_equal(getattr(x, k), getattr(y, k))
                                 for k in x.asdict()) for x, y in zip(a, b))
    uids = [u for x in a for u in x.uids]
    items = list(ShardedSpeechDataset(asr._sharded(hyper),
                                      shuffle_shards=False).epoch(0))
    want = {u for u, f, l in items
            if len(f) <= first.buckets[-1] and len(f) // 4 > len(l)}
    if not same or len(uids) != len(set(uids)) or set(uids) != want:
        fail(f"{expdir}: epoch 1 of the shards: two iterations alike "
             f"{same}; {len(uids)} utterances yielded, {len(set(uids))} "
             f"distinct, {len(want)} expected")
    hyper["train"]["option"]["check_freq"] = -(-len(a) // WDS_ROUNDS)
    with open(os.path.join(expdir, "hyper-p.json"), "w") as f:
        json.dump(hyper, f, indent=1)
    return [x.uids for x in a], first.stats, len(items)


def check_sharded_run(what, expdir, probes, total, batches, step_want,
                      eval_want):
    """The Manager of a sharded stage 3: one, every micro-step `step_want`
    launches and every eval batch `eval_want`, nothing skipped, the
    batches of `epoch_one`, the run's launches all accounted for, only dev
    packed, checkpoints written. Returns (probe, the epoch's metrics)."""
    if len(probes) != 1:
        fail(f"{what}: {len(probes)} Managers")
    pr = probes[0]
    check_probe(pr, step_want, eval_want, what)
    want = {k: len(pr.train) * step_want[k] + len(pr.evals) * eval_want[k]
            for k in KERNELS}
    if total != want or pr.uids != batches or not pr.saves:
        fail(f"{what}: launches {total} != {want}; the Manager's batches "
             f"are epoch 1's: {pr.uids == batches}; {len(pr.saves)} "
             f"checkpoints")
    if sorted(os.listdir(os.path.join(expdir, "pkl"))) != ["dev"]:
        fail(f"{what}: stage 2 packed {os.listdir(os.path.join(expdir, 'pkl'))}")
    with open(os.path.join(expdir, "check", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    return pr, [m for m in logged if "data_s" in m][-1]


def pipeline_sharded(root, card):
    """[sharded] crf-wds (egs/wenetspeech/exp/crf-wds: 17 x 512 bf16
    CTC-CRF) and rnnt-wds (12 x 512, JointNet, V of the BPE) through
    stages 1-3 from npz shards of the phone corpus of `pipeline_crf_v1`
    (root/crf-v1/data), written by `cat_tpu_torch.utils.data_prep --format
    shards`, with the recipes' loader options (shuffle_buffer 4000,
    frame_budget 40,960, seed 0, the default buckets). Cuts: the data and
    lexicon paths, grad_accum_fold 16 -> 2 (crf-wds), max_epochs 3 -> 1,
    check_freq 5000 -> at most WDS_ROUNDS rounds, the BPE's vocab_size
    5538 -> what the corpus gives."""
    import numpy as np
    from cat_tpu_torch.utils import tokenizer as tknz
    data = os.path.join(root, "crf-v1", "data")
    lexicon = os.path.join(data, "lexicon.txt")

    # crf-wds, stages 1-3
    def edit(hyper, config):
        hyper["tokenizer"]["option-init"]["lexicon"] = lexicon
        config["trainer"]["grad_accum_fold"] = WDS_FOLD

    t = time.perf_counter()
    expdir, shard_dir, hyper, _ = sharded_recipe(
        "wenetspeech/exp/crf-wds", os.path.join(root, "crf-wds"), data, edit)
    write_s, n_shards = write_recipe_shards(data, shard_dir, expdir)
    batches, stats, n_utts = epoch_one(expdir, hyper)
    watch = Stopwatch()
    probes, total = run_pipeline(expdir, watch, args=[
        "--start_stage", "2", "--stop_stage", "3"])
    pr, ep = check_sharded_run("crf-wds", expdir, probes, total, batches,
                               PER_STEP, EVAL)
    got = np.load(os.path.join(expdir, "den_dense.npz"))
    want = np.load(os.path.join(root, "crf-v1", "exp", "den_dense.npz"))
    den_err = max(float(np.abs(got[k] - want[k]).max()) for k in want.files)
    if sorted(got.files) != sorted(want.files) or den_err > 1e-6:
        fail(f"crf-wds: the shards' denominator differs from crf-v1's by "
             f"{den_err}")
    ms = [r["ms"] for r in pr.train]
    log(f"[sharded] crf-wds ({card}): {n_utts} train utterances written as "
        f"{n_shards} shards of {SHARD_SIZE} in {write_s:.2f} s (fbank on the "
        f"card); epoch 1: {len(batches)} batches of "
        f"{sorted({len(b) for b in batches})} utterances, "
        f"{sum(len(b) for b in batches)} utterances, each at most once, "
        f"alike bit for bit over two iterations; dropped "
        f"{stats['too_long']} longer than the largest bucket and "
        f"{stats['infeasible']} infeasible, labels cut at their bucket's "
        f"cap in {stats['labels_cut']}")
    log(f"[sharded] crf-wds stages 2-3 {watch.s['main']:.1f} s (pack, dev "
        f"only, {watch.s['stage_pack']:.1f}; train "
        f"{watch.s['stage_train']:.1f}); den_dense.npz of the label pass "
        f"over the shards in {watch.s['build_den']:.2f} s, within "
        f"{den_err:.3g} of crf-v1's; {len(pr.train)} micro-steps at fold "
        f"{WDS_FOLD} (ms {[round(x, 1) for x in ms]}, CUDA events; launches "
        f"{PER_STEP} each, none skipped), {len(pr.evals)} eval batches, "
        f"{len(pr.saves)} checkpoint writes s "
        f"{[round(x, 2) for x in pr.saves]}; the Manager's data_s "
        f"{ep['data_s']:.3f} against step_s {ep['step_s']:.2f}")

    # rnnt-wds, stages 1-3
    def edit(hyper, config):
        del hyper["tokenizer"]["option-init"]["corpus"]  # the train text

    expdir, shard_dir, hyper, config = sharded_recipe(
        "wenetspeech/exp/rnnt-wds", os.path.join(root, "rnnt-wds"), data,
        edit)
    V = tknz.load(os.path.join(expdir, "tokenizer.tknz")).vocab_size
    write_s, n_shards = write_recipe_shards(data, shard_dir, expdir)
    batches, stats, n_utts = epoch_one(expdir, hyper)
    watch = Stopwatch()
    probes, total = run_pipeline(expdir, watch, args=[
        "--start_stage", "2", "--stop_stage", "3"])
    pr, ep = check_sharded_run("rnnt-wds", expdir, probes, total, batches,
                               RNNT_WDS_STEP, RNNT_WDS_EVAL)
    ms = [r["ms"] for r in pr.train]
    log(f"[sharded] rnnt-wds ({card}): BPE of the train text V = {V} "
        f"(the recipe asks for "
        f"{hyper['tokenizer']['option-init']['vocab_size']}: the BPE stops "
        f"when no pair repeats); "
        f"{n_shards} shards in {write_s:.2f} s; epoch 1 {len(batches)} "
        f"batches, dropped {stats['too_long']} too long and "
        f"{stats['infeasible']} infeasible, labels cut in "
        f"{stats['labels_cut']}; stages 2-3 {watch.s['main']:.1f} s (train "
        f"{watch.s['stage_train']:.1f}); {len(pr.train)} steps (ms "
        f"{[round(x, 1) for x in ms]}; launches {RNNT_WDS_STEP} each, none "
        f"skipped), {len(pr.evals)} eval batches, {len(pr.saves)} "
        f"checkpoints; data_s {ep['data_s']:.3f} against step_s "
        f"{ep['step_s']:.2f}")
    log(f"[sharded] both recipes {time.perf_counter() - t:.1f} s ({card})")


def pipeline_wfst(root, card):
    """[wfst] on the trained expdir under root (crf-wds's of
    `pipeline_sharded`): stage 4 with crf-wds's decode block
    (egs/wenetspeech/exp/crf-wds: mode "wfst", a word 3-gram TLG, beam 17;
    max_active 7000, its default, written out); then fusion and rescoring
    on a split of the first FUSION_UTTS dev utterances; then the expdir's
    denominator 3-gram read from an ARPA file through row 22. Cuts:
    n-best 8 -> 1 over the 32 dev utterances (`wfst_nbest` at K = 8 runs
    on two of them), the fused decode on FUSION_UTTS utterances."""
    import numpy as np
    import torch
    from cat_tpu_torch.ctc.decode import prefix_beam_search
    from cat_tpu_torch.fst.decode import WfstDecoder
    from cat_tpu_torch.fst.fst import Fst
    from cat_tpu_torch.fst.ngram import train_ngram, write_arpa
    from cat_tpu_torch.ops import crf_dense
    from cat_tpu_torch.pipeline import asr
    from cat_tpu_torch.utils import tokenizer as tknz
    from cat_tpu_torch.utils.data import SpeechDataset, pack_speech_data
    from cat_tpu_torch.utils.nbest import read_nbest

    expdir = os.path.join(root, "exp")
    hyper_path = os.path.join(expdir, "hyper-p.json")
    with open(hyper_path) as f:
        hyper = json.load(f)
    with open(os.path.join(REPO, "egs", "wenetspeech", "exp", "crf-wds",
                           "hyper-p.json")) as f:
        wds = json.load(f)["inference"]["decode"]
    dec = dict(wds, nbest=1, wfst=dict(wds["wfst"], max_active=7000))
    hyper["inference"]["decode"] = dec
    with open(hyper_path, "w") as f:
        json.dump(hyper, f, indent=1)

    # (A) crf-wds's WFST decode of the 32 dev utterances, 1-best
    watch = Stopwatch()
    forwards, kept, rows = [], {}, []

    def before_forward(model, feats, flens, *_):
        forwards.append(counts())

    def after_forward(out, model, feats, flens, *_):
        before = forwards.pop()
        forwards.append({k: v - before[k] for k, v in counts().items()})
        for i in range(min(2 - len(rows), len(out[1]))):
            rows.append((out[0][i].float().cpu().numpy(), int(out[1][i])))

    def keep_decoder(out, *args):
        kept["dec"] = out

    extra = {asr: {
        "ctc_log_probs": watch.wrap("forward", asr.ctc_log_probs,
                                    before=before_forward,
                                    after=after_forward),
        "_build_wfst_decoder": watch.wrap("tlg", asr._build_wfst_decoder,
                                          after=keep_decoder),
        "_wfst_search": watch.wrap("search", asr._wfst_search)},
        WfstDecoder: {
        "decode_native": watch.wrap("native", WfstDecoder.decode_native),
        "native_tables": watch.wrap("tables", WfstDecoder.native_tables)}}
    _, total = run_pipeline(expdir, watch, extra, ["--start_stage", "4"])
    packed = asr._sharded(hyper) is None
    res = check_outputs(expdir, 32, "crf-wds decode", train_packed=packed)
    n_fw = len(forwards)
    if res["mode"] != "wfst" or n_fw == 0 or any(
            d != SERVE for d in forwards) or total != {
                k: n_fw * v for k, v in SERVE.items()}:
        fail(f"crf-wds decode: mode {res['mode']}, launches a forward "
             f"{forwards}, in all {total}")
    s, n = watch.s, watch.n
    if n["native"] != 32:
        fail(f"crf-wds decode: {n['native']} native decodes for 32 "
             f"utterances")
    t = time.perf_counter()
    tlg = Fst.load(os.path.join(expdir, "tlg.npz"))
    load_s = time.perf_counter() - t
    log(f"[wfst] crf-wds decode ({card}): TLG of a word 3-gram over the "
        f"train transcripts built in {s['tlg']:.1f} s ({tlg.num_states} "
        f"states, {tlg.num_arcs} arcs), tlg.npz loads in {load_s:.2f} s; "
        f"stage 4 {s['stage_decode']:.1f} s: {n_fw} forwards "
        f"{s['forward']:.2f} s, each {SERVE} launches as in [pipeline]; the "
        f"native tables built once in {s['tables']:.2f} s; wfst_viterbi "
        f"{1e3 * (s['native'] - s['tables']) / n['native']:.1f} ms an "
        f"utterance (beam 17, max_active 7000); the host search "
        f"{s['search']:.1f} s = "
        f"{100 * s['search'] / s['stage_decode']:.1f} % of stage 4; WER "
        f"{res['wer']:.2f} % ({res['errors']} errors of {res['num_words']} "
        f"words, a random model after a few updates), RTF "
        f"{res['rtf']:.4f}")

    # n-best at K = 8 and the Python search, on two dev utterances
    wdec, id2word = kept["dec"]
    lp, lens = [r[0] for r in rows], [r[1] for r in rows]
    t = time.perf_counter()
    nbests = [wdec.decode_native_nbest(lp[i], lens[i], nbest=WFST_NBEST)
              for i in range(2)]
    nbest_s = time.perf_counter() - t
    t = time.perf_counter()
    ones = [wdec.decode_native(lp[i], lens[i]) for i in range(2)]
    one_s = time.perf_counter() - t
    for i, (nb, one) in enumerate(zip(nbests, ones)):
        scores = [sc for sc, _ in nb]
        if not nb or nb[0][1] != one[1] or abs(nb[0][0] - one[0]) > \
                WFST_SCORE_ATOL or scores != sorted(scores, reverse=True) \
                or len({tuple(w) for _, w in nb}) != len(nb):
            fail(f"wfst_nbest of utterance {i}: {nb[:2]}... against the "
                 f"1-best {one}")
    t = time.perf_counter()
    py = [wdec.decode(lp[i], WFST_FRAMES)[0] for i in range(2)]
    py_s = time.perf_counter() - t
    nat = [wdec.decode_native(lp[i], WFST_FRAMES) for i in range(2)]
    for i in range(2):
        if nat[i][1] != py[i][1] or abs(nat[i][0] - py[i][0]) > \
                WFST_SCORE_ATOL:
            fail(f"wfst native vs Python on {WFST_FRAMES} frames of "
                 f"utterance {i}: {nat[i]} != {py[i]}")
    log(f"[wfst] wfst_nbest K={WFST_NBEST} on 2 utterances ({lens} "
        f"frames): {1e3 * nbest_s / 2:.1f} ms an utterance ("
        f"{[len(nb) for nb in nbests]} hypotheses, the first the 1-best of "
        f"wfst_viterbi, {1e3 * one_s / 2:.1f} ms; scores sorted, hypotheses "
        f"distinct); the Python search on their first {WFST_FRAMES} frames "
        f"{py_s / 2:.2f} s an utterance gives the native words and scores "
        f"within {WFST_SCORE_ATOL} (max diff "
        f"{max(abs(a[0] - b[0]) for a, b in zip(nat, py)):.3g}); 1-best "
        f"word counts {[len(o[1]) for o in ones]}")

    # (B) fusion and rescoring on the first FUSION_UTTS dev utterances
    dev = SpeechDataset(os.path.join(expdir, "pkl", "dev"))
    split = f"dev{FUSION_UTTS}"
    pack_speech_data(os.path.join(expdir, "pkl", split),
                     [(dev.uids[i], *dev[i]) for i in range(FUSION_UTTS)])
    dec = {"beam_width": 17, "nbest": WFST_NBEST,
           "lm": {"type": "ngram", "order": 3}, "alpha": 0.3,
           "rescore": {"alpha": 0.2, "beta": 0.5,
                       "lm": {"type": "ngram", "order": 3}}}
    hyper["inference"].update(split=split, decode=dec)
    with open(hyper_path, "w") as f:
        json.dump(hyper, f, indent=1)
    watch, fused = Stopwatch(), []
    extra = {asr: {
        "_fused_search": watch.wrap(
            "fused", asr._fused_search,
            after=lambda out, *args: fused.append((args, out))),
        "_maybe_rescore": watch.wrap("rescore", asr._maybe_rescore)}}
    _, total = run_pipeline(expdir, watch, extra, ["--start_stage", "4"])
    res = check_outputs(expdir, FUSION_UTTS, "fused decode", split,
                        train_packed=packed)
    t = time.perf_counter()
    again = [asr._fused_search(*args) for args, _ in fused]
    again_s = time.perf_counter() - t
    if again != [out for _, out in fused]:
        fail("fused beam: two runs differ")
    args = fused[0][0]
    lp0 = args[0][0].float().cpu().numpy()
    L0 = int(args[1][0])
    t = time.perf_counter()
    zero = prefix_beam_search(lp0, L0, beam_width=17, lm=args[3], alpha=0.0,
                              beta=0.0, nbest=WFST_NBEST)
    plain = prefix_beam_search(lp0, L0, beam_width=17, nbest=WFST_NBEST)
    zero_s = time.perf_counter() - t
    if zero != plain:
        fail("fused beam at alpha = beta = 0 differs from the unfused beam")
    nbest = read_nbest(os.path.join(expdir, f"nbest_{split}.pkl"))
    want = asr._maybe_rescore(hyper, nbest, dec)
    with open(os.path.join(expdir, f"decode_{split}.txt")) as f:
        got = dict(line.split("\t", 1) for line in f.read().splitlines())
    if got != want or any(not 1 <= len(v) <= WFST_NBEST
                          for v in nbest.values()):
        fail(f"rescored hypotheses {got} != {want}")
    log(f"[wfst] fused decode of {FUSION_UTTS} dev utterances ({card}; a "
        f"token 3-gram, alpha 0.3, beam 17, n-best {WFST_NBEST}): stage 4 "
        f"{watch.s['stage_decode']:.1f} s, the host beam "
        f"{1e3 * watch.s['fused'] / FUSION_UTTS:.0f} ms an utterance, "
        f"rescoring (a word 3-gram, alpha 0.2, beta 0.5) "
        f"{watch.s['rescore']:.2f} s; launches {total}; two runs of the "
        f"fused beam alike bit for bit (the second {again_s:.1f} s); alpha "
        f"= beta = 0 gives the unfused beam ({L0} frames, both "
        f"{zero_s:.1f} s); the rescored 1-best written; WER "
        f"{res['wer']:.2f} %, RTF {res['rtf']:.4f}")

    # (C) the expdir's denominator read from ARPA, through row 22. An ARPA
    # file holds a backoff only beside an n-gram of its own, so the
    # (<s>, <s>) context's backoff of the trained 3-gram has no line (in
    # either package): the file's denominator is held to the trained LM
    # without it, and its distance to den_dense.npz is printed
    tok = tknz.load(os.path.join(expdir, "tokenizer.tknz"))
    if packed:
        tr = SpeechDataset(os.path.join(expdir, "pkl", "train"))
        seqs = [[int(x) for x in tr[i][1]] for i in range(len(tr))]
    else:
        seqs = list(asr._shard_label_seqs(asr._sharded(hyper)))
    lm = train_ngram(seqs, order=3)
    arpa = os.path.join(root, "den_lm.arpa")
    write_arpa(lm, arpa)
    os.makedirs(os.path.join(root, "den"))
    t = time.perf_counter()
    den_arpa = asr.build_den(os.path.join(root, "den"),
                             {"den_lm": {"path": arpa}}, tok, None)
    arpa_s = time.perf_counter() - t
    dropped = [(ng, b) for k in range(lm.order) for ng, b in
               lm.bows[k].items() if ng not in lm.probs[k]]
    for ng, _ in dropped:
        del lm.bows[len(ng)][ng]
    den_held = crf_dense.DenseDen.from_ngram(lm, tok.vocab_size)
    den_npz = crf_dense.DenseDen.load(os.path.join(expdir, "den_dense.npz"))
    tl = [subsampled(f) for f in TRAIN_FRAMES]
    gen = torch.Generator(device="cuda").manual_seed(21)
    lps = torch.log_softmax(_rnd(gen, len(tl), max(tl), tok.vocab_size,
                                 s=2.0), -1)
    lens_t = torch.tensor(tl, device="cuda")
    reset_counts()
    z_arpa = crf_dense.den_forward(lps, lens_t, den_arpa)[1]
    z_held = crf_dense.den_forward(lps, lens_t, den_held)[1]
    z_npz = crf_dense.den_forward(lps, lens_t, den_npz)[1]
    if counts()["den_fwd"] != 3:
        fail(f"ARPA denominator: den_fwd launches {counts()['den_fwd']}")
    e_z = close_rel("logZ of the ARPA denominator", z_arpa, z_held)
    e_w = float(np.abs(den_arpa.logw - den_held.logw).max())
    rest = np.ones(den_npz.logw.shape, bool)
    rest[0, 0] = False
    e_npz = float(np.abs(den_arpa.logw - den_npz.logw)[rest].max())
    r_npz = ((z_arpa - z_npz).abs() / z_npz.abs()).max().item()
    log(f"[wfst] the expdir's denominator 3-gram written to ARPA and read "
        f"through den_lm.path in {arpa_s:.2f} s; backoffs without a line of their "
        f"own {[(ng, round(b, 6)) for ng, b in dropped]}; den_fwd (row 22) "
        f"on the training batch (N={len(tl)}, T'={min(tl)}..{max(tl)}): "
        f"against the trained LM without them, tables within {e_w:.3g}, "
        f"logZ max abs diff {e_z:.3g}, within {LL_RTOL} relative; against "
        f"den_dense.npz, tables outside the (<s>, <s>) row within "
        f"{e_npz:.3g}, logZ max relative diff {r_npz:.3g}")


LM_CFG = {"decoder": {"type": "CausalTransformer", "kwargs": {}},
          "scheduler": {"type": "SchedulerFixedStop",
                        "kwargs": {"stop_step": 1000},
                        "optimizer": {"type": "Adam",
                                      "kwargs": {"lr": 1e-3}}}}
LM_STEPS = 3          # train steps of the full-width transformer LM
LM_LOGIT_RTOL = 1e-4  # card vs CPU logits, relative norm (TF32 off)
LM_LOSS_RTOL = 1e-5   # card vs CPU masked CE loss, relative
LM_TERM_TOL = 1e-4    # the LM terms of fusion and rescoring vs the CPU LM
LM_ALPHA, LM_BETA = 0.3, 0.5   # fusion and rescoring weights
LODR_WEIGHT = -0.3    # the token 2-gram's weight in LODR (JAX's default)
RESCORE_LM_EPOCHS = 2  # the rescoring LM's epochs (lm-nn's config: 10)


class LMRecorder:
    """An LM scorer that keeps every log10 p(tok | context) it returns."""

    def __init__(self, lm):
        self.lm, self.seen = lm, {}

    def logp(self, context, tok):
        v = self.lm.logp(context, tok)
        self.seen[(tuple(context), int(tok))] = v
        return v


def lm_token_corpus(path, seed=23, n=600):
    """600 seeded sequences of 20-480 token ids in 1..RNNT_V-1, packed."""
    import numpy as np
    from cat_tpu_torch.utils.data import CorpusDataset, pack_corpus
    rng = np.random.default_rng(seed)
    pack_corpus(path, [list(map(int, rng.integers(1, RNNT_V, int(
        rng.integers(20, 481))))) for _ in range(n)])
    return CorpusDataset(path)


def lm_sum_log10(cpu_lm, prefix):
    """Σ_i log10 p(y_i | <s> y_<i) of the CPU copy of the LM, one forward."""
    import torch
    seq = torch.tensor([[0] + list(prefix)])
    with torch.inference_mode():
        logits, _ = cpu_lm(seq, torch.tensor([seq.shape[1]]))
    lp = torch.log_softmax(logits[0].double(), -1) / math.log(10.0)
    return float(sum(lp[i, y] for i, y in enumerate(prefix)))


def phase_lm(root, crf_v1, card):
    """[lm] the neural LM family on the card (CausalTransformer at its
    declared widths, rnnt-v1 fusion and LODR, the lm-nn and lm-trf
    recipes, neural rescoring of the crf-v1 expdir's n-best)."""
    import torch
    from cat_tpu_torch.lm import train as lm_train
    t_phase = time.perf_counter()
    os.makedirs(root)
    model = lm_train.build_model(LM_CFG, RNNT_V, device="cuda", seed=0)
    cpu_lm = lm_train.build_model(LM_CFG, RNNT_V, device="cpu", seed=0)
    lm_full_width(root, model, cpu_lm, card)
    lm_fusion(root, model, cpu_lm, card)
    del model
    torch.cuda.empty_cache()
    lm_recipes(root, os.path.join(crf_v1, "data"), card)
    lm_rescoring(root, crf_v1, card)
    log(f"[lm] phase {time.perf_counter() - t_phase:.1f} s ({card})")


def lm_full_width(root, model, cpu_lm, card):
    """CausalTransformer at the widths its class declares (hdim 512, 6
    layers, 8 heads, ff 2048, max_len 2048; V = RNNT_V, tied head) from a
    seed: the forward and the loss of the first LmLoader batch on the card
    against the same weights on the CPU, then LM_STEPS train steps with
    LmLoader at its defaults (token budget 8000, max_len 512), each
    launching the dropout kernel after the embedding and each FF, forward
    and backward, and nothing else."""
    import torch
    from cat_tpu_torch.lm import train as lm_train
    from cat_tpu_torch.utils.scheduler import build_scheduler
    n_par = sum(p.numel() for p in model.parameters())
    ds = lm_token_corpus(os.path.join(root, "corpus"))
    loader = lm_train.LmLoader(ds, seed=0)
    batches = list(loader.epoch(1))[:LM_STEPS + 1]
    on = lambda b, dev: {k: torch.from_numpy(v).to(dev).long()
                         if v.dtype.kind == "i" else
                         torch.from_numpy(v).to(dev) for k, v in b.items()}
    b, bc = on(batches[0], "cuda"), on(batches[0], "cpu")
    with torch.inference_mode():
        logits, _ = model(b["tokens"], b["lengths"])
        want, _ = cpu_lm(bc["tokens"], bc["lengths"])
        loss = lm_train.make_loss_fn(model)(b, None, False)[0]
        want_loss = lm_train.make_loss_fn(cpu_lm)(bc, None, False)[0]
    valid = bc["lengths"][:, None] > torch.arange(bc["tokens"].shape[1])
    diff = (logits.cpu() - want)[valid]
    rel = float(diff.norm() / want[valid].norm())
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    if not (rel <= LM_LOGIT_RTOL and loss_rel <= LM_LOSS_RTOL
            and torch.isfinite(logits).all()):
        fail(f"[lm] transformer LM on the card vs the CPU: logits relative "
             f"norm {rel:.3g} (tol {LM_LOGIT_RTOL}), loss {float(loss)} vs "
             f"{float(want_loss)} ({loss_rel:.3g}, tol {LM_LOSS_RTOL})")
    sched, opt = build_scheduler(LM_CFG["scheduler"], model.parameters())
    state = lm_train.init_state(model, opt)
    step = lm_train.make_train_step(model, opt)
    gen = torch.Generator().manual_seed(5)
    torch.cuda.reset_peak_memory_stats()
    ms, toks, losses = [], [], []
    for i, batch in enumerate(batches[1:]):
        tb = on(batch, "cuda")
        sched.update_lr_step(i + 1)
        reset_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, m = step(state, tb, sched.lr, gen)
        e1.record()
        torch.cuda.synchronize()
        # dropout, forward and backward, after the embedding and each FF
        want_c = {k: 2 * (1 + len(model.blocks)) * (k == "dropout")
                  for k in KERNELS}
        if counts() != want_c or m["skipped"] or not math.isfinite(
                float(m["loss"])):
            fail(f"[lm] train step {i + 1}: launches {counts()} != {want_c},"
                 f" loss {float(m['loss'])}, skipped {m['skipped']}")
        ms.append(e0.elapsed_time(e1))
        toks.append(int(tb["lengths"].sum()))
        losses.append(round(float(m["loss"]), 3))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shapes = [tuple(bt["tokens"].shape) for bt in batches]
    log(f"[lm] CausalTransformer (hdim 512, 6 layers, 8 heads, ff 2048, "
        f"max_len 2048, V={RNNT_V}, tied; {n_par / 1e6:.2f} M params; "
        f"{card}): forward of {shapes[0]} on the card vs the CPU: logits "
        f"relative norm {rel:.3g} (tol {LM_LOGIT_RTOL}), loss "
        f"{float(loss):.6f} ({loss_rel:.3g}, tol {LM_LOSS_RTOL})")
    log(f"[lm] {LM_STEPS} train steps (LmLoader token budget 8000, max_len "
        f"512, batches {shapes[1:]}; dropout 0.1, Adam, clip 5): ms "
        f"{[round(x, 2) for x in ms]} (CUDA events), "
        f"{[round(t / x * 1e3) for t, x in zip(toks, ms)]} tokens/s, "
        f"losses {losses}, peak {peak:.2f} GiB, launches a step "
        f"{2 * (1 + len(model.blocks))} dropout and nothing else")


def lm_fusion(root, lm, cpu_lm, card):
    """rnnt-v1's width-16 beam on the 2 shortest utterances of the serving
    batch, with decode.lm "nn" (the transformer LM through
    `NeuralLMScorer` on the card) and "lodr" (that LM and a token 2-gram
    of weight LODR_WEIGHT): at alpha = 0 the unfused beam's result; at
    alpha > 0 the 1-best's LM term, as the beam took it, equal to one CPU
    forward's within LM_TERM_TOL, and its score = AM + alpha·LM·ln10 +
    beta·len."""
    import torch
    from cat_tpu_torch.fst.ngram import read_arpa, train_ngram, write_arpa
    from cat_tpu_torch.lm.scorer import NeuralLMScorer
    from cat_tpu_torch.rnnt.decode import CombinedLM, RNNTBeamDecoder
    import numpy as np
    # the LM as its train steps left it, on the CPU too
    cpu_lm.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    model = rnnt_model(load_config("rnnt-v1"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    N, T = len(FRAMES), max(FRAMES)
    lengths = torch.tensor(FRAMES, device="cuda")
    feats = torch.randn(N, T, 80, generator=gen, device="cuda")
    feats *= (torch.arange(T, device="cuda")[None, :, None]
              < lengths[:, None, None])
    feats, lengths = feats[-2:, :max(FRAMES[-2:])], lengths[-2:]
    beam = lambda **kw: RNNTBeamDecoder(model, beam_width=16, **kw).decode(
        feats, lengths)
    unfused = beam()
    rng = np.random.default_rng(21)
    path = os.path.join(root, "tokens2.arpa")
    write_arpa(train_ngram([list(map(int, rng.integers(
        1, RNNT_V, int(rng.integers(5, 41))))) for _ in range(400)], 2),
        path)
    ngram = read_arpa(path, to_int=True)
    lines = []
    for kind in ("nn", "lodr"):
        scorer = NeuralLMScorer(lm)
        fused_lm = (scorer if kind == "nn" else
                    CombinedLM([(scorer, 1.0), (ngram, LODR_WEIGHT)]))
        rec = LMRecorder(fused_lm)
        reset_counts()
        t = time.perf_counter()
        fused = beam(lm=rec, alpha=LM_ALPHA, beta=LM_BETA)
        wall = time.perf_counter() - t
        forwards = scorer.forwards
        if counts() != SERVE:
            fail(f"[lm] rnnt-v1 beam with decode.lm {kind}: launches "
                 f"{counts()} != {SERVE}")
        zero = beam(lm=fused_lm, alpha=0.0, beta=0.0)
        if zero != unfused:
            fail(f"[lm] rnnt-v1 beam with decode.lm {kind} at alpha = beta "
                 f"= 0 differs from the unfused beam")
        worst = 0.0
        for n, hyps in enumerate(fused):
            score, prefix = hyps[0]
            took = sum(rec.seen[(tuple(prefix[:i]), y)]
                       for i, y in enumerate(prefix))
            want = lm_sum_log10(cpu_lm, prefix)
            if kind == "lodr":
                want += LODR_WEIGHT * sum(ngram.logp(tuple(prefix[:i]), y)
                                          for i, y in enumerate(prefix))
            am = score - LM_ALPHA * math.log(10.0) * took \
                - LM_BETA * len(prefix)
            recomposed = am + LM_ALPHA * math.log(10.0) * want \
                + LM_BETA * len(prefix)
            err = abs(took - want)
            worst = max(worst, err)
            if err > LM_TERM_TOL * max(1.0, abs(want)) or abs(
                    recomposed - score) > LM_TERM_TOL * max(1.0, abs(score)):
                fail(f"[lm] rnnt-v1 {kind} fusion, utterance {n}: the beam's "
                     f"LM term {took} vs the CPU LM's {want}")
        lines.append(f"{kind}: {wall * 1e3 / 2:.0f} ms an utterance, "
                     f"{forwards / 2:.0f} LM forwards an utterance, 1-best "
                     f"{[len(h[0][1]) for h in fused]} tokens, scores "
                     f"{[round(h[0][0], 3) for h in fused]}, LM term max "
                     f"diff {worst:.3g}")
    log(f"[lm] rnnt-v1 beam16 fused with the transformer LM on 2 utterances "
        f"({sum(FRAMES[-2:]) * 0.01:.1f} audio s; alpha {LM_ALPHA}, beta "
        f"{LM_BETA}; host wall, encoder included; {card}): "
        + "; ".join(lines) + "; at alpha = 0 both equal the unfused beam")
    del model
    torch.cuda.empty_cache()


def lm_text(src, dst):
    """The transcripts of a data dir's `text` (uid words) as one sentence
    a line."""
    with open(os.path.join(src, "text")) as f, open(dst, "w") as g:
        g.write("".join(line.split(None, 1)[1] + "\n" for line in f
                        if len(line.split(None, 1)) == 2))
    return dst


def lm_recipe(name, expdir, data, edit=None):
    """egs/template/exp/<name>'s files with the data paths set."""
    src = os.path.join(REPO, "egs", "template", "exp", name)
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    hyper["data"] = data
    if edit:
        edit(hyper, config)
    os.makedirs(expdir)
    for fname, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(os.path.join(expdir, fname), "w") as f:
            json.dump(obj, f, indent=1)
    return expdir


def lm_outputs(expdir, what):
    for name in ("tokenizer.tknz", "pkl/train/corpus.npz",
                 "pkl/dev/corpus.npz", "check/checkpoint.list",
                 "check/metrics.jsonl", "ppl.json"):
        if not os.path.exists(os.path.join(expdir, name)):
            fail(f"[lm] {what}: no {name}")
    with open(os.path.join(expdir, "ppl.json")) as f:
        return json.load(f)


def lm_recipes(root, data, card):
    """egs/template/exp/lm-nn and lm-trf through `pipeline.lm` stages 1-4
    on the card, on the transcripts of [pipeline]'s crf-v1 corpus (192
    train and 32 dev sentences of 15-45 of 200 words); cuts: the data
    paths."""
    from cat_tpu_torch.pipeline import lm as lm_pipe
    from cat_tpu_torch.utils import tokenizer as tknz
    paths = {split: lm_text(os.path.join(data, split),
                            os.path.join(root, f"{split}.txt"))
             for split in ("train", "dev")}
    out = []
    for name in ("lm-nn", "lm-trf"):
        expdir = lm_recipe(name, os.path.join(root, name), paths)
        t = time.perf_counter()
        lm_pipe.main([expdir])
        secs = time.perf_counter() - t
        res = lm_outputs(expdir, name)
        V = tknz.load(os.path.join(expdir, "tokenizer.tknz")).vocab_size
        with open(os.path.join(expdir, "check", "metrics.jsonl")) as f:
            rounds = [json.loads(x) for x in f if '"dev_loss"' in x]
        value = res.get("ppl", res.get("trf_score_mean"))
        if not math.isfinite(value) or ("ppl" in res and value >= V):
            fail(f"[lm] {name}: ppl.json {res} (V = {V})")
        out.append(f"{name} {secs:.1f} s ({len(rounds)} epochs, dev loss "
                   f"{[round(r['dev_loss'], 3) for r in rounds]}; "
                   f"{json.dumps(res)}, V = {V})")
    log(f"[lm] pipeline.lm stages 1-4 on the card ({card}; the crf-v1 "
        f"corpus's transcripts, cut: the data paths): " + "; ".join(out))


def lm_rescoring(root, crf_v1, card):
    """The crf-v1 expdir's dev n-best rescored by a neural LM that
    `pipeline.lm` trains (lm-nn's config, RESCORE_LM_EPOCHS epochs) on the
    corpus's transcripts with the expdir's tokenizer: the decode.rescore
    path of stage 4
    (`pipeline.asr._maybe_rescore`, {"lm": {"type": "nn", "exp": ...}})
    on the text n-best, and the same rescoring of the hypotheses as phone
    ids (the lexicon tokenizer encodes words, not the phones a hypothesis
    holds): each utterance's rescored score = am − alpha·nll + beta·len
    with the nll recomputed on the CPU within LM_TERM_TOL."""
    import shutil
    from cat_tpu_torch.lm import train as lm_train
    from cat_tpu_torch.lm.rescore import neural_nll, rescore_nbest
    from cat_tpu_torch.pipeline import asr
    from cat_tpu_torch.pipeline import lm as lm_pipe
    from cat_tpu_torch.utils.nbest import read_nbest
    expdir = os.path.join(crf_v1, "exp")
    paths = {split: os.path.join(root, f"{split}.txt")
             for split in ("train", "dev")}
    def cut(hyper, config):
        hyper["train"]["option"]["max_epochs"] = RESCORE_LM_EPOCHS

    lm_dir = lm_recipe("lm-nn", os.path.join(root, "lm-crf-v1"), paths, cut)
    shutil.copy(os.path.join(expdir, "tokenizer.tknz"), lm_dir)
    t = time.perf_counter()
    lm_pipe.main([lm_dir])
    train_s = time.perf_counter() - t
    lm_outputs(lm_dir, "crf-v1 rescoring LM")
    nbest = read_nbest(os.path.join(expdir, "nbest_dev.pkl"))
    hyper = asr.load_json(os.path.join(expdir, "hyper-p.json"))
    rs = {"rescore": {"alpha": LM_ALPHA, "beta": LM_BETA,
                      "lm": {"type": "nn", "exp": lm_dir}}}
    t = time.perf_counter()
    texts = asr._maybe_rescore(hyper, nbest, rs, "cuda")
    path_s = time.perf_counter() - t
    if sorted(texts) != sorted(nbest) or any(
            texts[u] not in [h for _, h in nbest[u].values()] for u in texts):
        fail("[lm] decode.rescore with the neural LM: not one n-best "
             "hypothesis per utterance")
    lm, tok = lm_train.load_exp(lm_dir, "cuda")
    cpu_lm, _ = lm_train.load_exp(lm_dir, "cpu")
    ids = {u: {k: (am, [tok.phone_id(p) for p in h.split()])
               for k, (am, h) in hyps.items()} for u, hyps in nbest.items()}
    t = time.perf_counter()
    nll = neural_nll(lm, ids, tok)
    card_s = time.perf_counter() - t
    cpu_nll = neural_nll(cpu_lm, ids, tok)
    worst = max(abs(nll[k] - cpu_nll[k]) / max(1.0, abs(cpu_nll[k]))
                for k in nll)
    best = rescore_nbest(ids, nll, LM_ALPHA, LM_BETA)
    for u, (score, hyp) in best.items():
        want = max(am - LM_ALPHA * cpu_nll[(u, k)] + LM_BETA * len(h)
                   for k, (am, h) in ids[u].items())
        if worst > LM_TERM_TOL or abs(score - want) > LM_TERM_TOL * max(
                1.0, abs(want)):
            fail(f"[lm] neural rescoring of {u}: score {score} vs {want} "
                 f"from the CPU LM (nll diff {worst:.3g})")
    n_hyp = sum(len(h) for h in ids.values())
    changed = sum(best[u][1] != ids[u][0][1] for u in best)
    log(f"[lm] crf-v1 n-best ({len(ids)} dev utterances, {n_hyp} "
        f"hypotheses) rescored by a neural LM (lm-nn's config, "
        f"{RESCORE_LM_EPOCHS} epochs, trained by pipeline.lm on the "
        f"transcripts with the expdir's tokenizer in {train_s:.1f} s; "
        f"{card}): decode.rescore on the text n-best "
        f"{path_s:.2f} s; on phone ids {card_s * 1e3:.0f} ms on the card, "
        f"nll max rel diff vs the CPU {worst:.3g} (tol {LM_TERM_TOL}); "
        f"scores = am - {LM_ALPHA}·nll + {LM_BETA}·len; {changed} of "
        f"{len(best)} 1-bests changed")


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
    phase_encoders(den, card())
    rnnt_cfg = load_config("rnnt-v1")
    phase_rnnt_serving(rnnt_cfg)
    phase_rnnt_train_vs_plain(rnnt_cfg)
    rnnt_launches = phase_rnnt_training(rnnt_cfg, profile)
    phase_cuside(card(), profile)
    phase_pipeline(card())
    # each kernel's launches on the main path that runs it: the crf-v1
    # training phase, or the rnnt-v1 one for the RNN-T lattice kernels
    records = [rec.by_name[k] for k in KERNELS]
    for r in records:
        r["launches"] = (rnnt_launches if r["name"].startswith("rnnt_")
                         else launches)[r["name"]]
    log(f"[env] whole run {time.perf_counter() - t_all:.1f} s")

    if "jax" in sys.modules:
        fail("jax was imported")
    log(card())
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
