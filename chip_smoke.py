#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
1. build: compile every CUDA kernel of cat_tpu_torch/csrc with nvcc;
2. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes of the serving batch below (attention also at a
   batch of at most 512 frames after subsampling), and time both;
3. serving: the libri crf-v1 conformer (egs/libri/exp/crf-v1/config.json:
   17 cells, d=512, 8 heads, bf16; 72 classes) with seeded random weights
   decodes a ragged batch of 8 synthetic utterances through
   `cat_tpu_torch.ctc.decode.decode_batch` (greedy), and 2 of them with a
   width-16 prefix beam; the launch counters must show that every cell
   ran through the four kernels; the same forward with every fused op on
   its plain version must agree with it;
4. device: the card's name and power limit.
With --profile, one serving forward also runs under torch.profiler and
the device time by kernel is printed and written to
chiprun_out/profile.txt.

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
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
FRAMES = [2400, 1600, 1400, 1200, 1000, 800, 600, 400]  # ragged batch
ATOL = RTOL = 2e-2           # bf16 kernels vs plain versions
LOGIT_TOL = 0.25             # 17-cell bf16 forward vs its plain version
REPO = os.path.dirname(os.path.abspath(__file__))
EXPECTED = {"fused_ff_residual": 34, "fused_glu_in": 17, "fused_bn_out": 17,
            "relpos_attention": 17}


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
    """Max-abs error; fails beyond |out - ref| <= ATOL + RTOL |ref|."""
    import torch
    out, ref = out.float(), ref.float()
    if rows is not None:
        out, ref = out[rows], ref[rows]
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite output")
    err = (out - ref).abs()
    bad = (err > ATOL + RTOL * ref.abs()).sum().item()
    if bad:
        fail(f"{name}: {bad} elements beyond atol {ATOL} + rtol {RTOL}, "
             f"max abs err {err.max().item():.4g}")
    return err.max().item()


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


def phase_kernels(gen):
    """Per-kernel checks at the serving batch's shapes; returns records."""
    import torch
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops import attention, conv_module, ffn

    dev, bf = "cuda", torch.bfloat16
    D, F, H = 512, 2048, 8
    Dh = D // H
    tl = [subsampled(f) for f in FRAMES]
    N, T = len(tl), max(tl)
    R = N * T
    lengths = torch.tensor(tl, device=dev)
    mask = length_mask(lengths, T)

    def rnd(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    records = []

    def record(name, source, replaces, err, k_ms, p_ms, flops, nbytes, what):
        b = bound_ms(flops, nbytes)
        by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES \
            else "bytes"
        log(f"[kernel] {name} {what}: max_abs_err {err:.4g} (tol atol {ATOL} "
            f"+ rtol {RTOL}), kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {b:.4f} ms ({by})")
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b, "bound_by": by, "library_ms": None})

    # fused FF module
    x = rnd(N, T, D, dtype=bf)
    # weight matrices in bf16 and vectors in f32, as the kernels read
    # them, so that the wrappers' timings hold no casts
    ffp = (1 + rnd(D, s=0.1), rnd(D, s=0.1),
           rnd(D, F, s=D ** -0.5, dtype=bf), rnd(F, s=0.1),
           rnd(F, D, s=F ** -0.5, dtype=bf), rnd(D, s=0.1))
    out = ffn.fused_ff_residual(x, *ffp)
    err = compare("ffn_fwd", out, ffn.ff_reference(x, *ffp))
    k_ms = timed(lambda: ffn.fused_ff_residual(x, *ffp))
    p_ms = timed(lambda: ffn.ff_reference(x, *ffp))
    record("ffn_fwd", "cat_tpu_torch/csrc/ffn_fwd.cu",
           "cat_tpu/ops/ffn_pallas.py:76", err, k_ms, p_ms,
           4 * R * D * F, 2 * R * D * 2 + 2 * D * F * 2 + (3 * D + F) * 4,
           f"R={R} D={D} F={F}")

    # conv module entry stage
    glp = (1 + rnd(D, s=0.1), rnd(D, s=0.1),
           rnd(D, 2 * D, s=D ** -0.5, dtype=bf), rnd(2 * D, s=0.1))
    out = conv_module.fused_glu_in(x, mask, *glp)
    err = compare("glu_in_fwd", out, conv_module.glu_in_reference(x, mask, *glp))
    k_ms = timed(lambda: conv_module.fused_glu_in(x, mask, *glp))
    p_ms = timed(lambda: conv_module.glu_in_reference(x, mask, *glp))
    record("glu_in_fwd", "cat_tpu_torch/csrc/conv_module_fwd.cu",
           "cat_tpu/ops/conv_module_pallas.py:53", err, k_ms, p_ms,
           4 * R * D * D, 2 * R * D * 2 + R * 4 + 2 * D * D * 2 + 4 * D * 4,
           f"R={R} D={D}")

    # conv module exit stage
    c = rnd(N, T, D, dtype=bf)
    bnp = (rnd(D, s=0.1), 1 + rnd(D, s=0.2).abs(), 1 + rnd(D, s=0.1),
           rnd(D, s=0.1), rnd(D, D, s=D ** -0.5, dtype=bf), rnd(D, s=0.1))
    out = conv_module.fused_bn_out(c, x, mask, *bnp)
    err = compare("bn_out_fwd", out,
                  conv_module.bn_out_reference(c, x, mask, *bnp))
    k_ms = timed(lambda: conv_module.fused_bn_out(c, x, mask, *bnp))
    p_ms = timed(lambda: conv_module.bn_out_reference(c, x, mask, *bnp))
    record("bn_out_fwd", "cat_tpu_torch/csrc/conv_module_fwd.cu",
           "cat_tpu/ops/conv_module_pallas.py:237", err, k_ms, p_ms,
           2 * R * D * D, 3 * R * D * 2 + R * 4 + D * D * 2 + 5 * D * 4,
           f"R={R} D={D}")

    # rel-pos attention: the serving batch (T' > 512) and, without its
    # longest utterance, a batch of at most 512 frames
    for lens in (tl, tl[1:]):
        n, t = len(lens), max(lens)
        lt = torch.tensor(lens, device=dev)
        q, k, v = (rnd(n, t, H, Dh, dtype=bf) for _ in range(3))
        p = rnd(2 * t - 1, H, Dh, s=0.5, dtype=bf)
        ub, vb = rnd(H, Dh, s=0.1, dtype=bf), rnd(H, Dh, s=0.1, dtype=bf)
        args = (q, k, v, p, ub, vb, lt)
        out = attention.relpos_attention(*args)
        valid = length_mask(lt, t)
        err = compare(f"relpos_attention_fwd T={t}", out,
                      attention.relpos_attention_reference(*args), valid)
        if not (out.float()[~valid] == 0).all():
            fail("relpos_attention_fwd: padded query rows are not zero")
        k_ms = timed(lambda: attention.relpos_attention(*args))
        p_ms = timed(lambda: attention.relpos_attention_reference(*args))
        # three L x L x Dh products per utterance and head; q, k, v read
        # for the valid rows, p once, the output written whole
        sq = sum(L * L for L in lens)
        flops = 6 * sq * Dh * H
        nbytes = (3 * sum(lens) * D + (2 * t - 1) * D + n * t * D) * 2
        record("relpos_attention_fwd",
               "cat_tpu_torch/csrc/relpos_attention_fwd.cu",
               "cat_tpu/ops/attention_pallas.py:563", err, k_ms, p_ms, flops,
               nbytes, f"N={n} T={t} H={H} Dh={Dh}")
    records.pop()  # the JSON line keeps the serving batch's case
    return records


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


def phase_serving():
    import torch
    from cat_tpu_torch.ctc.decode import decode_batch, greedy_decode
    from cat_tpu_torch.ctc.train import build_model
    from cat_tpu_torch.ops import attention, conv_module, ffn

    wrappers = {"fused_ff_residual": ffn.fused_ff_residual,
                "fused_glu_in": conv_module.fused_glu_in,
                "fused_bn_out": conv_module.fused_bn_out,
                "relpos_attention": attention.relpos_attention}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    with open(os.path.join(REPO, "egs/libri/exp/crf-v1/config.json")) as f:
        cfg = json.load(f)
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

    reset()
    greedy = decode_batch(model, feats, lengths, "greedy")
    torch.cuda.synchronize()
    seen = counts()
    log(f"[serve] greedy decode of {N} utterances: launches {seen}")
    if seen != EXPECTED:
        fail(f"launch counts {seen} != {EXPECTED} for one forward")
    launches = dict(seen)
    reset()
    t = time.perf_counter()
    beam = decode_batch(model, feats[:2], lengths[:2], "beam",
                        beam_width=16)
    beam_s = time.perf_counter() - t
    if counts() != EXPECTED:
        fail(f"beam decode launch counts {counts()} != {EXPECTED}")
    for n in range(2):
        log(f"[serve] beam16 utt {n}: score {beam[n][0][0]:.3f}, "
            f"{len(beam[n][0][1])} tokens; greedy {len(greedy[n][0][1])} "
            f"tokens")
    log(f"[serve] beam16 decode of 2 utterances "
        f"({sum(FRAMES[:2]) * 0.01:.1f} audio s), forward and host search: "
        f"{beam_s * 1e3:.1f} ms host wall")

    with torch.inference_mode():
        logits, olen = model(feats, lengths)
        patches = {ffn: {"fused_ff_residual": ffn.ff_reference},
                   conv_module: {"fused_glu_in": conv_module.glu_in_reference,
                                 "fused_bn_out": conv_module.bn_out_reference},
                   attention: {"relpos_attention":
                               attention.relpos_attention_reference}}
        with ExitStack() as stack:
            for mod, fns in patches.items():
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
    return launches, forward


def phase_profile(forward):
    """Device time of one serving forward by kernel (torch.profiler), and
    the device's busy share over the span from its first kernel's start
    to its last kernel's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # warm the profiler up
        forward()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        forward()
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
    lines = [f"{t:10.1f} us {100 * t / total:5.1f}% {n:5d}x  {k}"
             for t, n, k in rows]
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    log(f"[profile] one forward: {len(kernels)} kernels, device time "
        f"{total / 1e3:.3f} ms over a span of {span / 1e3:.3f} ms; busy "
        f"share {busy / span:.3f}")
    for line in lines[:15]:
        log(f"[profile] {line[:150]}")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build()
    records = phase_kernels(torch.Generator(device="cuda").manual_seed(0))
    launches, forward = phase_serving()
    if "--profile" in sys.argv[1:]:
        phase_profile(forward)
    for rec, key in zip(records, ("fused_ff_residual", "fused_glu_in",
                                  "fused_bn_out", "relpos_attention")):
        rec["launches"] = launches[key]

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
