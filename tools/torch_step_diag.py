#!/usr/bin/env python3
"""Where a bf16 train step of the PyTorch port departs from float32.

    python3 tools/torch_step_diag.py [--mask-seeds S ...] [--cpu]

One crf-v1 CTC-CRF train step (egs/libri/exp/crf-v1/config.json, full
depth and width, the perturbed random weights of chip_smoke.py) on
chip_smoke.py's serving batch (8 utterances of 400..2400 frames), at
dropout 0 and 0.1, with SpecAugment off and on, each taken three ways
from the same weights, SpecAugment masks and dropout seeds:

  kernels  every kernel wrapper (the encoder's fused ops, the dropout,
           the CTC and dense-denominator recursions) on its CUDA kernel,
           bf16 (the port as it runs);
  plain    every kernel wrapper on its plain PyTorch version, bf16;
  f32      the plain versions, float32 throughout: the reference.

For each setting it prints the distance of the kernel and plain steps to
the f32 step (loss, gradient norm, every parameter's gradient, the logits
and the loss's gradient at the logits, split into the frames SpecAugment
masked in time and the other valid frames), and, for the kernel step,
each kernel's outputs against its plain version on the very inputs the
step gave it ("shadow" calls), split the same way. The whole record goes
to chiprun_out/step_diag.json.

--mask-seeds adds, for each seed, dropout 0 and 0.1 with SpecAugment
masks drawn from a generator of that seed in place of the step's own
draw; at dropout 0.1 it also runs the forward with one kernel at a time
(each forward kernel, the dropout, and the loss kernels under an
otherwise plain step) and with jittered plain versions (`attribute`),
and probes the loss's gradient along the kernels' logit error
(`sensitivity`).

--cpu runs a 2-cell, d=128 model on short utterances on the CPU, where
the "kernels" take their plain versions: it checks the script itself.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import ExitStack
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from cat_tpu_torch.utils import tolerance  # noqa: E402

SETTINGS = ((0.0, False), (0.0, True), (0.1, False), (0.1, True))


def rel(a, b):
    """||a - b|| / ||b||."""
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30)).item()


class Shadow:
    """Each kernel wrapper replaced by one that also calls the plain
    version on the same inputs and keeps the worst distance between the
    two per output, region (time-masked, other valid, padded frames) and
    kernel; the kernel's result goes on through the step."""

    def __init__(self, tmask, valid):
        self.tmask, self.valid = tmask, valid
        self.worst = {}

    def _regions(self, shape):
        if len(shape) < 2 or tuple(shape[:2]) != tuple(self.valid.shape):
            return None
        return {"masked": self.tmask & self.valid,
                "rest": ~self.tmask & self.valid, "padded": ~self.valid}

    def _keep(self, key, region, o, r):
        if o.numel() == 0:
            return
        err = (o - r).abs()
        bad = tolerance.beyond(o, r)
        rec = self.worst.setdefault(key, {}).setdefault(
            region, {"rel": 0.0, "max_abs": 0.0, "beyond_tol": 0,
                     "calls": 0})
        rec["rel"] = max(rec["rel"], rel(o, r))
        rec["max_abs"] = max(rec["max_abs"], err.max().item())
        rec["beyond_tol"] += bad
        rec["calls"] += 1

    def compare(self, name, got, want):
        for i, (o, r) in enumerate(zip(flat(got), flat(want))):
            o, r = o.detach().float(), r.detach().float()
            if name == "relpos_attention_fwd" and i == 1:   # lse (N, H, T)
                o, r = o.permute(0, 2, 1), r.permute(0, 2, 1)
            if name in LOG_STATES:
                # log-domain states: the live ones (floored ones are zeros)
                live = (o > LOG_EPS / 2) | (r > LOG_EPS / 2)
                o, r = o[live], r[live]
            regions = self._regions(o.shape)
            if regions is None:
                self._keep(f"{name} d{i}", "all", o, r)
                continue
            for region, m in regions.items():
                if m.any():
                    self._keep(f"{name} d{i}", region, o[m], r[m])

    def patches(self):
        out = {}
        for mod, fns in cs.plain_patches().items():
            out[mod] = {}
            for fname, pfn in fns.items():
                kfn = getattr(mod, fname)
                kname = next(k for k, w in cs.wrappers().items() if w is kfn)

                def shadow(*a, _k=kfn, _p=pfn, _n=kname, **kw):
                    got = _k(*a, **kw)
                    self.compare(_n, got, _p(*a, **kw))
                    return got
                # the wrapper counts its launch on the name it is bound to
                shadow.launches = 0
                out[mod][fname] = shadow
        return out


LOG_EPS = -1e30
# kernels whose outputs are log-domain states floored at LOG_EPS
LOG_STATES = ("ctc_alpha", "ctc_beta", "den_fwd")


def flat(out):
    """The tensors of a kernel's output, nested tuples flattened."""
    if not isinstance(out, tuple):
        return (out,)
    return tuple(t for o in out for t in flat(o))


def loss_plain():
    """The loss kernels' wrappers on their plain versions."""
    return {m: f for m, f in cs.plain_patches().items()
            if m.__name__.endswith((".ctc", ".crf_dense"))}


def set_rate(model, rate):
    """Every dropout site of `model` at `rate`."""
    from cat_tpu_torch.models.layers import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate
        elif hasattr(m, "dropout_rate"):
            m.dropout_rate = rate


def run_step(model, start, cfg, den, batch, rate, spec, mode, shadow=None):
    """chip_smoke.train_step_once at dropout `rate`, with the kernels
    (shadowed when `shadow` is given), the plain versions or the plain
    versions in float32."""
    set_rate(model, rate)
    patches = {"kernels": shadow.patches() if shadow else None,
               "plain": cs.plain_patches(),
               "f32": cs.plain_patches()}[mode]
    return cs.train_step_once(model, start, cfg, den, batch, patches,
                              f32=mode == "f32", specaug=spec)


def loss_grad(logits, batch, lengths, den, lamb, kernels=True):
    """The CTC-CRF loss (weighted mean) at given logits and its gradient
    with respect to them, on the loss kernels or their plain versions."""
    import torch
    from cat_tpu_torch.ops.crf_dense import ctc_crf_loss_dense

    def run():
        x = logits.detach().clone().requires_grad_()
        per = ctc_crf_loss_dense(torch.log_softmax(x, -1), batch["labels"],
                                 lengths, batch["label_lengths"], den, lamb,
                                 reduction="none")
        w = batch["weight"].float()
        loss = (per * w).sum() / w.sum().clamp_min(1.0)
        (g,) = torch.autograd.grad(loss, x)
        return loss.item(), g

    return run() if kernels else cs.patched(loss_plain(), run)


def sensitivity(k, p, r, batch, lengths, den, lamb, valid):
    """How the loss's gradient at the logits answers perturbations of the
    f32 logits the size of the bf16 steps' errors: along the kernel
    step's error, mirrored, along the plain step's error, and random
    normal errors with the kernel error's RMS in every frame. Returns
    the relative distance of each gradient to the one at the f32 logits,
    in all and per utterance."""
    import torch
    l32 = r["logits"]
    dk, dp = k["logits"] - l32, p["logits"] - l32
    _, g32 = loss_grad(l32, batch, lengths, den, lamb)
    rms = dk.pow(2).mean(-1, keepdim=True).sqrt()
    probes = {f"{a} x kernel error": l32 + a * dk
              for a in (0.25, 0.5, 0.75, 1.0)}
    probes["-1 x kernel error"] = l32 - dk
    probes["plain error"] = l32 + dp
    for seed in range(4):
        noise = torch.randn(l32.shape, generator=torch.Generator().manual_seed(
            100 + seed)).to(l32.device)
        probes[f"random error {seed}"] = l32 + noise * rms
    out = {}
    for name, logits in probes.items():
        loss, g = loss_grad(logits, batch, lengths, den, lamb)
        per_utt = [rel(g[n][valid[n]], g32[n][valid[n]])
                   for n in range(g.shape[0])]
        out[name] = {"loss": loss, "rel": rel(g[valid], g32[valid]),
                     "per_utterance": per_utt}
    return out


def coherence(delta, valid):
    """Per utterance: ||mean over frames of delta|| * sqrt(frames) /
    ||delta||, about 1 for errors independent from frame to frame and up
    to sqrt(frames) for an error repeated in every frame."""
    out = []
    for n in range(delta.shape[0]):
        d = delta[n][valid[n]]
        out.append((d.mean(0).norm() * d.shape[0] ** 0.5
                    / d.norm().clamp_min(1e-30)).item())
    return out


def attribute(model, start, cfg, den, batch, masks, rate, lengths, valid):
    """The step's forward (training mode, the step's dropout seeds) with
    each forward kernel (the dropout's too) alone on its CUDA kernel and
    the other fused ops on their plain versions, with every fused op on its
    plain version and the loss on its kernels, and with every fused op on
    its plain version with its output jittered by a relative error of the
    size that separates the kernel from it (four draws); per variant, the
    distance of the loss's gradient at its logits (plain loss unless the
    variant runs the loss kernels) to the one at the f32 logits (plain
    loss), per utterance, and the coherence of its logits error."""
    import torch
    from cat_tpu_torch.ops.specaug import apply_masks
    model.load_state_dict(start)
    set_rate(model, rate)
    model.train()
    feats = apply_masks(batch["feats"], masks)
    fwd = {"ffn_fwd": "ff_forward", "glu_in_fwd": "glu_in_forward",
           "bn_out_fwd": "bn_out_forward",
           "relpos_attention_fwd": "relpos_attention_forward",
           "dropout": "dropout_apply"}

    # the kernels' distance to their plain versions on this step's inputs
    # (the shadow calls): a relative error of this size, made by rounding
    # a few more or fewer elements up than the plain version does
    noise = {"ff_forward": 2e-4, "glu_in_forward": 2e-4,
             "bn_out_forward": 1e-4, "relpos_attention_forward": 1.2e-3}

    def jitter(fn, eps, gen):
        def f(*a, **kw):
            out = fn(*a, **kw)
            o = out[0] if isinstance(out, tuple) else out
            z = torch.randn(o.shape, generator=gen).to(o.device)
            o = (o.float() * (1 + eps * z)).to(o.dtype)
            return (o,) + tuple(out[1:]) if isinstance(out, tuple) else o
        return f

    def forward(keep, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with ExitStack() as stack, torch.no_grad():
            for mod, fns in cs.plain_patches().items():
                for name, fn in fns.items():
                    if gen is not None and name in noise:
                        fn = jitter(fn, noise[name], gen)
                    if name not in keep:
                        stack.enter_context(mock.patch.object(mod, name, fn))
            logits, _ = model(feats, batch["feat_lengths"],
                              torch.Generator().manual_seed(5))
        model.load_state_dict(start)   # the running statistics
        return logits.float()

    def forward32():
        f32 = torch.float32
        with ExitStack() as stack, torch.no_grad():
            for mod, fns in cs.plain_patches().items():
                for name, fn in fns.items():
                    stack.enter_context(mock.patch.object(mod, name, fn))
            gen = torch.Generator().manual_seed(5)
            h, lens = model.subsampling(feats, batch["feat_lengths"], f32)
            h = model.dropout(h, gen)
            for cell in model.cells:
                h = cell(h, lens, gen)
            logits = model.classifier(h, f32)
        model.load_state_dict(start)
        return logits

    lamb = cfg["trainer"]["lamb"]
    l32 = forward32()
    _, g32 = loss_grad(l32, batch, lengths, den, lamb, kernels=False)
    # name: (forward kernels kept, jitter seed, loss on its kernels)
    variants = {"all kernels": (set(fwd.values()), None, True),
                "all plain": (set(), None, False)}
    variants.update({f"only {k}": ({v}, None, False) for k, v in fwd.items()})
    variants["only the loss kernels"] = (set(), None, True)
    variants.update({f"plain, jittered {j}": (set(), 200 + j, False)
                     for j in range(4)})
    out = {}
    for name, (keep, seed, loss_kernels) in variants.items():
        logits = forward(keep, seed)
        _, g = loss_grad(logits, batch, lengths, den, lamb, loss_kernels)
        out[name] = {
            "logits_rel": [rel(logits[n][valid[n]], l32[n][valid[n]])
                           for n in range(logits.shape[0])],
            "coherence": coherence(logits - l32, valid),
            "grad_rel": [rel(g[n][valid[n]], g32[n][valid[n]])
                         for n in range(g.shape[0])]}
    return out


def compare_steps(a, ref, tmask, valid):
    """Distances of step `a` to step `ref`."""
    import torch
    names = [n for n in ref["grads"] if not n.endswith(cs.NOISE_GRADS)]
    ga = torch.cat([a["grads"][n].flatten() for n in names]).double()
    gr = torch.cat([ref["grads"][n].flatten() for n in names]).double()
    per = {}
    for n in names:
        x, y = a["grads"][n].flatten(), ref["grads"][n].flatten()
        per[n] = {"rel": rel(x, y),
                  "cos": (x @ y / (x.norm() * y.norm()).clamp_min(1e-30)
                          ).item()}
    cos = sorted(v["cos"] for v in per.values())
    out = {"loss_rel": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
           "grad_norm_rel": abs(a["grad_norm"] - ref["grad_norm"])
           / ref["grad_norm"],
           "grad_rel": rel(ga, gr), "grad_cos": (
               ga @ gr / (ga.norm() * gr.norm())).item(),
           "cos_min": cos[0], "cos_median": cos[len(cos) // 2],
           "per_tensor": per}
    for what in ("logits", "dlogits"):
        for region, m in (("masked", tmask & valid),
                          ("rest", ~tmask & valid)):
            if m.any():
                out[f"{what}_{region}_rel"] = rel(a[what][m], ref[what][m])
                out[f"{what}_{region}_max_abs"] = (
                    a[what][m] - ref[what][m]).abs().max().item()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="a 2-cell, d=128 model on the CPU")
    ap.add_argument("--mask-seeds", type=int, nargs="*", default=[],
                    help="also run dropout 0 and 0.1 with SpecAugment masks "
                    "drawn once from a generator of each seed and applied "
                    "in place of the step's own draw")
    args = ap.parse_args()
    import torch
    import cat_tpu_torch.ctc.train as train
    from cat_tpu_torch.models.layers import length_mask
    from cat_tpu_torch.ops.specaug import apply_masks, draw_masks

    dev = "cpu" if args.cpu else "cuda"
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cs.phase_build()
    cfg = cs.load_config()
    frames = cs.FRAMES
    if args.cpu:
        cfg["encoder"]["kwargs"].update(num_cells=2, hdim=128, num_heads=4,
                                        kernel_size=8)
        frames = [400, 320, 200]
    t0 = time.perf_counter()
    den = cs.make_den()
    model = train.build_model(cfg, num_classes=72, device=dev, seed=0)
    cs.perturb(model, torch.Generator().manual_seed(1))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = cs.make_batch(frames, seed=3, device=dev)
    Tp = max(cs.subsampled(f) for f in frames)
    lengths = torch.tensor([cs.subsampled(f) for f in frames], device=dev)
    valid = length_mask(lengths, Tp)
    draw = lambda seed: draw_masks(torch.Generator().manual_seed(seed),
                                   batch["feat_lengths"], 80,
                                   **cfg["specaug"])
    # (label, rate, SpecAugment, masks applied in place of the step's
    # draw or None, the masks the step uses); the step's own draw is the
    # first thing it takes from its generator (seed 5)
    cases = [(f"dropout {rate}, SpecAugment {'on' if spec else 'off'}",
              rate, spec, None, draw(5) if spec else None)
             for rate, spec in SETTINGS]
    for seed in args.mask_seeds:
        m = draw(seed)
        cases += [(f"dropout {rate}, SpecAugment masks of seed {seed}",
                   rate, True, m, m) for rate in (0.0, 0.1)]
    print(f"[diag] {cfg['encoder']['kwargs']}; {len(frames)} utterances, "
          f"T' {Tp}, {int(valid.sum())} valid frames", flush=True)

    record = {"frames": frames, "cases": []}
    for label, rate, spec, fixed, masks in cases:
        tmask = (torch.zeros_like(valid) if masks is None
                 else cs.time_masked(masks, frames, Tp).to(dev))
        shadow = Shadow(tmask, valid)
        t = time.perf_counter()
        with ExitStack() as stack:
            if fixed is not None:
                stack.enter_context(mock.patch.object(
                    train, "specaug",
                    lambda gen, feats, lens, _m=fixed, **kw:
                    apply_masks(feats, _m)))
            k = run_step(model, start, cfg, den, batch, rate, spec,
                         "kernels", shadow)
            p = run_step(model, start, cfg, den, batch, rate, spec, "plain")
            r = run_step(model, start, cfg, den, batch, rate, spec, "f32")
        res = {"case": label, "time_masked_frames": int((tmask & valid).sum()),
               "loss": [k["loss"], p["loss"], r["loss"]],
               "grad_norm": [k["grad_norm"], p["grad_norm"],
                             r["grad_norm"]],
               "kernels_vs_f32": compare_steps(k, r, tmask, valid),
               "plain_vs_f32": compare_steps(p, r, tmask, valid),
               "kernels_vs_plain": compare_steps(k, p, tmask, valid),
               "shadow": shadow.worst}
        record["cases"].append(res)
        print(f"== {label}, {res['time_masked_frames']} time-masked frames "
              f"({time.perf_counter() - t:.1f} s): loss kernels/plain/f32 "
              f"{k['loss']:.6g} / {p['loss']:.6g} / {r['loss']:.6g}; grad "
              f"norm {k['grad_norm']:.6g} / {p['grad_norm']:.6g} / "
              f"{r['grad_norm']:.6g}", flush=True)
        for tag in ("kernels_vs_f32", "plain_vs_f32", "kernels_vs_plain"):
            c = res[tag]
            extra = " ".join(f"{key[:-4]} {c[key]:.4g}" for key in sorted(c)
                             if key.endswith("_rel") and key.startswith(
                                 ("logits", "dlogits")))
            print(f"  {tag:17s} grad rel {c['grad_rel']:.4g}, cos "
                  f"{c['grad_cos']:.5f}; per tensor cos min "
                  f"{c['cos_min']:.4f} median {c['cos_median']:.4f}; "
                  f"{extra}", flush=True)
        ratios = sorted(
            res["kernels_vs_f32"]["per_tensor"][n]["rel"]
            / max(res["plain_vs_f32"]["per_tensor"][n]["rel"], 1e-30)
            for n in res["plain_vs_f32"]["per_tensor"])
        print(f"  per tensor |gk-g32| / |gp-g32|: median "
              f"{ratios[len(ratios) // 2]:.3f}, max {ratios[-1]:.3f}",
              flush=True)
        by_kernel = {}
        for key, regs in shadow.worst.items():
            w = by_kernel.setdefault(key.split()[0], {})
            for reg, v in regs.items():
                w[reg] = max(w.get(reg, 0.0), v["rel"])
                w["beyond"] = w.get("beyond", 0) + v["beyond_tol"]
        for name, w in sorted(by_kernel.items()):
            print(f"  shadow {name:21s} worst rel error of any output: "
                  + ", ".join(f"{reg} {v:.3g}" for reg, v in w.items()
                              if reg != "beyond")
                  + f"; elements beyond tolerance {w['beyond']}", flush=True)
        if fixed is not None:
            res["sensitivity"] = sensitivity(
                k, p, r, batch, lengths, den, cfg["trainer"]["lamb"], valid)
            for name, v in res["sensitivity"].items():
                print(f"  loss gradient at f32 logits + {name:20s}: rel "
                      f"{v['rel']:.4f} to the one at the f32 logits; per "
                      f"utterance " + " ".join(f"{e:.3f}"
                                               for e in v["per_utterance"]),
                      flush=True)
        if fixed is not None and rate > 0:
            res["attribution"] = attribute(model, start, cfg, den, batch,
                                           fixed, rate, lengths, valid)
            for name, v in res["attribution"].items():
                print(f"  forward with {name:26s} per utterance: loss "
                      f"gradient rel " + " ".join(
                          f"{e:.3f}" for e in v["grad_rel"]) + "; logits "
                      "rel " + " ".join(f"{e:.4f}" for e in v["logits_rel"])
                      + "; error coherence " + " ".join(
                          f"{e:.2f}" for e in v["coherence"]), flush=True)
        for d in (k, p, r):
            d.clear()
        if dev == "cuda":
            torch.cuda.empty_cache()
    for res in record["cases"]:
        for tag in ("kernels_vs_f32", "plain_vs_f32", "kernels_vs_plain"):
            res[tag].pop("per_tensor")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "step_diag.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"[diag] done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
