"""The LM experiment pipeline: tokenizer -> pack corpus -> train ->
evaluate (counterpart of `cat_tpu/pipeline/lm.py`).

    python -m cat_tpu_torch.pipeline.lm <expdir> [--start_stage 1]
        [--stop_stage 4] [--device cuda|cpu]

reads a recipe's files unchanged (egs/template/exp/lm-nn, lm-trf):

  expdir/
    hyper-p.json   {"data": {"train", "dev"}: text files, one sentence a
                    line; "tokenizer"; "train": {"bin", "option":
                    {token_budget, num_buckets, max_len, max_epochs,
                    check_freq, seed, resume}}}
    config.json    {"decoder": {"type", "kwargs"}, "scheduler"}

and runs on the card unless `--device cpu` is given. The bin
(`cat_tpu.lm.train` or `cat_tpu.lm.train_trf`, either package's name)
picks the trainer.

  1 tokenizer: built from data.train, or loaded (`pipeline/text.py`).
  2 pack: each split's sentences encoded into pkl/<split>/corpus.npz.
  3 train: the `Manager` over `lm.train.LmLoader`s with the recipe's
    scheduler and optimizer; a TRF model's length prior from the train
    corpus.
  4 evaluate: the best checkpoint's dev perplexity, written to ppl.json
    as {"ppl"}; a TRF model's mean dev TRF score (unnormalised) as
    {"trf_score_mean"}.

`config.perf` is printed and ignored: the port has no implementation
switches.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cat_tpu_torch.pipeline import tasks
from cat_tpu_torch.pipeline.asr import load_json
from cat_tpu_torch.pipeline.text import stage_tokenizer
from cat_tpu_torch.utils.data_prep import check_device


def _is_trf(hyper):
    return tasks.bin_key(hyper["train"].get("bin", "")) == "lm.train_trf"


def _trainer(hyper):
    """The port's LM trainer module of the experiment's bin."""
    return tasks.train_module(hyper["train"].get("bin", "cat_tpu.lm.train"),
                              "lm")


def _read_lines(path, tok):
    with open(path) as f:
        return [tok.encode(line.strip()) for line in f if line.strip()]


def stage_pack(expdir, hyper, tok):
    from cat_tpu_torch.utils.data import pack_corpus

    pkl_dir = os.path.join(expdir, "pkl")
    for split in ("train", "dev"):
        out = os.path.join(pkl_dir, split)
        if not os.path.exists(os.path.join(out, "corpus.npz")):
            pack_corpus(out, _read_lines(hyper["data"][split], tok))
    return pkl_dir


def _max_len(config):
    return config["decoder"].get("kwargs", {}).get("max_len", 200)


def stage_train(expdir, hyper, config, tok, device="cpu"):
    from cat_tpu_torch.lm.train import LmLoader
    from cat_tpu_torch.utils.checkpoint import CheckpointManager
    from cat_tpu_torch.utils.data import CorpusDataset
    from cat_tpu_torch.utils.manager import Manager
    from cat_tpu_torch.utils.scheduler import build_scheduler

    task = _trainer(hyper)
    opts = hyper["train"].get("option", {})
    tr = CorpusDataset(os.path.join(expdir, "pkl", "train"))
    dv = CorpusDataset(os.path.join(expdir, "pkl", "dev"))
    model = task.build_model(config, num_classes=tok.vocab_size,
                             device=device)
    sched, opt = build_scheduler(config["scheduler"], model.parameters())
    state = task.init_state(model, opt)
    if _is_trf(hyper):
        pi = task.length_prior(tr, max_len=_max_len(config))
        trf_opts = task.loss_options(config)
        train_step = task.make_train_step(model, opt, pi, trf_opts)
        eval_step = task.make_eval_step(model, pi, trf_opts)
    else:
        train_step = task.make_train_step(model, opt)
        eval_step = task.make_eval_step(model)
    loader_kw = dict(token_budget=opts.get("token_budget", 8000),
                     num_buckets=opts.get("num_buckets", 4),
                     max_len=opts.get("max_len", 512))
    mgr = Manager(train_step, eval_step, state, sched,
                  CheckpointManager(os.path.join(expdir, "check")),
                  LmLoader(tr, seed=opts.get("seed", 0), **loader_kw),
                  LmLoader(dv, shuffle=False, **loader_kw),
                  max_epochs=opts.get("max_epochs", 100),
                  check_freq=opts.get("check_freq", -1),
                  batch_transform=lambda batch: batch)
    if opts.get("resume"):
        mgr.resume(opts["resume"])
    mgr.run()
    return mgr


def trf_scores(model, pi, id_sequences, batch_size=64):
    """Each sequence's TRF score φ + log π (float64 numpy), in batches on
    the model's device."""
    from cat_tpu_torch.lm.trf import trf_score

    dev = next(model.parameters()).device
    U = max(len(s) for s in id_sequences) + 2
    out = []
    for start in range(0, len(id_sequences), batch_size):
        chunk = id_sequences[start:start + batch_size]
        tokens = np.zeros((len(chunk), U), np.int64)
        targets = np.zeros((len(chunk), U), np.int64)
        for j, ids in enumerate(chunk):
            tokens[j, 1:len(ids) + 1] = ids
            targets[j, :len(ids)] = ids
        lens = torch.tensor([len(ids) + 1 for ids in chunk], device=dev)
        to = lambda a: torch.from_numpy(a).to(dev)
        with torch.inference_mode():
            out.append(trf_score(model, pi, to(tokens), to(targets),
                                 lens).double().cpu().numpy())
    return np.concatenate(out)


def stage_eval(expdir, hyper, config, tok, device="cpu"):
    """The best checkpoint's dev perplexity ({"ppl"}), or a TRF model's
    mean dev TRF score ({"trf_score_mean"}), written to ppl.json."""
    if _is_trf(hyper):
        from cat_tpu_torch.lm import train_trf
        from cat_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    model_weights)
        from cat_tpu_torch.utils.data import CorpusDataset

        model = train_trf.build_model(config, num_classes=tok.vocab_size,
                                      device=device)
        ckpt = CheckpointManager(os.path.join(expdir, "check"))
        model.load_state_dict(model_weights(model, ckpt.path(ckpt.best())))
        dv = CorpusDataset(os.path.join(expdir, "pkl", "dev"))
        pi = train_trf.length_prior(dv, max_len=_max_len(config))
        score = float(np.mean(trf_scores(
            model, pi, [list(dv[i]) for i in range(len(dv))])))
        with open(os.path.join(expdir, "ppl.json"), "w") as f:
            json.dump({"trf_score_mean": score}, f)
        print(f"dev mean TRF score: {score:.3f} (unnormalized; for "
              "rescoring)")
        return score
    from cat_tpu_torch.lm.train import load_exp, perplexity

    model, _ = load_exp(expdir, device)
    ppl = perplexity(model, _read_lines(hyper["data"]["dev"], tok))
    with open(os.path.join(expdir, "ppl.json"), "w") as f:
        json.dump({"ppl": ppl}, f)
    print(f"dev ppl: {ppl:.2f}")
    return ppl


def main(argv=None):
    p = argparse.ArgumentParser("cat_tpu_torch.pipeline.lm")
    p.add_argument("expdir")
    p.add_argument("--start_stage", type=int, default=1)
    p.add_argument("--stop_stage", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="device of training and evaluation (default cuda)")
    args = p.parse_args(argv)
    device = check_device(args.device)
    hyper = load_json(os.path.join(args.expdir, "hyper-p.json"))
    config = load_json(os.path.join(args.expdir, "config.json"))
    if config.get("perf"):
        print(f"config.perf {config['perf']} ignored: the port has no "
              "implementation switches")
    _trainer(hyper)
    tok = stage_tokenizer(args.expdir, hyper)
    print(f"[stage 1] tokenizer ready, vocab={tok.vocab_size}")
    if args.start_stage <= 2 <= args.stop_stage:
        stage_pack(args.expdir, hyper, tok)
        print("[stage 2] corpus packed")
    if args.start_stage <= 3 <= args.stop_stage:
        stage_train(args.expdir, hyper, config, tok, device)
        print("[stage 3] training done")
    if args.start_stage <= 4 <= args.stop_stage:
        stage_eval(args.expdir, hyper, config, tok, device)


if __name__ == "__main__":
    main()
