"""The 4-stage ASR experiment pipeline: tokenizer -> pack -> train ->
decode (counterpart of `cat_tpu/pipeline/asr.py`).

    python -m cat_tpu_torch.pipeline.asr <expdir> [--start_stage 1]
        [--stop_stage 4] [--device cuda|cpu]

reads the two JSON files of a recipe under `egs/` unchanged:

  expdir/
    hyper-p.json   {"data": {"train", "dev"}, "feature", "tokenizer",
                    "den_lm", "train": {"bin", "option"},
                    "inference": {"split", "avgmodel", "decode"}}
    config.json    {"trainer", "encoder", "predictor"/"joiner",
                    "specaug", "scheduler": {..., "optimizer"}}

and runs on the card unless `--device cpu` is given. A "bin" of either
package (`cat_tpu.ctc.train`, `cat_tpu.rnnt.train`, the CUSIDE
`*.train_unified`, the multichannel `ctc.train_me2e*`, JSA-SPG's
`ctc.train_jsa` and LLM-P2G's `p2g.train`) names the port's trainer
(`pipeline/tasks.py`); the ME2E bins' task adapter runs stages 2-4 (raw
multichannel waves packed, the beamforming front end trained with the
encoder, CTC decoding offline or streaming), the JSA adapter too
(grapheme labels and the supervised phonemes of `text_phone` packed, the
S2P, P2G and G2P models trained with MIS sampling, cascade decoding), and
the P2G adapter (`src`, `text` and `src_nbest` packed as token pairs and
candidate sets, the seq2seq model trained by CE or TKM, greedy or
marginalised decoding); an LM bin (`*.lm.train`, `*.lm.train_trf`) is
refused with a ValueError: its recipe runs through `pipeline/lm.py`.

  1 tokenizer: built from the first train set's transcripts, or loaded.
  2 pack: wav.scp + text -> fbank + CMVN on the device -> pkl/<split>
    (a data dir that is packed already is linked); dev only when the
    train set streams from shards (train.option.sharded_data).
  3 train: the `Manager` over `BucketedLoader`s (one card: batches of
    any size), or over a `StreamingBucketLoader` of npz shards
    (`utils/data_sharded.py`: sharded_data a shard dir, glob or brace
    pattern; shuffle_buffer, buckets, label_caps, frame_budget, seed),
    the recipe's scheduler and optimizer, `grad_accum_fold`, clipping,
    the dense CTC-CRF denominator estimated from the packed train labels
    or a label-only pass over the shards (cached as den_dense.npz),
    resume, the dev WER as the scheduler's metric when asked
    (`eval_wer`), and readme.md.
  4 decode: the chosen checkpoints averaged (best-N or last-N), CTC by
    the batched prefix beam on the device (`ctc/decode_device.py`),
    greedily, through a TLG graph (mode "wfst": the encoder on the card,
    the Viterbi search on the host in C++, `native/wfst_decoder.cpp`), or
    by the host prefix beam fused with decode.lm; RNN-T by
    `RNNTBeamDecoder`, fused with decode.lm when it is set. decode.lm is a
    token n-gram, a neural LM of a trained LM experiment ("nn", scored by
    `lm/scorer.py` on the decode device) or LODR (that LM plus a token
    n-gram of negative weight); decode.rescore rescores the n-best lists
    with a word n-gram or such a neural LM; nbest_<split>.pkl,
    decode_<split>.txt and wer_<split>.json with the real-time factor.
    A unified (CUSIDE) model in mode "streaming": the transducer's beam
    over its chunked encoding; a unified CTC model always decodes its
    chunk pass (`chunk_infer`, decode.future), greedily in mode "greedy"
    or "streaming" at beam <= 1. A model that is not unified decodes
    mode "streaming" offline, as the JAX package does.

Not ported yet, each raising NotImplementedError with its ROADMAP.md
section: the arc-table denominator for orders above 3, more than 128
units or an FST file (§A.6); the encoders `VGGLSTM`, `BLSTMN`,
`LSTMrowCONV`, `TDNN_LSTM` and `ConformerLSTM` (§A.6b);
`config.parallel` (§A.7); more than one train set and the
`Wav2Vec2Encoder` encoder (§A.8). The JAX
package's monitor plot after training waits for `utils/plot.py` (§A.8)
and is left out; `config.perf` is read and
ignored, since the port has no implementation switches: every op runs
its kernel on a CUDA tensor.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from cat_tpu_torch.ctc import decode_device
from cat_tpu_torch.pipeline import tasks
from cat_tpu_torch.utils.data_prep import check_device, wav_features


def _todo(what, section):
    return NotImplementedError(f"{what} is not ported to cat_tpu_torch yet; "
                               f"see ROADMAP.md {section}")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def read_scp(path):
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def build_tokenizer(expdir, hyper, key="tokenizer", corpus_file="text"):
    """Build or load the tokenizer of a hyper-p key; its default corpus is
    the `corpus_file` column of the first train set."""
    from cat_tpu_torch.utils import tokenizer as tknz

    cfg = hyper[key]
    tpath = os.path.join(expdir, cfg.get("file", key + ".tknz"))
    if os.path.exists(tpath):
        return tknz.load(tpath)
    opts = dict(cfg.get("option-init", {}))
    if "corpus" not in opts and cfg["type"] != "RawTokenizer":
        tr = _train_sets(hyper)[0][0]
        text = read_scp(os.path.join(tr, corpus_file))
        corpus_path = os.path.join(expdir, f"{key}_corpus.txt")
        with open(corpus_path, "w") as f:
            f.write("\n".join(text.values()))
        opts["corpus"] = corpus_path
    tok = tknz.initialize({"type": cfg["type"], "option-init": opts})
    tok.save(tpath)
    return tok


def load_tokenizers(expdir, hyper):
    """Every tokenizer the experiment declares (each hyper-p key that
    starts with "tokenizer"), each built from the column its task adapter
    names ("text" without one)."""
    task = tasks.get_task(hyper)
    return {key: build_tokenizer(expdir, hyper, key, "text" if task is None
                                 else task.tokenizer_corpus_file(key))
            for key in hyper if key.startswith("tokenizer")}


def extract_features(datadir, feat_cfg=None, device="cpu"):
    """wav.scp + text -> iterable of (uid, fbank feats, transcript), the
    features computed on `device`."""
    from cat_tpu_torch.utils.audio import read_wav

    num_bins = (feat_cfg or {}).get("num_mel_bins", 80)
    scp = read_scp(os.path.join(datadir, "wav.scp"))
    text = read_scp(os.path.join(datadir, "text"))
    for uid, wav_path in scp.items():
        wav, sr = read_wav(wav_path)
        yield uid, wav_features(wav, sr, num_bins, device), text.get(uid, "")


def _is_rnnt(hyper):
    return tasks.family(hyper["train"]["bin"]) == "rnnt"


def _train_sets(hyper):
    """hyper["data"]["train"]: one dir, a list of dirs, or a list of
    {"path": dir, "weight": w}."""
    tr = hyper["data"]["train"]
    if isinstance(tr, (str, os.PathLike)):
        return [(str(tr), 1.0)]
    return [(str(item["path"]), float(item.get("weight", 1.0)))
            if isinstance(item, dict) else (str(item), 1.0) for item in tr]


def _sharded(hyper):
    """The shard pattern of train.option.sharded_data (a dir means its
    shard-*.npz), or None when the train set is packed."""
    from cat_tpu_torch.utils.data_sharded import shard_pattern

    sharded = hyper["train"].get("option", {}).get("sharded_data")
    return shard_pattern(sharded) if sharded else None


def _check_data(hyper):
    """Raise for the train data stages 2 and 3 cannot take yet."""
    if len(_train_sets(hyper)) > 1:
        raise _todo("more than one train set (WeightedConcatDataset)",
                    "§A.8")


def _check_den_path(path):
    if str(path).lower().endswith(".fst"):
        raise _todo(f"the arc-table denominator of the FST {path!r}",
                    "§A.6")


def _check_lm(cfg, what, kinds=("ngram", "nn", "lodr")):
    """Raise for an LM config of an unknown type."""
    kind = (cfg or {}).get("type", "ngram")
    if kind not in kinds:
        raise ValueError(f"unknown {what} lm type {kind}")


def _asr_module(hyper):
    """The port's trainer module of the experiment's ASR bin; an LM bin
    raises ValueError (its recipe runs through `pipeline.lm`)."""
    name = hyper["train"]["bin"]
    if tasks.family(name) == "lm":
        raise ValueError(f"train bin {name!r} trains an LM: run its recipe "
                         "with python -m cat_tpu_torch.pipeline.lm")
    return tasks.train_module(name)


def _check_encoder(config):
    """Raise for an encoder type the port has not registered: the config's
    encoder (a JoinAP encoder's head included) or a JSA recipe's s2p, p2g
    and g2p (a P2G recipe's `p2g` block holds its model's kwargs, no
    type)."""
    from cat_tpu_torch import models

    for key in ("encoder", "s2p", "p2g", "g2p"):
        enc = config.get(key)
        if not enc or "type" not in enc:
            continue
        models.get_encoder(enc["type"])
        if enc["type"].startswith("JoinAP"):
            models.get_encoder(enc.get("kwargs", {}).get("enc_head_type",
                                                         "LSTM"))


def check_train(hyper, config):
    """Raise for what stage 3 of the port cannot do yet."""
    _asr_module(hyper)
    _check_data(hyper)
    _check_encoder(config)
    if config.get("parallel"):
        raise _todo("config.parallel (tensor parallelism)", "§A.7")
    if tasks.get_task(hyper) is not None:
        return  # the ME2E and JSA bins train CTC whatever trainer.loss says
    den_cfg = hyper.get("den_lm", {})
    _check_den_path(den_cfg.get("path", ""))
    if den_cfg.get("order", 3) > 3 and \
            config.get("trainer", {}).get("loss") == "crf":
        raise _todo("the arc-table denominator (order > 3)", "§A.6")


def check_decode(hyper, config=None):
    """Raise for what stage 4 of the port cannot do yet."""
    _asr_module(hyper)
    _check_encoder(config or {})
    dec = hyper.get("inference", {}).get("decode", {})
    if dec.get("lm"):
        _check_lm(dec["lm"], "decode-time LM fusion (decode.lm)")
    if dec.get("rescore"):
        _check_lm(dec["rescore"].get("lm"),
                  "n-best rescoring (decode.rescore)", ("ngram", "nn"))


def stage_pack(expdir, hyper, tok, device="cpu", extract=None):
    """pkl/<split> of dev and the train set (dev only when the train set
    streams from shards); a data dir packed already is linked.
    `extract(datadir)` yields (uid, features, transcript): by default
    fbank + CMVN on `device`."""
    from cat_tpu_torch.utils.data import pack_speech_data

    _check_data(hyper)
    pkl_dir = os.path.join(expdir, "pkl")
    feat_cfg = hyper.get("feature", {})
    extract = extract or (lambda d: extract_features(d, feat_cfg, device))
    splits = [("dev", hyper["data"]["dev"])]
    if _sharded(hyper) is None:  # shards are read as they are
        splits.append(("train", _train_sets(hyper)[0][0]))
    for split, datadir in splits:
        out = os.path.join(pkl_dir, split)
        if os.path.exists(os.path.join(out, "meta.npz")):
            continue
        if os.path.exists(os.path.join(datadir, "meta.npz")):
            os.makedirs(pkl_dir, exist_ok=True)  # packed already
            if not os.path.exists(out):
                os.symlink(os.path.abspath(datadir), out)
            continue
        pack_speech_data(out, extract(datadir), tok)
    return pkl_dir


def _with_feat_dim(config, feat_dim):
    """The config with the encoder's `idim` (the port's own argument; the
    JAX modules infer it) set to the data's feature width: a JoinAP
    encoder's head takes it."""
    config = copy.deepcopy(config)
    kw = config["encoder"].setdefault("kwargs", {})
    if config["encoder"]["type"].startswith("JoinAP"):
        kw = kw.setdefault("enc_head_kwargs", {})
    kw.setdefault("idim", int(feat_dim))
    return config


def stage_train(expdir, hyper, config, tok, device="cpu"):
    from cat_tpu_torch.utils.checkpoint import CheckpointManager
    from cat_tpu_torch.utils.data import BucketedLoader, SpeechDataset
    from cat_tpu_torch.utils.manager import Manager
    from cat_tpu_torch.utils.scheduler import build_scheduler

    check_train(hyper, config)
    task = _asr_module(hyper)
    opts = hyper["train"].get("option", {})
    pkl_dir = os.path.join(expdir, "pkl")
    pattern = _sharded(hyper)
    dv_ds = SpeechDataset(os.path.join(pkl_dir, "dev"))
    # streamed from shards: the feature width comes from dev
    tr_ds = (SpeechDataset(os.path.join(pkl_dir, "train")) if pattern is None
             else None)
    feat_dim = (dv_ds if tr_ds is None else tr_ds).feat_dim
    config = _with_feat_dim(config, feat_dim)

    model = task.build_model(config, num_classes=tok.vocab_size,
                             device=device)
    sched, opt = build_scheduler(config["scheduler"], model.parameters())
    trainer_cfg = config.get("trainer", {})
    loss_type = trainer_cfg.get("loss", "ctc")
    fold = int(trainer_cfg.get("grad_accum_fold",
                               opts.get("grad_accum_fold", 1)))
    grad_clip = float(trainer_cfg.get("grad_clip", 5.0))
    state = task.init_state(model, opt)
    den = (build_den(expdir, hyper, tok, tr_ds, shard_pattern=pattern)
           if loss_type == "crf" else None)
    specaug_cfg = config.get("specaug")

    loader_kw = dict(frame_budget=opts.get("frame_budget", 20000),
                     num_buckets=opts.get("num_buckets", 4))
    train_loader = (BucketedLoader(tr_ds, seed=opts.get("seed", 0),
                                   **loader_kw) if pattern is None
                    else shard_loader(hyper, feat_dim))
    eval_loader = BucketedLoader(dv_ds, shuffle=False, **loader_kw)

    if _is_rnnt(hyper):
        rnnt_kw = dict(topo=trainer_cfg.get("topo", "rnnt"),
                       eos_id=trainer_cfg.get("eos_id", -1),
                       joiner_normalized=config.get("joiner", {}).get(
                           "type") == "HAT")
        step_kw = {}
        if tasks.is_unified(hyper["train"]["bin"]):
            rnnt_kw.update(lamb_chunk=trainer_cfg.get("lamb_chunk", 0.5),
                           future=trainer_cfg.get("future", "simu"))
            step_kw["lamb_simu"] = trainer_cfg.get("lamb_simu", 1.0)
        train_step = task.make_train_step(
            model, opt, specaug_cfg=specaug_cfg, grad_clip=grad_clip,
            grad_accum_fold=fold, **rnnt_kw, **step_kw)
        eval_step = task.make_eval_step(model, **rnnt_kw)
    else:
        # the CTC bins, the unified one too, take no trainer.lamb_chunk,
        # future or lamb_simu here: JAX's stage 3 passes none of them
        lamb = trainer_cfg.get("lamb", 0.1)
        train_step = task.make_train_step(
            model, opt, loss_type, den=den, lamb=lamb,
            specaug_cfg=specaug_cfg, grad_clip=grad_clip,
            grad_accum_fold=fold)
        eval_step = task.make_eval_step(model, loss_type, den=den, lamb=lamb)

    mgr = Manager(train_step, eval_step, state, sched,
                  CheckpointManager(os.path.join(expdir, "check")),
                  train_loader, eval_loader,
                  max_epochs=opts.get("max_epochs", 100),
                  check_freq=opts.get("check_freq", -1),
                  grad_accum_fold=fold,
                  eval_metric=_make_eval_metric(hyper, model, tok, dv_ds,
                                                opts))
    _write_exp_readme(expdir, config, model, tok)
    if opts.get("resume"):
        mgr.resume(opts["resume"])
    mgr.run()
    return mgr


def shard_loader(hyper, feat_dim):
    """The train loader of a sharded train set: a `StreamingBucketLoader`
    over train.option.sharded_data with the options shuffle_buffer
    (1024), seed (0), frame_budget (20000), buckets (400, 800, 1200, 1700)
    and label_caps, on one card (multiple_of 1)."""
    from cat_tpu_torch.utils.data_sharded import (ShardedSpeechDataset,
                                                  StreamingBucketLoader)

    opts = hyper["train"].get("option", {})
    return StreamingBucketLoader(
        ShardedSpeechDataset(_sharded(hyper),
                             shuffle_buffer=opts.get("shuffle_buffer", 1024),
                             seed=opts.get("seed", 0)),
        frame_budget=opts.get("frame_budget", 20000),
        buckets=tuple(opts.get("buckets", (400, 800, 1200, 1700))),
        label_caps=opts.get("label_caps"), feat_dim=feat_dim)


def ctc_log_probs(model, feats, flens, future=None):
    """The CTC model's (N, T', V) f32 log-probs and output lengths in eval
    mode, on the model's device; feats and flens numpy. With `future` (a
    unified model), the chunk pass's (`chunk_infer`)."""
    from cat_tpu_torch.ctc.streaming import chunk_infer

    dev = next(model.parameters()).device
    x = torch.from_numpy(feats).to(dev)
    lens = torch.from_numpy(flens).long().to(dev)
    model.eval()
    with torch.inference_mode():
        if future is None:
            logits, olens = model(x, lens)
        else:
            logits, olens = chunk_infer(model, x, lens, future)
        return torch.log_softmax(logits.float(), -1), olens


def _beam_max_len(labels, extra):
    """The prefix capacity of the device beam: the batch's label width +
    `extra`, rounded up to a multiple of 32 (as the JAX package's callers
    round it to bound its recompiles); it is part of the result."""
    ml = int(labels.shape[1]) + extra
    return -(-ml // 32) * 32


def _make_eval_metric(hyper, model, tok, dv_ds, opts):
    """The dev WER as the scheduler's metric, when
    hyper["train"]["option"]["eval_wer"] is true or {"beam_width": N,
    "cer": bool}: CTC greedy, or the device beam at N > 1; RNN-T greedy.
    Returns a callable(state) -> WER %, or None."""
    cfg = opts.get("eval_wer")
    if not cfg:
        return None
    if not isinstance(cfg, dict):
        cfg = {}
    from cat_tpu_torch.utils.data import BucketedLoader
    from cat_tpu_torch.utils.wer import wer as wer_fn

    beam = int(cfg.get("beam_width", 1))
    char_level = bool(cfg.get("cer", False))
    loader = BucketedLoader(dv_ds, shuffle=False,
                            frame_budget=opts.get("frame_budget", 20000),
                            num_buckets=opts.get("num_buckets", 4))

    if _is_rnnt(hyper):
        from cat_tpu_torch.rnnt.decode import make_greedy_decoder
        greedy = make_greedy_decoder(model)

        def decode_batch(b):
            model.eval()
            toks, counts = greedy(b.feats, b.feat_lengths)
            toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
            return [list(toks[n, :counts[n]]) for n in range(len(toks))]
    else:
        from cat_tpu_torch.ctc.decode import greedy_decode

        def decode_batch(b):
            lp, olens = ctc_log_probs(model, b.feats, b.feat_lengths)
            if beam > 1:
                prefixes, plens, _ = decode_device.ctc_beam_search_device(
                    lp, olens, beam_width=beam,
                    max_len=_beam_max_len(b.labels, 8))
                prefixes, plens = prefixes.cpu().numpy(), plens.cpu().numpy()
                return [list(prefixes[n, 0, :plens[n, 0]])
                        for n in range(len(prefixes))]
            return greedy_decode(lp, olens)

    def eval_metric(state):
        refs, hyps = [], []
        for b in loader:
            dec = decode_batch(b)
            for n in range(len(dec)):
                if b.weight[n] <= 0:
                    continue
                refs.append(tok.decode(
                    [int(x) for x in b.labels[n, :b.label_lengths[n]]]))
                hyps.append(tok.decode([int(x) for x in dec[n]]))
        return wer_fn(refs, hyps, char_level=char_level)["wer"]

    return eval_metric


def _write_exp_readme(expdir, config, model, tok, loss=None):
    """readme.md of the experiment: parameters, vocabulary, loss (by
    default the config's trainer.loss), encoder, device and the config."""
    n_params = sum(p.numel() for p in model.parameters())
    dev = next(model.parameters()).device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lines = [
        f"# Experiment {os.path.basename(os.path.abspath(expdir))}",
        "",
        f"- parameters: {n_params / 1e6:.2f} M",
        f"- vocabulary: {tok.vocab_size}",
        f"- loss: {loss or config.get('trainer', {}).get('loss', 'ctc')}",
        f"- encoder: {config.get('encoder', {}).get('type')}",
        f"- devices: {name} x1",
        "",
        "## Settings",
        "```json",
        json.dumps(config, indent=1),
        "```",
    ]
    with open(os.path.join(expdir, "readme.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _den_from_path(path, tok):
    """An explicit denominator LM (hyper["den_lm"]["path"]): a unit n-gram
    .arpa of order <= 3 expanded into a `DenseDen`, or a `DenseDen` .npz.
    An FST file, an ARPA of a higher order and an arc-table (DenGraph)
    cache need the arc-table denominator (§A.6) and raise."""
    from cat_tpu_torch.ops.crf_dense import DenseDen

    _check_den_path(path)
    if str(path).lower().endswith(".arpa"):
        from cat_tpu_torch.fst.ngram import read_arpa

        with open(path) as f:
            lm = read_arpa(f, to_int=True)
        if lm.order > 3:
            raise _todo(f"the arc-table denominator of {path!r} (order "
                        f"{lm.order})", "§A.6")
        return DenseDen.from_ngram(lm, num_classes=tok.vocab_size)
    with np.load(path) as z:
        keys = set(z.files)
    if "logw" not in keys:
        raise _todo(f"the arc-table denominator of {path!r}", "§A.6")
    return DenseDen.load(path)


def _shard_label_seqs(pattern):
    """Each utterance's label ids, shard by shard in file order, reading
    only the label arrays of the shards."""
    from cat_tpu_torch.utils.data_sharded import expand_shards

    shards = expand_shards(pattern)
    if not shards:
        raise FileNotFoundError(pattern)
    for sh in shards:
        with np.load(sh) as z:
            labels, loffs = z["labels"], z["label_offsets"]
        for i in range(len(loffs) - 1):
            yield [int(x) for x in labels[loffs[i]:loffs[i + 1]]]


def build_den(expdir, hyper, tok, tr_ds, shard_pattern=None):
    """The CTC-CRF denominator LM: the cached expdir/den_dense.npz, else
    hyper["den_lm"]["path"], else an n-gram of hyper["den_lm"]["order"]
    (3) estimated from the packed train labels, or from a label-only pass
    over the shards of `shard_pattern` when the train set streams, and
    cached. The dense tables take orders up to 3 and up to 128 units; the
    arc-table denominator beyond them is not ported (§A.6)."""
    from cat_tpu_torch.fst.ngram import train_ngram
    from cat_tpu_torch.ops.crf_dense import DenseDen

    den_cfg = hyper.get("den_lm", {})
    order = den_cfg.get("order", 3)
    if order > 3 or tok.vocab_size > 128:
        raise _todo(f"the arc-table denominator (order {order}, "
                    f"{tok.vocab_size} units)", "§A.6")
    dense_path = os.path.join(expdir, "den_dense.npz")
    if os.path.exists(dense_path):
        return DenseDen.load(dense_path)
    if den_cfg.get("path"):
        return _den_from_path(den_cfg["path"], tok)
    if tr_ds is not None:
        seqs = [[int(x) for x in tr_ds[i][1]] for i in range(len(tr_ds))]
    elif shard_pattern is not None:
        seqs = list(_shard_label_seqs(shard_pattern))
    else:
        raise ValueError(
            "CTC-CRF needs a denominator LM: give hyper den_lm.path, a "
            "cached den_dense.npz under the expdir, or a packed or sharded "
            "train set to estimate one from")
    lm = train_ngram(seqs, order=order)
    den = DenseDen.from_ngram(lm, num_classes=tok.vocab_size)
    den.save(dense_path)
    return den


def _load_decode_state(expdir, hyper, model):
    """The state_dict to decode with: the best checkpoint, or the average
    of the best N (avgmodel "best") or the last N ("last"), of either
    package's checkpoints."""
    from cat_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                average_checkpoints,
                                                model_weights)

    ckpt = CheckpointManager(os.path.join(expdir, "check"))
    avg = hyper.get("inference", {}).get("avgmodel", {})
    avail = [e for e in ckpt.entries if os.path.exists(ckpt.path(e[0]))]
    if not avail:
        raise FileNotFoundError(f"no checkpoints under {ckpt.dir}")
    num = int(avg.get("num", 0))
    if num > 1:
        if avg.get("mode", "best") == "last":
            chosen = sorted(avail, key=lambda e: e[2])[-num:]
        else:
            chosen = sorted(avail, key=lambda e: e[1])[:num]
        paths = [ckpt.path(e[0]) for e in chosen]
        if len(paths) > 1:
            return average_checkpoints(paths, model)
    best = min(avail, key=lambda e: e[1])[0]
    return model_weights(model, ckpt.path(best))


def _train_text(hyper):
    """The transcripts of the first train set, {uid: text}."""
    return read_scp(os.path.join(_train_sets(hyper)[0][0], "text"))


def _build_wfst_decoder(expdir, hyper, tok, dec_cfg):
    """The TLG decoder of decode mode "wfst": G a word n-gram of
    decode.wfst.order (2) over the train transcripts, L each word's
    tokenizer units (unit ids double as phone symbols, mapped onto the AM
    outputs as they are), T the CTC topology. The graph is cached as
    expdir/tlg.npz with its words, one a line (id = line + 1), in
    tlg_words.txt: the JAX package's files, either package reads the
    other's. Returns (decoder, {word id: word})."""
    from cat_tpu_torch.fst.decode import WfstDecoder, build_tlg
    from cat_tpu_torch.fst.fst import Fst
    from cat_tpu_torch.fst.ngram import train_ngram

    wf = dec_cfg.get("wfst", {})
    tlg_path = os.path.join(expdir, "tlg.npz")
    word_list_path = os.path.join(expdir, "tlg_words.txt")
    if os.path.exists(tlg_path) and os.path.exists(word_list_path):
        tlg = Fst.load(tlg_path)
        with open(word_list_path) as f:
            words = [w.rstrip("\n") for w in f]
    else:
        sents = [t.split() for t in _train_text(hyper).values()]
        words = sorted({w for s in sents for w in s})
        word2id = {w: i + 1 for i, w in enumerate(words)}
        wlm = train_ngram(sents, order=wf.get("order", 2))
        lexicon = [(w, [int(t) for t in tok.encode(w)]) for w in words]
        phone2id = {i: i for i in range(1, tok.vocab_size)}
        tlg = build_tlg(lexicon, wlm, phone2id=phone2id, word2id=word2id,
                        num_classes=tok.vocab_size)
        tlg.save(tlg_path)
        with open(word_list_path, "w") as f:
            f.write("\n".join(words) + "\n")
    id2word = {i + 1: w for i, w in enumerate(words)}
    dec = WfstDecoder(tlg, beam=wf.get("beam", 17.0),
                      max_active=wf.get("max_active", 7000),
                      acoustic_scale=wf.get("acoustic_scale", 1.0),
                      lm_scale=wf.get("lm_scale", 1.0))
    return dec, id2word


def _build_decode_lm(hyper, tok, dec_cfg, device="cpu"):
    """The LM of shallow fusion at decode, decode.lm, with log10 scores:
      {"type": "ngram", "order": N (3)}: a token n-gram over the train
        transcripts tokenized with the AM's tokenizer;
      {"type": "nn", "exp": DIR}: the neural LM of a trained LM experiment
        (sharing the AM's token ids) on `device` (`NeuralLMScorer`);
      {"type": "lodr", "nn": {"exp": DIR}, "order": N (2), "ngram_weight":
        w (-0.3)}: that LM plus the token n-gram weighted by w
        (`CombinedLM`).
    None when decode.lm is not set."""
    cfg = dec_cfg.get("lm")
    if not cfg:
        return None
    _check_lm(cfg, "decode-time LM fusion (decode.lm)")
    from cat_tpu_torch.fst.ngram import train_ngram
    from cat_tpu_torch.lm.scorer import NeuralLMScorer
    from cat_tpu_torch.lm.train import load_exp
    from cat_tpu_torch.rnnt.decode import CombinedLM

    def token_ngram(order):
        seqs = [[int(t) for t in tok.encode(s)]
                for s in _train_text(hyper).values()]
        return train_ngram(seqs, order=order)

    kind = cfg.get("type", "ngram")
    if kind == "ngram":
        return token_ngram(cfg.get("order", 3))
    if kind == "nn":
        return NeuralLMScorer(load_exp(cfg["exp"], device)[0])
    nn = NeuralLMScorer(load_exp(cfg["nn"]["exp"], device)[0])
    return CombinedLM([(nn, 1.0),
                       (token_ngram(cfg.get("order", 2)),
                        float(cfg.get("ngram_weight", -0.3)))])


def _maybe_rescore(hyper, nbest, dec_cfg, device="cpu"):
    """n-best rescoring, decode.rescore = {"alpha", "beta", "lm": {"type":
    "ngram", "order": N} | {"type": "nn", "exp": DIR}}: score = am + α·lm
    + β·len with a word n-gram over the train transcripts (the n-best
    hypotheses are text), or with the neural LM of a trained LM
    experiment on `device` (the hypotheses encoded by its tokenizer).
    Returns {uid: rescored 1-best text}, or None when decode.rescore is
    not set."""
    rs = dec_cfg.get("rescore")
    if not rs:
        return None
    from cat_tpu_torch.lm.rescore import neural_nll, ngram_nll, rescore_nbest

    lm_cfg = rs.get("lm", {"type": "ngram", "order": 3})
    _check_lm(lm_cfg, "n-best rescoring (decode.rescore)", ("ngram", "nn"))
    if lm_cfg.get("type", "ngram") == "ngram":
        from cat_tpu_torch.fst.ngram import train_ngram

        lm = train_ngram([s.split() for s in _train_text(hyper).values()],
                         order=lm_cfg.get("order", 3))
        lm_nll = ngram_nll(lm, nbest)
    else:
        from cat_tpu_torch.lm.train import load_exp

        lm, lm_tok = load_exp(lm_cfg["exp"], device)
        lm_nll = neural_nll(lm, nbest, lm_tok)
    scored = rescore_nbest(nbest, lm_nll, alpha=rs.get("alpha", 1.0),
                           beta=rs.get("beta", 0.0))
    return {uid: hyp for uid, (score, hyp) in scored.items()}


def _wfst_search(wfst_dec, id2word, lp, olens, weight, nbest_n, native):
    """Each utterance of a batch through the TLG decoder on the host:
    `wfst_viterbi` at n-best 1, `wfst_nbest` above, the Python search
    when decode.native is false; utterances of weight 0 are skipped.
    Returns per utterance [(score, [word])]."""
    lp_np, ol_np = lp.float().cpu().numpy(), olens.cpu().numpy()
    per_utt = []
    for n in range(lp_np.shape[0]):
        if weight[n] <= 0:
            per_utt.append([(0.0, [])])
            continue
        if native and nbest_n == 1:
            hyp = [wfst_dec.decode_native(lp_np[n], ol_np[n])]
        elif native:
            hyp = wfst_dec.decode_native_nbest(lp_np[n], ol_np[n],
                                               nbest=nbest_n)
        else:
            hyp = wfst_dec.decode(lp_np[n], ol_np[n], nbest=nbest_n)
        per_utt.append([(s, [id2word[i] for i in wids if i in id2word])
                        for s, wids in hyp])
    return per_utt


def _fused_search(lp, olens, weight, lm, dec_cfg, beam, nbest_n):
    """Each utterance of a batch through the host prefix beam fused with
    `lm` (decode.alpha 0.3, decode.beta 0); utterances of weight 0 are
    skipped. Returns per utterance [(score, [token])]."""
    from cat_tpu_torch.ctc.decode import prefix_beam_search

    lp_np, ol_np = lp.float().cpu().numpy(), olens.cpu().numpy()
    per_utt = []
    for n in range(lp_np.shape[0]):
        if weight[n] <= 0:
            per_utt.append([(0.0, [])])
            continue
        nb = prefix_beam_search(
            lp_np[n], int(ol_np[n]), beam_width=beam, lm=lm,
            alpha=float(dec_cfg.get("alpha", 0.3)),
            beta=float(dec_cfg.get("beta", 0.0)), nbest=nbest_n)
        per_utt.append([(s, list(pre)) for s, pre in nb])
    return per_utt


def stage_decode(expdir, hyper, config, tok, device="cpu"):
    """Stage 4: decode the inference split batch by batch, write the
    n-best lists, the 1-best hypotheses (rescored when decode.rescore is
    set) and the WER with the real-time factor. decode "mode": "beam"
    (default; CTC: the batched prefix beam on the device, or the host
    prefix beam fused with decode.lm when it is set), "greedy" or "wfst"
    (the TLG graph; decode.native false takes the Python search); RNN-T
    takes `RNNTBeamDecoder`, with decode.lm, whatever the mode, as in
    JAX. "streaming": a unified transducer's beam over `encode_streaming`;
    a unified CTC model decodes its chunk pass in every mode, greedily
    at beam <= 1 in this one."""
    from cat_tpu_torch.utils.data import BucketedLoader, SpeechDataset

    check_decode(hyper, config)
    task = _asr_module(hyper)
    inf = hyper.get("inference", {})
    test_split = inf.get("split", "dev")
    ds = SpeechDataset(os.path.join(expdir, "pkl", test_split))
    model = task.build_model(_with_feat_dim(config, ds.feat_dim),
                             num_classes=tok.vocab_size, device=device)
    model.load_state_dict(_load_decode_state(expdir, hyper, model))
    model.eval()
    dec_cfg = inf.get("decode", {})
    mode = dec_cfg.get("mode", "beam")
    beam = dec_cfg.get("beam_width", 16)
    nbest_n = int(dec_cfg.get("nbest", min(beam, 8)))
    loader = BucketedLoader(ds, shuffle=False,
                            frame_budget=dec_cfg.get("frame_budget", 20000),
                            num_buckets=dec_cfg.get("num_buckets", 4))
    wfst_dec = id2word = None
    native = bool(dec_cfg.get("native", True))
    if mode == "wfst":
        wfst_dec, id2word = _build_wfst_decoder(expdir, hyper, tok, dec_cfg)
        if native:
            from cat_tpu_torch.native import wfst_lib
            wfst_lib()  # a failed build raises here, before any decoding
    fusion_lm = _build_decode_lm(hyper, tok, dec_cfg, device)
    unified = tasks.is_unified(hyper["train"]["bin"])
    if _is_rnnt(hyper):
        from cat_tpu_torch.rnnt.decode import RNNTBeamDecoder
        decoder = RNNTBeamDecoder(model, beam_width=beam, lm=fusion_lm,
                                  alpha=dec_cfg.get("alpha", 0.0),
                                  beta=dec_cfg.get("beta", 0.0),
                                  ilm_weight=dec_cfg.get("ilm_weight", 0.0),
                                  streaming=mode == "streaming" and unified)
    future = dec_cfg.get("future", "simu") if unified else None
    from cat_tpu_torch.ctc.decode import greedy_decode

    hyps, refs, all_nbest = {}, {}, {}
    audio_s = 0.0
    t0 = time.time()
    for b in loader:
        if _is_rnnt(hyper):
            res = decoder.decode(b.feats, b.feat_lengths, nbest=nbest_n)
            per_utt = [[(s, list(p)) for s, p in r] for r in res]
        else:
            lp, olens = ctc_log_probs(model, b.feats, b.feat_lengths, future)
            if mode == "greedy" or (mode == "streaming" and beam <= 1):
                per_utt = [[(0.0, seq)] for seq in greedy_decode(lp, olens)]
            elif mode == "wfst":
                per_utt = _wfst_search(wfst_dec, id2word, lp, olens,
                                       b.weight, nbest_n, native)
            elif fusion_lm is not None:
                per_utt = _fused_search(lp, olens, b.weight, fusion_lm,
                                        dec_cfg, beam, nbest_n)
            else:
                prefixes, plens, scores = \
                    decode_device.ctc_beam_search_device(
                        lp, olens, beam_width=beam,
                        max_len=_beam_max_len(b.labels, 16),
                        beta=float(dec_cfg.get("beta", 0.0)))
                prefixes, plens = prefixes.cpu().numpy(), plens.cpu().numpy()
                scores = scores.cpu().numpy()
                per_utt = [[(float(scores[n, k]),
                             list(prefixes[n, k, :plens[n, k]]))
                            for k in range(min(nbest_n, prefixes.shape[1]))]
                           for n in range(prefixes.shape[0])]
        for n in range(len(per_utt)):
            if b.weight[n] <= 0:
                continue
            uid = b.uids[n]
            audio_s += float(b.feat_lengths[n]) * 0.01
            entry = {k: (float(score), " ".join(toks)
                         if toks and isinstance(toks[0], str)
                         else tok.decode([int(t) for t in toks]))
                     for k, (score, toks) in enumerate(per_utt[n])}
            all_nbest[uid] = entry
            hyps[uid] = entry[0][1]
            refs[uid] = tok.decode(
                [int(x) for x in b.labels[n, :b.label_lengths[n]]])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    rescored = _maybe_rescore(hyper, all_nbest, dec_cfg, device)
    if rescored is not None:
        hyps = rescored
    return finalize_decode(expdir, test_split, refs, hyps, all_nbest, wall,
                           audio_s, mode, dec_cfg)


def finalize_decode(expdir, split, refs, hyps, all_nbest, wall, audio_s,
                    mode, dec_cfg, extra=None):
    """The n-best pickle, the hypotheses, the WER and the RTF (and the
    numbers of `extra`, written beside them)."""
    from cat_tpu_torch.utils.nbest import write_nbest
    from cat_tpu_torch.utils.wer import wer

    res = wer(refs, hyps, char_level=dec_cfg.get("cer", False))
    res["rtf"] = wall / max(audio_s, 1e-6) if audio_s > 0 else 0.0
    res["mode"] = mode
    res.update(extra or {})
    write_nbest(all_nbest, os.path.join(expdir, f"nbest_{split}.pkl"))
    with open(os.path.join(expdir, f"decode_{split}.txt"), "w") as f:
        for uid in sorted(hyps):
            f.write(f"{uid}\t{hyps[uid]}\n")
    with open(os.path.join(expdir, f"wer_{split}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"WER {res['wer']:.2f}% "
          f"(sub {res['sub']} ins {res['ins']} del {res['del']}) "
          f"RTF {res['rtf']:.4f} [{mode}]")
    return res


def main(argv=None):
    p = argparse.ArgumentParser("cat_tpu_torch.pipeline.asr")
    p.add_argument("expdir")
    p.add_argument("--start_stage", type=int, default=1)
    p.add_argument("--stop_stage", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="device of the features, training and decoding "
                        "(default cuda)")
    args = p.parse_args(argv)
    device = check_device(args.device)
    hyper = load_json(os.path.join(args.expdir, "hyper-p.json"))
    config = load_json(os.path.join(args.expdir, "config.json"))
    if config.get("perf"):
        print(f"config.perf {config['perf']} ignored: the port has no "
              "implementation switches")
    if args.start_stage <= 3 <= args.stop_stage:
        check_train(hyper, config)
    if args.start_stage <= 4 <= args.stop_stage:
        check_decode(hyper, config)

    # a task adapter (the ME2E bins) owns stages 2-4, as in JAX
    task = tasks.get_task(hyper)
    toks = load_tokenizers(args.expdir, hyper)
    tok = toks.get("tokenizer")
    print("[stage 1] tokenizer(s) ready: "
          + ", ".join(f"{k}={v.vocab_size}" for k, v in toks.items()))
    if args.stop_stage < 2:
        return
    if args.start_stage <= 2:
        if task is not None:
            task.pack(args.expdir, hyper, toks, device)
        else:
            stage_pack(args.expdir, hyper, tok, device)
        print("[stage 2] data packed")
    if args.start_stage <= 3 <= args.stop_stage:
        if task is not None:
            task.train(args.expdir, hyper, config, toks, device)
        else:
            stage_train(args.expdir, hyper, config, tok, device)
        print("[stage 3] training done")
    if args.start_stage <= 4 <= args.stop_stage:
        if task is not None:
            task.decode(args.expdir, hyper, config, toks, device)
        else:
            stage_decode(args.expdir, hyper, config, tok, device)
        print("[stage 4] decode done")


if __name__ == "__main__":
    main()
