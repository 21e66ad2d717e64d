"""Train bins and task adapters (counterpart of `get_task` in
`cat_tpu/pipeline/tasks.py`).

A recipe's `hyper-p.json` names its trainer by a "bin", a module of
either package ("cat_tpu.ctc.train" or "cat_tpu_torch.ctc.train"). This
module holds the one map from a bin to the port's trainer module, read by
both pipelines (`pipeline/asr.py`, `pipeline/lm.py`, which takes the
`lm.*` bins) and by both decode CLIs. Every bin of the JAX package is
ported (`NOT_PORTED` is empty; a bin listed there would raise
NotImplementedError naming its ROADMAP.md section). The ME2E, JSA and
P2G bins run through task adapters, which own stages 2-4 of their
recipes; the plain ASR bins have none (`get_task` returns None), as in
JAX.

An ME2E adapter (`Me2eTask` and its chunk and kaldi variants) packs raw
multichannel waves (L, C), time-major, a mono source replicated over
feature.channels; trains the bin's model through the `Manager` on
`BucketedLoader`s whose frame budget counts samples (train.option
frame_budget, 640,000 by default) and whose feasibility divisor is the
front end's hop times the encoder's subsampling, 4; and decodes the
inference split offline, or by the chunk pass in decode mode
"streaming", at decode.beam_width (8), with the prefix capacity the
batch's label width + 16, as the JAX adapter does.

The JSA adapter (`JsaTask`) packs the features with grapheme labels
(tokenizer_grapheme) and, where a data dir has `text_phone`, its phoneme
ids (tokenizer) as pkl/<split>/phones.json, the supervised z; trains the
three models through the `Manager` on `BucketedLoader`s at train.option
frame_budget (20,000) and num_buckets (4), with num_samples (4),
sample_beam (8) and trainer.upsample (2); and decodes the inference split
one utterance at a time by the S2P -> P2G cascade at decode.beam_width
(8) and num_z (4), marginalised unless decode.marginalize is false.

The P2G adapter (`P2gTask`) packs a data dir's `src` (phonemes, by
tokenizer), `text` (graphemes, by tokenizer_grapheme) and optional
`src_nbest` (uid, score, phonemes; the candidate sets) as pkl/<split>/
seq2seq.npz; trains `P2GSeq2Seq` through the `Manager` on
`Seq2SeqLoader`s at train.option frame_budget (2048) and num_buckets (4)
in mode "ce" (label_smoothing) or "tkm"/"skm" (K = tkm.k, t_weight), the
dev loss in "ce" unless dev has candidates; and decodes the inference
split greedily to decode.max_len (64), or, with decode.marginalize and
candidates, by one greedy hypothesis a candidate rescored by the
marginalised likelihood at tkm.temperature (else decode.t_weight).
"""
from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np

ME2E_BINS = ("ctc.train_me2e", "ctc.train_me2e_chunk", "ctc.train_me2e_kaldi",
             "ctc.train_me2e_kaldi_chunk")
PORTED = ("ctc.train", "rnnt.train", "ctc.train_unified",
          "rnnt.train_unified", "lm.train", "lm.train_trf",
          "ctc.train_jsa", "p2g.train") + ME2E_BINS
# bins of the JAX package that the port does not have yet, with the
# ROADMAP.md section that ports them
NOT_PORTED = {}


def bin_key(name: str) -> str:
    """The bin without its package: "cat_tpu.ctc.train" -> "ctc.train"."""
    for pre in ("cat_tpu_torch.", "cat_tpu."):
        if name.startswith(pre):
            return name[len(pre):]
    return name


def family(name: str) -> str:
    """"ctc", "rnnt", "lm" or "p2g": the bin's family (JAX tells the
    transducer bins by the prefix `cat_tpu.rnnt.`)."""
    return bin_key(name).split(".")[0]


def is_unified(name: str) -> bool:
    """A CUSIDE unified trainer's bin (`*.train_unified`)."""
    return bin_key(name).endswith("train_unified")


def _not_ported(name):
    sec = NOT_PORTED.get(bin_key(name))
    where = f"ROADMAP.md {sec}" if sec else "ROADMAP.md"
    return NotImplementedError(f"train bin {name!r} is not ported to "
                               f"cat_tpu_torch yet; see {where}")


def train_module(name: str, want_family: str | None = None):
    """The port's trainer module for the bin `name` of either package.
    want_family ("ctc", "rnnt" or "lm"): the caller takes only that
    family's bins."""
    key = bin_key(name)
    if key not in PORTED:
        raise _not_ported(name)
    if want_family is not None and family(name) != want_family:
        raise ValueError(f"train bin {name!r} is not a {want_family} "
                         "trainer")
    return importlib.import_module("cat_tpu_torch." + key)


def get_task(hyper):
    """The task adapter of the experiment's bin: an ME2E adapter for the
    four ME2E bins, the JSA adapter for ctc.train_jsa, the P2G adapter for
    p2g.train, None for the plain ASR bins, as in JAX."""
    key = bin_key(hyper.get("train", {}).get("bin", ""))
    if key in ME2E_BINS:
        return Me2eTask(key)
    if key == "ctc.train_jsa":
        return JsaTask()
    if key == "p2g.train":
        return P2gTask()
    return None


def _loader_kw(opts, hop):
    """BucketedLoader options of an ME2E split: a frame budget in samples,
    the feasibility filter on output frames (hop · 4 samples a frame)."""
    return dict(frame_budget=opts.get("frame_budget", 640000),
                num_buckets=opts.get("num_buckets", 4),
                feasibility_divisor=hop * 4)


class Me2eTask:
    """Stages 2-4 of an ME2E recipe (counterpart of `Me2eTask`,
    `Me2eChunkTask`, `Me2eKaldiTask` and `Me2eKaldiChunkTask` of
    `cat_tpu/pipeline/tasks.py`); `key` is the bin without its package."""

    def __init__(self, key):
        self.key = key
        self.chunk = key.endswith("_chunk")

    def tokenizer_corpus_file(self, key):
        return "text"

    def module(self):
        return importlib.import_module("cat_tpu_torch." + self.key)

    def pack(self, expdir, hyper, toks, device=None):
        """Stage 2 with raw waves (L, C) for features; `device` is unused:
        nothing is computed."""
        import numpy as np

        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.audio import read_wav

        channels = int(hyper.get("feature", {}).get("channels", 1))

        def waves(datadir):
            scp = asr.read_scp(os.path.join(datadir, "wav.scp"))
            text = asr.read_scp(os.path.join(datadir, "text"))
            for uid, path in scp.items():
                wave, _ = read_wav(path, mono=False)
                if wave.ndim == 1:  # a mono source: replicated
                    wave = np.tile(wave[:, None], (1, channels))
                yield uid, wave.astype(np.float32), text.get(uid, "")

        return asr.stage_pack(expdir, hyper, toks["tokenizer"],
                              extract=waves)

    def _extra(self, config):
        """The chunk bins' trainer.lamb_chunk (0.5), lamb_simu (1.0) and
        future ("simu")."""
        if not self.chunk:
            return {}
        tr = config.get("trainer", {})
        return dict(lamb_chunk=tr.get("lamb_chunk", 0.5),
                    lamb_simu=tr.get("lamb_simu", 1.0),
                    future=tr.get("future", "simu"))

    def train(self, expdir, hyper, config, toks, device="cpu"):
        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.checkpoint import CheckpointManager
        from cat_tpu_torch.utils.data import BucketedLoader, SpeechDataset
        from cat_tpu_torch.utils.manager import Manager
        from cat_tpu_torch.utils.scheduler import build_scheduler

        asr.check_train(hyper, config)
        task = self.module()
        tok = toks["tokenizer"]
        opts = hyper["train"].get("option", {})
        model = task.build_model(config, num_classes=tok.vocab_size,
                                 device=device)
        kw = _loader_kw(opts, model.frontend.frame_shift)
        pkl = os.path.join(expdir, "pkl")
        tr = SpeechDataset(os.path.join(pkl, "train"))
        dv = SpeechDataset(os.path.join(pkl, "dev"))
        sched, opt = build_scheduler(config["scheduler"], model.parameters())
        extra = self._extra(config)
        train_step = task.make_train_step(
            model, opt, grad_clip=config.get("trainer", {}).get(
                "grad_clip", 5.0), channels_last=True, **extra)
        extra.pop("lamb_simu", None)
        eval_step = task.make_eval_step(model, channels_last=True, **extra)
        mgr = Manager(train_step, eval_step, task.init_state(model, opt),
                      sched, CheckpointManager(os.path.join(expdir, "check")),
                      BucketedLoader(tr, seed=opts.get("seed", 0), **kw),
                      BucketedLoader(dv, shuffle=False, **kw),
                      max_epochs=opts.get("max_epochs", 100),
                      check_freq=opts.get("check_freq", -1))
        asr._write_exp_readme(expdir, config, model, tok)
        if opts.get("resume"):
            mgr.resume(opts["resume"])
        mgr.run()
        return mgr

    def decode(self, expdir, hyper, config, toks, device="cpu"):
        from cat_tpu_torch.ctc.decode_me2e import make_me2e_decoder
        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.data import BucketedLoader, SpeechDataset

        import torch

        asr.check_decode(hyper, config)
        tok = toks["tokenizer"]
        inf = hyper.get("inference", {})
        dec_cfg = inf.get("decode", {})
        split = inf.get("split", "dev")
        model = self.module().build_model(config, num_classes=tok.vocab_size,
                                          device=device)
        model.load_state_dict(asr._load_decode_state(expdir, hyper, model))
        model.eval()
        ds = SpeechDataset(os.path.join(expdir, "pkl", split))
        loader = BucketedLoader(ds, shuffle=False, **_loader_kw(
            dec_cfg, model.frontend.frame_shift))
        mode = dec_cfg.get("mode", "offline")
        dec = make_me2e_decoder(
            model, "streaming" if mode == "streaming" else "offline",
            beam_width=dec_cfg.get("beam_width", 8),
            future=dec_cfg.get("future", "simu"),
            beta=float(dec_cfg.get("beta", 0.0)), channels_last=True)
        sr = float(hyper.get("feature", {}).get("sample_rate", 16000))
        nbest_n = int(dec_cfg.get("nbest", 1))
        refs, hyps, all_nbest = {}, {}, {}
        audio_s = 0.0
        t0 = time.time()
        for b in loader:
            res = dec(b.feats, b.feat_lengths, nbest=nbest_n,
                      max_len=int(b.labels.shape[1]) + 16)
            for n in range(len(res)):
                if b.weight[n] <= 0:
                    continue
                uid = b.uids[n]
                audio_s += float(b.feat_lengths[n]) / sr
                entry = {k: (float(s), tok.decode([int(t) for t in seq]))
                         for k, (s, seq) in enumerate(res[n])}
                all_nbest[uid] = entry
                hyps[uid] = entry[0][1]
                refs[uid] = tok.decode(
                    [int(x) for x in b.labels[n, :b.label_lengths[n]]])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return asr.finalize_decode(expdir, split, refs, hyps, all_nbest,
                                   time.time() - t0, audio_s, mode, dec_cfg)


class JsaTask:
    """Stages 2-4 of a JSA-SPG recipe (counterpart of `JsaTask` of
    `cat_tpu/pipeline/tasks.py`): dual phoneme and grapheme tokenizers,
    MIS sampling in the train step, cascade or marginalised decoding."""

    key = "ctc.train_jsa"

    def tokenizer_corpus_file(self, key):
        return "text"

    def module(self):
        return importlib.import_module("cat_tpu_torch." + self.key)

    def pack(self, expdir, hyper, toks, device="cpu"):
        """Features on `device` with grapheme labels; a data dir's
        `text_phone` -> pkl/<split>/phones.json, the supervised phoneme
        ids."""
        from cat_tpu_torch.pipeline import asr

        pkl_dir = asr.stage_pack(expdir, hyper, toks["tokenizer_grapheme"],
                                 device)
        tok_p = toks["tokenizer"]
        for split, datadir in (("dev", hyper["data"]["dev"]),
                               ("train", asr._train_sets(hyper)[0][0])):
            phone_file = os.path.join(datadir, "text_phone")
            sup_path = os.path.join(pkl_dir, split, "phones.json")
            if os.path.exists(phone_file) and not os.path.exists(sup_path):
                sup = {uid: [int(x) for x in tok_p.encode(t)]
                       for uid, t in asr.read_scp(phone_file).items()}
                with open(sup_path, "w") as f:
                    json.dump(sup, f)
        return pkl_dir

    def build(self, config, toks, feat_dim, device):
        """The `JsaModel` of the config for the experiment's vocabularies."""
        return self.module().build_model(
            config, toks["tokenizer"].vocab_size,
            toks["tokenizer_grapheme"].vocab_size, feat_dim=feat_dim,
            device=device)

    def train(self, expdir, hyper, config, toks, device="cpu"):
        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.checkpoint import CheckpointManager
        from cat_tpu_torch.utils.data import BucketedLoader, SpeechDataset
        from cat_tpu_torch.utils.manager import Manager
        from cat_tpu_torch.utils.scheduler import build_scheduler

        asr.check_train(hyper, config)
        task = self.module()
        opts = hyper["train"].get("option", {})
        pkl = os.path.join(expdir, "pkl")
        tr = SpeechDataset(os.path.join(pkl, "train"))
        dv = SpeechDataset(os.path.join(pkl, "dev"))
        kw = dict(frame_budget=opts.get("frame_budget", 20000),
                  num_buckets=opts.get("num_buckets", 4))
        model = self.build(config, toks, tr.feat_dim, device)
        sched, opt = build_scheduler(config["scheduler"], model.parameters())
        trainer = task.JsaTrainer(
            model, opt, toks["tokenizer"].vocab_size,
            toks["tokenizer_grapheme"].vocab_size,
            num_samples=opts.get("num_samples", 4),
            beam_width=opts.get("sample_beam", 8),
            upsample=config.get("trainer", {}).get("upsample", 2))
        supervised_z = None
        sup_path = os.path.join(pkl, "train", "phones.json")
        if os.path.exists(sup_path):
            with open(sup_path) as f:
                supervised_z = json.load(f)
        state, train_step, eval_step = task.manager_steps(trainer,
                                                          supervised_z)
        same = lambda b: b  # the sampler reads the Batch's uids
        mgr = Manager(train_step, eval_step, state, sched,
                      CheckpointManager(os.path.join(expdir, "check")),
                      BucketedLoader(tr, seed=opts.get("seed", 0), **kw),
                      BucketedLoader(dv, shuffle=False, **kw),
                      max_epochs=opts.get("max_epochs", 100),
                      check_freq=opts.get("check_freq", -1),
                      put_batch=same, batch_transform=same)
        asr._write_exp_readme(expdir, config, model,
                              toks["tokenizer_grapheme"])
        if opts.get("resume"):
            mgr.resume(opts["resume"])
        mgr.run()
        return mgr

    def decode(self, expdir, hyper, config, toks, device="cpu"):
        from cat_tpu_torch.ctc.decode_jsa import JsaCascadeDecoder
        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.data import SpeechDataset

        asr.check_decode(hyper, config)
        tok_g = toks["tokenizer_grapheme"]
        inf = hyper.get("inference", {})
        dec_cfg = inf.get("decode", {})
        split = inf.get("split", "dev")
        ds = SpeechDataset(os.path.join(expdir, "pkl", split))
        model = self.build(config, toks, ds.feat_dim, device)
        model.load_state_dict(asr._load_decode_state(expdir, hyper, model))
        model.eval()
        beam = dec_cfg.get("beam_width", 8)
        dec = JsaCascadeDecoder(
            model.s2p, model.p2g,
            upsample=config.get("trainer", {}).get("upsample", 2),
            s2p_beam=beam, p2g_beam=beam, num_z=dec_cfg.get("num_z", 4))
        marginalize = bool(dec_cfg.get("marginalize", True))
        refs, hyps, all_nbest = {}, {}, {}
        audio_s = 0.0
        t0 = time.time()
        for i in range(len(ds)):
            feats, labels = ds[i]
            uid = ds.uids[i]
            audio_s += feats.shape[0] * 0.01
            ranked = dec.decode(feats, feats.shape[0],
                                marginalize=marginalize)
            entry = {k: (float(s), tok_g.decode([int(t) for t in seq]))
                     for k, (s, seq) in enumerate(ranked[:4])} \
                or {0: (0.0, "")}
            all_nbest[uid] = entry
            hyps[uid] = entry[0][1]
            refs[uid] = tok_g.decode([int(x) for x in labels])
        wall = time.time() - t0
        print(f"[stage 4] cascade over {len(ds)} utterances: forwards "
              f"{dec.times['device']:.3f} s, beams on the host "
              f"{dec.times['host']:.3f} s")
        mode = "marginalize" if marginalize else "cascade"
        return asr.finalize_decode(expdir, split, refs, hyps, all_nbest,
                                   wall, audio_s, mode, dec_cfg,
                                   extra={"device_s": dec.times["device"],
                                          "host_s": dec.times["host"]})


class P2gTask:
    """Stages 2-4 of an LLM-P2G recipe (counterpart of `P2gTask` of
    `cat_tpu/pipeline/tasks.py`): phoneme sources and grapheme targets,
    with the candidate sets of `src_nbest` where a data dir has one."""

    key = "p2g.train"

    def tokenizer_corpus_file(self, key):
        # the primary tokenizer covers the phoneme sources
        return "src" if key == "tokenizer" else "text"

    def module(self):
        return importlib.import_module("cat_tpu_torch." + self.key)

    def pack(self, expdir, hyper, toks, device=None):
        """pkl/<split>/seq2seq.npz of dev and the train set (a split packed
        already is kept); `device` is unused: nothing is computed."""
        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.data import pack_seq2seq

        tok_s, tok_t = toks["tokenizer"], toks["tokenizer_grapheme"]
        pkl_dir = os.path.join(expdir, "pkl")
        for split, datadir in (("dev", hyper["data"]["dev"]),
                               ("train", asr._train_sets(hyper)[0][0])):
            out = os.path.join(pkl_dir, split)
            if os.path.exists(os.path.join(out, "seq2seq.npz")):
                continue
            src = asr.read_scp(os.path.join(datadir, "src"))
            text = asr.read_scp(os.path.join(datadir, "text"))
            nbest = {}
            nb_path = os.path.join(datadir, "src_nbest")
            if os.path.exists(nb_path):
                with open(nb_path) as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) < 2:
                            continue
                        nbest.setdefault(parts[0], []).append(
                            (float(parts[1]),
                             tok_s.encode(" ".join(parts[2:]))))
            pack_seq2seq(out, ((uid, tok_s.encode(s), tok_t.encode(text[uid]),
                                nbest.get(uid))
                               for uid, s in src.items() if uid in text))
        return pkl_dir

    def build(self, config, toks, device):
        return self.module().build_model(
            config, toks["tokenizer"].vocab_size,
            toks["tokenizer_grapheme"].vocab_size, device=device)

    def train(self, expdir, hyper, config, toks, device="cpu"):
        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.checkpoint import CheckpointManager
        from cat_tpu_torch.utils.data import Seq2SeqDataset, Seq2SeqLoader
        from cat_tpu_torch.utils.manager import Manager
        from cat_tpu_torch.utils.scheduler import build_scheduler

        asr.check_train(hyper, config)
        p2g = self.module()
        opts = hyper["train"].get("option", {})
        mode = opts.get("mode", "ce")
        pkl = os.path.join(expdir, "pkl")
        tr = Seq2SeqDataset(os.path.join(pkl, "train"))
        dv = Seq2SeqDataset(os.path.join(pkl, "dev"))
        if mode in ("tkm", "skm") and not tr.has_nbest:
            raise ValueError(
                "TKM/SKM training needs candidate sets: provide a "
                "`src_nbest` file in the train data dir (offline S2P "
                "n-best, egs/llm-p2g data prep)")
        kw = dict(frame_budget=opts.get("frame_budget", 2048),
                  num_buckets=opts.get("num_buckets", 4),
                  num_cands=hyper.get("tkm", {}).get("k"))
        model = self.build(config, toks, device)
        sched, opt = build_scheduler(config["scheduler"], model.parameters())
        t_weight = opts.get("t_weight", 1.0)
        train_step = p2g.make_train_step(
            model, opt, mode=mode, t_weight=t_weight,
            label_smoothing=opts.get("label_smoothing", 0.0))
        eval_mode = mode if mode in ("tkm", "skm") and dv.has_nbest else "ce"
        eval_step = p2g.make_eval_step(model, mode=eval_mode,
                                       t_weight=t_weight)
        mgr = Manager(train_step, eval_step, p2g.init_state(model, opt),
                      sched, CheckpointManager(os.path.join(expdir, "check")),
                      Seq2SeqLoader(tr, seed=opts.get("seed", 0), **kw),
                      Seq2SeqLoader(dv, shuffle=False, **kw),
                      max_epochs=opts.get("max_epochs", 100),
                      check_freq=opts.get("check_freq", -1),
                      batch_transform=p2g.batch_to_step)
        asr._write_exp_readme(expdir, config, model,
                              toks["tokenizer_grapheme"], loss=f"p2g {mode}")
        if opts.get("resume"):
            mgr.resume(opts["resume"])
        mgr.run()
        return mgr

    def decode(self, expdir, hyper, config, toks, device="cpu"):
        from cat_tpu_torch.pipeline import asr
        from cat_tpu_torch.utils.data import Seq2SeqDataset, Seq2SeqLoader

        import torch

        asr.check_decode(hyper, config)
        p2g = self.module()
        tok_t = toks["tokenizer_grapheme"]
        inf = hyper.get("inference", {})
        dec_cfg = inf.get("decode", {})
        split = inf.get("split", "dev")
        ds = Seq2SeqDataset(os.path.join(expdir, "pkl", split))
        loader = Seq2SeqLoader(
            ds, frame_budget=dec_cfg.get("frame_budget", 2048),
            num_buckets=dec_cfg.get("num_buckets", 4), shuffle=False,
            num_cands=hyper.get("tkm", {}).get("k"))
        model = self.build(config, toks, device)
        model.load_state_dict(asr._load_decode_state(expdir, hyper, model))
        model.eval()
        max_len = int(dec_cfg.get("max_len", 64))
        marginalize = bool(dec_cfg.get("marginalize", False)) \
            and ds.has_nbest
        t_weight = float(hyper.get("tkm", {}).get(
            "temperature", dec_cfg.get("t_weight", 1.0)))
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        text = lambda ids, n: tok_t.decode([int(t) for t in ids[:n]])
        refs, hyps, all_nbest = {}, {}, {}
        t0 = time.time()
        for b in loader:
            if marginalize:  # the best-scored hypothesis of each row
                cand_hyps, cand_lens, scores = p2g.marginalized_decode(
                    model, on(b.cands), on(b.cand_lens), on(b.cand_scores),
                    max_len, t_weight)
                rows, best = torch.arange(len(scores)), scores.argmax(1)
                toks_out, lens = cand_hyps[rows, best], cand_lens[rows, best]
            else:
                toks_out, lens = p2g.greedy_generate(
                    model, on(b.src), on(b.src_lens), max_len=max_len)
            toks_out, lens = toks_out.cpu().numpy(), lens.cpu().numpy()
            for n in range(len(b.weight)):
                if b.weight[n] <= 0:
                    continue
                uid = b.uids[n]
                hyps[uid] = text(toks_out[n], lens[n])
                all_nbest[uid] = {0: (0.0, hyps[uid])}
                refs[uid] = text(b.tgt[n], b.tgt_lens[n])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        mode = "marginalize" if marginalize else "greedy"
        return asr.finalize_decode(expdir, split, refs, hyps, all_nbest,
                                   time.time() - t0, 0.0, mode, dec_cfg)
