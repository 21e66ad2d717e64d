"""The port's training loop, `cat_tpu_torch.utils.manager.Manager`, on the
CPU.

- Against JAX: a bidirectional LSTM of hdim 8 (dropout 0, no SpecAugment,
  CTC, SchedulerEarlyStop + Adam) trains two epochs with check_freq 3 over
  a packed split under both packages' Managers, from the same weights
  (carried across by `from_jax`). The lr (0.08) is high enough that the
  dev loss rises at some rounds and the scheduler halves the lr. Each
  round's dev and train loss within 1e-4 relative; the lr and the
  scheduler's state name of each round exactly equal; the same
  checkpoint names; the final parameters within atol 1e-4 + rtol 1e-3
  (eighteen Adam steps carry the float32 rounding differences of the
  gradients into the weights: 2.8e-5 at most here).
- Resume on the port, bit for bit: a run stopped at its step-3
  checkpoint and resumed in a fresh Manager (model built from another
  seed) ends with every tensor of the train state (parameters, running
  statistics, Adam moments and steps, the fold accumulator) equal to the
  uninterrupted run's, with the same step and epoch, scheduler
  state_dict, checkpoint index (names and dev losses) and batches. Over
  fold 1 and fold 2 (the checkpoint then falls mid-fold), for an LSTM
  with CTC, a 2-cell CTC-CRF conformer (dropout 0.1, SpecAugment) and a
  toy RNN-T. The generator is not checkpointed (as JAX's rng is not): the
  resumed run is given the state the uninterrupted one's generator had
  at the checkpoint.
- A Noam schedule ends the run at its stop_step; `profile_steps` writes
  a torch.profiler trace.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from cat_tpu.ctc import train as jax_train
from cat_tpu.utils import data as jax_data
from cat_tpu.utils.checkpoint import CheckpointManager as JaxCheckpoints
from cat_tpu.utils.manager import Manager as JaxManager
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.ctc import train
from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.ops.crf_dense import DenseDen
from cat_tpu_torch.rnnt import train as rnnt_train
from cat_tpu_torch.utils import data
from cat_tpu_torch.utils.checkpoint import CheckpointManager
from cat_tpu_torch.utils.from_jax import lstm_encoder_state_dict
from cat_tpu_torch.utils.manager import Manager
from cat_tpu_torch.utils.scheduler import build_scheduler

torch.set_num_threads(2)
V = 9


def _pack(path, n, dim, frames, seed, label_div=5):
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(n):
        T = int(rng.integers(*frames))
        U = int(rng.integers(1, T // label_div))
        utts.append((f"u{seed}-{i:03d}",
                     rng.standard_normal((T, dim)).astype(np.float32),
                     [int(c) for c in rng.integers(1, V, U)]))
    return data.pack_speech_data(path, utts)


def _metrics(mgr):
    with open(mgr.logger.path) as f:
        return [json.loads(line) for line in f]


# --------------------------------------------------------------- vs JAX

LSTM_KW = dict(hdim=8, num_layers=1, bidirectional=True, dropout_rate=0.0)
EARLY_STOP = {"type": "SchedulerEarlyStop",
              "kwargs": {"min_step": 4, "stop_lr": 1e-5, "n_tol": 0,
                         "gamma": 0.5},
              "optimizer": {"type": "Adam", "kwargs": {"lr": 0.08}}}


def test_manager_matches_jax(tmp_path):
    train_dir = _pack(str(tmp_path / "train"), 36, 6, (16, 48), 0)
    dev_dir = _pack(str(tmp_path / "dev"), 8, 6, (16, 48), 1)
    opts = dict(frame_budget=160, num_buckets=2, seed=0)

    jmodel = jax_train.build_model({"encoder": {"type": "LSTM",
                                                "kwargs": LSTM_KW}}, V)
    jsched, tx = jax_build_scheduler(EARLY_STOP)
    jstate = jax_train.init_state(jmodel, tx, 6, jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jds, jdev = jax_data.SpeechDataset(train_dir), \
        jax_data.SpeechDataset(dev_dir)
    jmgr = JaxManager(
        jax_train.make_train_step(jmodel, tx, "ctc"),
        jax_train.make_eval_step(jmodel, "ctc"), jstate, jsched,
        JaxCheckpoints(str(tmp_path / "jax")),
        jax_data.BucketedLoader(jds, **opts),
        jax_data.BucketedLoader(jdev, shuffle=False, **opts),
        max_epochs=2, check_freq=3, verbose=False)
    jmgr.run()

    model = train.build_model({"encoder": {"type": "LSTM", "kwargs": dict(
        LSTM_KW, idim=6)}}, V, device="cpu")
    model.load_state_dict(lstm_encoder_state_dict(params0))
    sched, opt = build_scheduler(EARLY_STOP, model.parameters())
    mgr = Manager(
        train.make_train_step(model, opt, "ctc"),
        train.make_eval_step(model, "ctc"), train.init_state(model, opt),
        sched, CheckpointManager(str(tmp_path / "port")),
        data.BucketedLoader(data.SpeechDataset(train_dir), **opts),
        data.BucketedLoader(data.SpeechDataset(dev_dir), shuffle=False,
                            **opts),
        max_epochs=2, check_freq=3, verbose=False)
    mgr.run()

    assert mgr.global_step == jmgr.global_step >= 12
    assert mgr.epoch == jmgr.epoch == 2
    want = [m for m in _metrics(jmgr) if "dev_loss" in m]
    got = [m for m in _metrics(mgr) if "dev_loss" in m]
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        assert (g["step"], g["epoch"], g["sched"]) == \
            (w["step"], w["epoch"], w["sched"])
        assert g["lr"] == w["lr"]
        np.testing.assert_allclose(g["dev_loss"], w["dev_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=1e-4)
    assert {m["sched"] for m in got} == {"IMPROVED", "CONTINUE"}
    assert got[-1]["lr"] < got[0]["lr"]
    assert sched.state_dict().keys() == jsched.state_dict().keys()
    assert sched.lr == jsched.lr and sched._cnt_worse == jsched._cnt_worse
    assert [e[0] for e in mgr.ckpt.entries] == \
        [e[0] for e in jmgr.ckpt.entries]
    final = lstm_encoder_state_dict(
        jax.tree_util.tree_map(np.asarray, jmgr.state.params))
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
        moved = max(moved, float((final[name] - lstm_encoder_state_dict(
            params0)[name]).abs().max()))
    assert moved > 1e-2  # the weights did train


# --------------------------------------------------------------- resume

SCHED = {"type": "SchedulerNoam",
         "kwargs": {"dim_model": 32, "warmup_step": 5, "stop_step": 1000,
                    "peak_factor": 2.0},
         "optimizer": {"type": "Adam", "kwargs": {"betas": [0.9, 0.98]}}}
SPECAUG = {"num_freq_masks": 1, "freq_mask_width": 4, "num_time_masks": 1,
           "time_mask_width": 8}


def _setup(tmp_path, kind, fold, seed, name):
    """A Manager of `kind` over its own packed split; returns (manager,
    the list the uids of every train batch go to)."""
    if kind == "conformer-crf":
        dim, frames, div = 16, (44, 100), 12
    else:
        dim, frames, div = 6, (16, 48), 5
    train_dir = str(tmp_path / f"{kind}-train")
    if not os.path.exists(train_dir):
        _pack(train_dir, 30, dim, frames, 0, div)
        _pack(str(tmp_path / f"{kind}-dev"), 6, dim, frames, 1, div)
    if kind == "lstm-ctc":
        model = train.build_model({"encoder": {"type": "LSTM", "kwargs": dict(
            hdim=8, num_layers=2, dropout_rate=0.1, idim=dim)}}, V,
            device="cpu", seed=seed)
        make = lambda opt: (train.make_train_step(model, opt, "ctc",
                                                  grad_accum_fold=fold),
                            train.make_eval_step(model, "ctc"))
    elif kind == "conformer-crf":
        model = train.build_model({"encoder": {"type": "ConformerNet",
                                               "kwargs": dict(
            num_cells=2, hdim=32, num_heads=2, kernel_size=5,
            dropout_rate=0.1, idim=dim)}}, V, device="cpu", seed=seed)
        rng = np.random.default_rng(0)
        den = DenseDen.from_ngram(train_ngram(
            [list(map(int, rng.integers(1, V, 6))) for _ in range(40)],
            order=2), V)
        make = lambda opt: (train.make_train_step(
            model, opt, "crf", den, 0.1, SPECAUG, grad_accum_fold=fold),
            train.make_eval_step(model, "crf", den, 0.1))
    else:
        model = rnnt_train.build_model({
            "encoder": {"type": "LSTM", "kwargs": dict(
                hdim=8, num_layers=1, dropout_rate=0.0, idim=dim)},
            "predictor": {"type": "LSTMPredictor",
                          "kwargs": {"hdim": 8, "num_layers": 1}},
            "joiner": {"type": "JointNet",
                       "kwargs": {"hdim": 8, "join_mode": "add"}}},
            V, device="cpu", seed=seed)
        make = lambda opt: (rnnt_train.make_train_step(
            model, opt, SPECAUG, grad_accum_fold=fold),
            rnnt_train.make_eval_step(model))
    sched, opt = build_scheduler(SCHED, model.parameters())
    step, evaluate = make(opt)
    seen = []

    def transform(batch):
        seen.append(list(batch.uids))
        return batch.asdict()

    opts = dict(frame_budget=8 * frames[1] // 2, num_buckets=2, seed=0)
    mgr = Manager(
        step, evaluate, train.init_state(model, opt), sched,
        CheckpointManager(str(tmp_path / name), keep_last=100),
        data.BucketedLoader(data.SpeechDataset(train_dir), **opts),
        data.BucketedLoader(data.SpeechDataset(
            str(tmp_path / f"{kind}-dev")), shuffle=False, **opts),
        gen=torch.Generator().manual_seed(11), max_epochs=2, check_freq=3,
        verbose=False, grad_accum_fold=fold, batch_transform=transform)
    return mgr, seen


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


@pytest.mark.parametrize("fold", [1, 2])
@pytest.mark.parametrize("kind", ["lstm-ctc", "conformer-crf", "rnnt"])
def test_mid_epoch_resume_is_bitwise(tmp_path, kind, fold):
    a, seen_a = _setup(tmp_path, kind, fold, 0, "a")
    at = {}
    save = a.save

    def save_and_note(metric):
        name = save(metric)
        if a.global_step == 3:
            at.update(path=a.ckpt.path(name), gen=a.gen.get_state(),
                      batches=len(seen_a), fold=a.state.fold_count)
        return name

    a.save = save_and_note
    a.run()
    n_epoch = a.train_loader.num_batches()
    assert a.global_step == 2 * n_epoch and n_epoch > 3
    assert at["fold"] == (1 if fold == 2 else 0)  # mid-fold at fold 2

    b, seen_b = _setup(tmp_path, kind, fold, 7, "b")
    b.resume(at["path"])
    assert (b.global_step, b.epoch) == (3, 0)
    assert b.state.fold_count == at["fold"]
    b.gen.set_state(at["gen"])
    b.run()

    assert (b.global_step, b.epoch) == (a.global_step, a.epoch)
    assert b.scheduler.state_dict() == a.scheduler.state_dict()
    assert seen_b == seen_a[at["batches"]:]
    assert b.ckpt.entries == a.ckpt.entries[1:]
    ga, gb = _flat(a.state.state_dict()), _flat(b.state.state_dict())
    assert sorted(ga) == sorted(gb)
    for k, v in ga.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == gb[k].dtype and torch.equal(v, gb[k]), k
        else:
            assert v == gb[k], k
    assert a.state.skipped == 0


# --------------------------------------------------------------- stops

def test_noam_ends_the_run_at_stop_step(tmp_path):
    mgr, _ = _setup(tmp_path, "lstm-ctc", 1, 0, "noam")
    mgr.scheduler.stop_step = 4
    mgr.max_epochs = 50
    mgr.run()
    rounds = [m for m in _metrics(mgr) if "sched" in m]
    assert rounds[-1]["sched"] == "TERMINATED" and rounds[-1]["step"] == 6
    assert mgr.global_step == 6 and mgr.epoch == 1


def test_profile_steps_write_a_trace(tmp_path):
    mgr, _ = _setup(tmp_path, "lstm-ctc", 1, 0, "prof")
    mgr.profile_steps = (2, 4)
    mgr.max_epochs = 1
    mgr.run()
    path = os.path.join(mgr.ckpt.dir, "profile", "trace_2-4.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
