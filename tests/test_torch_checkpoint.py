"""The port's checkpoints (`cat_tpu_torch.utils.checkpoint`) and the
train state they carry, against `cat_tpu.utils.checkpoint` where the JAX
package has the same function.

- A `TrainState` (parameters, running statistics, Adam moments and steps,
  the fold accumulator of a fold-2 micro-step) through `save_checkpoint`
  and `load_checkpoint`, and into a fresh state built from another seed:
  every tensor bit for bit, with its dtype.
- `CheckpointManager` against JAX's under one sequence of (metric, step,
  epoch): the same file names on disk after every save, the same
  `checkpoint.list` text, the same `best()` and `last()`.
- `average_checkpoints` against JAX's on the same weights: 1e-6.
- `Manager.load_init_model` from a JAX checkpoint against JAX's: the
  parameters equal to the converted JAX ones (exactly, they are copies),
  optimizer and running statistics untouched.
- `model_weights`, the decode CLIs' loader, on a checkpoint of either
  package.
"""
import os

import numpy as np
import pytest
import torch

import jax

from cat_tpu.ctc import train as jax_train
from cat_tpu.utils import checkpoint as jax_ckpt
from cat_tpu.utils.manager import Manager as JaxManager
from cat_tpu.utils.manager import TrainState as JaxTrainState
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.ctc import train
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils.from_jax import (conformer_state_dict,
                                          lstm_encoder_state_dict)
from cat_tpu_torch.utils.manager import Manager
from cat_tpu_torch.utils.scheduler import build_scheduler

torch.set_num_threads(2)
V = 7
CONFORMER = {"encoder": {"type": "ConformerNet", "kwargs": dict(
    num_cells=2, hdim=32, num_heads=2, kernel_size=5, dropout_rate=0.1,
    idim=16)}}
LSTM = {"encoder": {"type": "LSTM", "kwargs": dict(
    hdim=8, num_layers=2, bidirectional=True, dropout_rate=0.0, idim=6)}}
def _jax_cfg(cfg):
    """The JAX package's config: its encoders infer `idim`."""
    kw = {k: v for k, v in cfg["encoder"]["kwargs"].items() if k != "idim"}
    return {"encoder": dict(cfg["encoder"], kwargs=kw)}


SCHED = {"type": "SchedulerNoam",
         "kwargs": {"dim_model": 32, "warmup_step": 10, "stop_step": 100},
         "optimizer": {"type": "Adam", "kwargs": {"betas": [0.9, 0.98]}}}


def _batch(seed, idim=16):
    g = torch.Generator().manual_seed(seed)
    flens = torch.tensor([40, 33, 21])
    feats = torch.randn(3, 40, idim, generator=g)
    feats *= (torch.arange(40)[None, :, None] < flens[:, None, None])
    return {"feats": feats, "feat_lengths": flens,
            "labels": torch.randint(1, V, (3, 4), generator=g),
            "label_lengths": torch.tensor([4, 3, 2]),
            "weight": torch.tensor([1.0, 1.0, 0.0])}


def _state(seed):
    model = train.build_model(CONFORMER, V, device="cpu", seed=seed)
    sched, opt = build_scheduler(SCHED, model.parameters())
    return train.init_state(model, opt), sched


def _tensors(tree, prefix=""):
    """{path: tensor} of every tensor in nested dicts and lists."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_tensors(v, f"{prefix}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    return out


def _assert_bitwise(got, want):
    g, w = _tensors(got), _tensors(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_train_state_round_trip_is_bitwise(tmp_path):
    """Three fold-2 micro-steps (one whole fold, then one into the next):
    the checkpoint carries the parameters, running statistics, Adam
    moments and steps, and the fold's sums, weight and count."""
    state, sched = _state(0)
    step = train.make_train_step(state.model, state.optimizer, "ctc",
                                 specaug_cfg=None, grad_accum_fold=2)
    gen = torch.Generator().manual_seed(1)
    for i in range(3):
        state, m = step(state, _batch(i), sched.lr, gen)
    assert state.fold_count == 1 and float(state.fold_weight) == 2.0
    assert any(s.abs().sum() > 0 for s in state.fold_sums)
    want = state.state_dict()
    assert want["fold"]["count"] == 1
    assert len(want["optimizer"]["state"]) == len(state.fold_sums)
    path = str(tmp_path / "c.pt")
    ckpt.save_checkpoint(path, {"state": want, "epoch": 1})
    assert ckpt.is_port_checkpoint(path)
    assert not os.path.exists(path + ".tmp")
    got = ckpt.load_checkpoint(path)
    assert got["epoch"] == 1
    _assert_bitwise(got["state"], want)
    fresh, _ = _state(9)
    assert not torch.equal(fresh.model.cells[0].ff1.fc1.kernel,
                           state.model.cells[0].ff1.fc1.kernel)
    fresh.load_state_dict(got["state"])
    _assert_bitwise(fresh.state_dict(), want)
    assert (fresh.step, fresh.skipped, fresh.fold_count) == (3, 0, 1)


def test_checkpoint_manager_matches_jax(tmp_path):
    seq = [(5.0, 3, 1), (3.0, 6, 1), (4.0, 9, 2), (2.0, 12, 2), (2.5, 15, 3),
           (6.0, 18, 3), (1.5, 21, 4), (7.0, 24, 4), (3.3, 27, 5),
           (0.9, 30, 5), (8.0, 33, 6)]
    for keep in ((5, 3), (2, 1)):
        jm = jax_ckpt.CheckpointManager(str(tmp_path / f"j{keep}"), *keep)
        pm = ckpt.CheckpointManager(str(tmp_path / f"p{keep}"), *keep)
        for metric, step, epoch in seq:
            w = np.full((2,), float(step), np.float32)
            jn = jm.save({"params": {"w": w}}, metric, step, epoch)
            pn = pm.save({"state": {"model": {"w": torch.from_numpy(w)}}},
                         metric, step, epoch)
            assert pn == jn
            assert sorted(os.listdir(pm.dir)) == sorted(os.listdir(jm.dir))
            assert (pm.best(), pm.last()) == (jm.best(), jm.last())
        with open(jm.index_path) as a, open(pm.index_path) as b:
            assert a.read() == b.read()
        # a reader of either package's index sees the same entries
        assert ckpt.CheckpointManager(jm.dir).entries == pm.entries
        best = ckpt.load_checkpoint(pm.path(pm.best()))
        assert float(best["state"]["model"]["w"][0]) == 30.0


def _lstm_params(n):
    """n sets of JAX LSTM parameters: one initialisation, seeded noise."""
    model = jax_train.build_model(_jax_cfg(LSTM), V)
    base = jax.jit(model.init)(jax.random.PRNGKey(0),
                               np.zeros((2, 16, 6), np.float32),
                               np.array([16, 16], np.int32))["params"]
    rng = np.random.default_rng(1)
    return [jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape))
        .astype(np.float32), base) for _ in range(n)]


def test_average_checkpoints_matches_jax(tmp_path):
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "j"), 10, 10)
    pm = ckpt.CheckpointManager(str(tmp_path / "p"), 10, 10)
    model = train.build_model(LSTM, V, device="cpu")
    jpaths, ppaths = [], []
    for i, params in enumerate(_lstm_params(3)):
        js = JaxTrainState(params=params, batch_stats={}, opt_state=(),
                           step=np.asarray(i))
        jpaths.append(jm.path(jm.save({"state": js}, 1.0, i, 1)))
        model.load_state_dict(lstm_encoder_state_dict(params))
        ppaths.append(pm.path(pm.save({"state": {
            "model": model.state_dict()}}, 1.0, i, 1)))
    want = lstm_encoder_state_dict(
        jax_ckpt.average_checkpoints(jpaths, key="state").params)
    got = ckpt.average_checkpoints(ppaths)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_load_init_model_from_a_jax_checkpoint(tmp_path):
    jmodel = jax_train.build_model(_jax_cfg(CONFORMER), V)
    sched, tx = jax_build_scheduler(SCHED)
    init = jax_train.init_state(jmodel, tx, 16, jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), init.params)
    saved = init.replace(params=params)
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "j"))
    path = jm.path(jm.save({"state": saved}, 1.0, 1, 1))

    jmgr = JaxManager(None, None, init, sched, jm, None, None,
                      verbose=False)
    jmgr.load_init_model(path)
    state, psched = _state(3)
    stats = {n: b.clone() for n, b in state.model.named_buffers()}
    mgr = Manager(None, None, state, psched,
                  ckpt.CheckpointManager(str(tmp_path / "p")), None, None,
                  verbose=False)
    mgr.load_init_model(path)
    want = conformer_state_dict(
        jax.tree_util.tree_map(np.asarray, jmgr.state.params),
        jax.tree_util.tree_map(np.asarray, init.batch_stats))
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    for n, b in state.model.named_buffers():
        assert torch.equal(b, stats[n]), n
    assert state.optimizer.state_dict()["state"] == {}
    # the port's own checkpoint, weights only
    other, _ = _state(5)
    mgr2 = Manager(None, None, other, psched, mgr.ckpt, None, None,
                   verbose=False)
    p2 = mgr.save(0.5)
    mgr2.load_init_model(mgr.ckpt.path(p2))
    for (n, a), (_, b) in zip(other.model.named_parameters(),
                              state.model.named_parameters()):
        assert torch.equal(a, b), n


def test_model_weights_reads_either_package(tmp_path):
    """`model_weights` (the decode CLIs' loader): a checkpoint of the port
    gives its model state dict back; one of the JAX package gives the
    `from_jax` conversion of its params and batch_stats."""
    params = _lstm_params(1)[0]
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "j"))
    jpath = jm.path(jm.save({"state": JaxTrainState(
        params=params, batch_stats={}, opt_state=(), step=np.asarray(1))},
        1.0, 1, 1))
    model = train.build_model(LSTM, V, device="cpu", seed=2)
    want = lstm_encoder_state_dict(params)
    got = ckpt.model_weights(model, jpath)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model.load_state_dict(got)
    pm = ckpt.CheckpointManager(str(tmp_path / "p"))
    ppath = pm.path(pm.save({"state": {"model": model.state_dict()}}, 1.0,
                            1, 1))
    assert ckpt.is_port_checkpoint(ppath) and not \
        ckpt.is_port_checkpoint(jpath)
    other = train.build_model(LSTM, V, device="cpu", seed=3)
    other.load_state_dict(ckpt.model_weights(other, ppath))
    for (n, a), (_, b) in zip(other.state_dict().items(),
                              model.state_dict().items()):
        assert torch.equal(a, b), n
