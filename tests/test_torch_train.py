"""Port parity for training, in float32 on the CPU.

- One whole CTC-CRF train step: a 2-cell, d=128, 4-head conformer with
  V=12, dense 3-gram denominator, dropout 0, no SpecAugment, weights
  carried across with `utils/from_jax.py`, against `cat_tpu`'s
  `make_loss_fn` gradients and `make_train_step` (the XLA path, Noam +
  Adam, clipping at 5). The JAX gradient tree maps through
  `conformer_state_dict` like the parameters. Compared: loss, gradient
  norm, every parameter's gradient, every parameter after the update, the
  updated running statistics.
- A training-mode ConvModule (batch statistics, running-stat update)
  against the JAX module applied with `mutable=["batch_stats"]`.
- The NaN/Inf guard: a poisoned batch leaves parameters, optimizer state
  and running statistics bit-identical, with `skipped` = 1.
- The eval step and the Noam schedule against `cat_tpu`'s.
- `grad_accum_fold > 1` is refused with a pointer to ROADMAP.md.
Tolerance: loss and grad norm rtol 1e-4; gradients, parameters and
statistics rtol 1e-4, atol 1e-4. One module-scoped fixture holds the JAX
side, so each JAX jit compiles once.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc import train as jax_train
from cat_tpu.fst.ngram import train_ngram as jax_train_ngram
from cat_tpu.models.layers import ConvModule as JaxConvModule
from cat_tpu.ops.crf_dense import DenseDen as JaxDenseDen
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.ctc import train
from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.models.layers import ConvModule
from cat_tpu_torch.ops.crf_dense import DenseDen
from cat_tpu_torch.utils.from_jax import (conformer_state_dict,
                                          conv_module_state_dict)
from cat_tpu_torch.utils.scheduler import build_scheduler

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
V = 12
KW = dict(num_cells=2, hdim=128, num_heads=4, kernel_size=15,
          num_classes=V, dropout_rate=0.0)
SCHED = {"type": "SchedulerNoam",
         "kwargs": {"dim_model": 128, "warmup_step": 100, "stop_step": 1000,
                    "peak_factor": 5.0},
         "optimizer": {"type": "Adam",
                       "kwargs": {"lr": 1e-3, "betas": [0.9, 0.98]}}}
LAMB = 0.01
NOISE = 1e-6  # gradient magnitude of float32 rounding noise here


def _batch():
    rng = np.random.default_rng(0)
    flens = np.array([60, 47, 33], np.int32)
    feats = rng.standard_normal((3, 60, 80)).astype(np.float32)
    feats *= (np.arange(60)[None, :, None] < flens[:, None, None])
    llens = np.array([5, 4, 2], np.int32)
    labels = rng.integers(1, V, (3, 5)).astype(np.int32)
    labels *= np.arange(5)[None, :] < llens[:, None]
    return {"feats": feats, "feat_lengths": flens, "labels": labels,
            "label_lengths": llens,
            "weight": np.array([1.0, 0.5, 2.0], np.float32)}


def _seqs():
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(1, V, size=int(rng.integers(3, 10)))))
            for _ in range(50)]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX side of the whole-step comparison, as numpy trees."""
    model = jax_train.build_model({"encoder": {"type": "ConformerNet",
                                               "kwargs": KW}}, V)
    sched, tx = jax_build_scheduler(SCHED)
    state = jax_train.init_state(model, tx, 80, jax.random.PRNGKey(3))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), state.params)
    state = state.replace(params=params, opt_state=tx.init(params))
    den = JaxDenseDen.from_ngram(jax_train_ngram(_seqs(), order=3), V)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    loss_fn = jax_train.make_loss_fn(model, "crf", den, LAMB, None)
    key = jax.random.PRNGKey(0)
    (loss, (stats, _)), grads = jax.jit(jax.value_and_grad(
        partial(loss_fn, train=True), has_aux=True))(
        state.params, state.batch_stats, batch, key)
    stats0 = _np_tree(state.batch_stats)
    step = jax_train.make_train_step(model, tx, "crf", den, LAMB, None,
                                     grad_clip=5.0)
    evaluate = jax_train.make_eval_step(model, "crf", den, LAMB)
    ev = evaluate(state, batch)
    # the step donates its input state
    new_state, metrics = step(state, batch, jnp.float32(sched.lr), key)
    return {"lr": sched.lr, "params": _np_tree(params),
            "stats0": stats0, "loss": float(loss),
            "grads": _np_tree(grads), "stats": _np_tree(stats),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "eval": {k: float(v) for k, v in ev.items()},
            "new_params": _np_tree(new_state.params),
            "new_stats": _np_tree(new_state.batch_stats)}


def _port(jax_step):
    model = train.build_model({"encoder": {"type": "ConformerNet",
                                           "kwargs": KW}}, V, device="cpu")
    model.load_state_dict(conformer_state_dict(jax_step["params"],
                                               jax_step["stats0"]))
    den = DenseDen.from_ngram(train_ngram(_seqs(), order=3), V)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    return model, den, batch


def _compare(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name].numpy(),
                                   err_msg=f"{what} {name}", **TOL)


def test_train_step_gradients_match_jax(jax_step):
    model, den, batch = _port(jax_step)
    model.train()
    loss, _ = train.make_loss_fn(model, "crf", den, LAMB)(batch, None, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-4)
    want = conformer_state_dict(jax_step["grads"], jax_step["stats"])
    buffers = dict(model.named_buffers())
    _compare({n: p.grad.numpy() for n, p in model.named_parameters()},
             {n: t for n, t in want.items() if n not in buffers}, "grad")
    _compare({n: b.numpy() for n, b in buffers.items()},
             {n: t for n, t in want.items() if n in buffers}, "batch stats")


def test_train_step_update_matches_jax(jax_step):
    model, den, batch = _port(jax_step)
    sched, opt = build_scheduler(SCHED, model.parameters())
    assert sched.lr == jax_step["lr"]
    step = train.make_train_step(model, opt, "crf", den, LAMB, None,
                                 grad_clip=5.0)
    state, metrics = step(train.init_state(model, opt), batch, sched.lr,
                          torch.Generator().manual_seed(0))
    want = jax_step["metrics"]
    assert metrics["skipped"] == want["skipped"] == 0
    assert state.step == 1 and state.skipped == 0
    np.testing.assert_allclose(metrics["loss"].item(), want["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), want["grad_norm"],
                               rtol=1e-4)
    assert want["grad_norm"] > 5.0  # the clipping was exercised
    got = {n: t.detach().numpy() for n, t in model.state_dict().items()}
    want = {n: t.numpy() for n, t in conformer_state_dict(
        jax_step["new_params"], jax_step["new_stats"]).items()}
    old = conformer_state_dict(jax_step["params"], jax_step["stats0"])
    clip = min(1.0, 5.0 / (jax_step["metrics"]["grad_norm"] + 1e-6))
    g_jax = conformer_state_dict(jax_step["grads"], jax_step["stats"])
    # Adam's first step moves each weight by lr * g / (|g| + 1e-8). Where
    # the exact gradient is 0 (the depthwise conv bias under batch norm,
    # the key bias under the softmax, position-table columns constant over
    # the utterance) the step follows either package's rounding noise; so
    # weights whose gradient is noise-level in both are held to a step
    # within lr, and every other gradient must agree in sign.
    n_noisy = n_all = 0
    for name, p in model.named_parameters():
        gp, gj = p.grad.numpy(), g_jax[name].numpy() * clip
        noisy = np.maximum(np.abs(gp), np.abs(gj)) <= NOISE
        n_noisy, n_all = n_noisy + noisy.sum(), n_all + noisy.size
        assert (np.sign(gp) == np.sign(gj))[~noisy].all(), name
        for new in (got[name], want[name]):
            step_ = np.abs(new - old[name].numpy())[noisy]
            assert (step_ <= jax_step["lr"] * (1 + 1e-4)).all(), name
        np.testing.assert_allclose(got[name][~noisy], want[name][~noisy],
                                   err_msg=f"updated {name}", **TOL)
    # 1.5 % here, mostly rows of W_pos that meet near-constant columns of
    # the sinusoid table over 14 frames
    assert n_noisy <= 0.02 * n_all
    for name, b in model.named_buffers():
        np.testing.assert_allclose(got[name], want[name],
                                   err_msg=f"updated {name}", **TOL)


def test_eval_step_matches_jax(jax_step):
    model, den, batch = _port(jax_step)
    got = train.make_eval_step(model, "crf", den, LAMB)(None, batch)
    want = jax_step["eval"]
    np.testing.assert_allclose(got["loss_sum"].item(), want["loss_sum"],
                               rtol=1e-4)
    assert got["count"].item() == want["count"]


def test_noam_schedule_matches_jax():
    jax_sched, _ = jax_build_scheduler(SCHED)
    sched, opt = build_scheduler(SCHED, [torch.zeros(1, requires_grad=True)])
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["betas"] == (0.9, 0.98) and opt.defaults["eps"] == 1e-8
    for n in (1, 2, 50, 99, 100, 101, 5000):
        jax_sched.update_lr_step(n)
        sched.update_lr_step(n)
        assert sched.lr == pytest.approx(jax_sched.lr, rel=1e-12)


def test_nan_guard_leaves_every_state_untouched(jax_step):
    model, den, batch = _port(jax_step)
    sched, opt = build_scheduler(SCHED, model.parameters())
    step = train.make_train_step(model, opt, "crf", den, LAMB, None)
    gen = torch.Generator().manual_seed(0)
    state, _ = step(train.init_state(model, opt), batch, sched.lr, gen)
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              [{k: v.clone() if torch.is_tensor(v) else v
                for k, v in s.items()} for s in opt.state.values()])
    poisoned = dict(batch, feats=batch["feats"].clone())
    poisoned["feats"][1, 3, 5] = float("nan")
    state, metrics = step(state, poisoned, sched.lr, gen)
    assert metrics["skipped"] == 1 and state.skipped == 1 and state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    for s, old in zip(opt.state.values(), before[1]):
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(old[k])), k


def test_grad_accumulation_is_refused():
    model = train.build_model({"encoder": {"type": "ConformerNet",
                                           "kwargs": KW}}, V, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.make_train_step(model, None, grad_accum_fold=16)


def test_conv_module_training_matches_jax():
    D, k = 128, 15
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 21, D)).astype(np.float32)
    lengths = np.array([21, 13, 1])
    mask = np.arange(21)[None, :] < lengths[:, None]
    jm = JaxConvModule(D, k, dropout_rate=0.0, residual=True)
    v = jm.init(jax.random.PRNGKey(0), x, mask, deterministic=True)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(np.asarray(a)) + 0.5).astype(np.float32),
        v["batch_stats"])
    want, new = jm.apply({"params": params, "batch_stats": stats}, x, mask,
                         deterministic=False, mutable=["batch_stats"])
    port = ConvModule(D, k)
    port.load_state_dict(conv_module_state_dict(params, stats))
    port.train()
    got = port(torch.from_numpy(x), torch.from_numpy(mask), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]), **TOL)
