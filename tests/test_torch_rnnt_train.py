"""Port parity for the RNN-T train step, in float32 on the CPU.

One whole train step of the transducer of `test_torch_transducer.py`
(2-cell, d=64 conformer, 2-layer LSTM predictor, "add" joiner, V=12;
dropout 0, no SpecAugment) against `cat_tpu.rnnt.train` with its Pallas
lattice scans in interpret mode (`CAT_TPU_RNNT_IMPL=pallas`): loss,
gradient norm, every parameter's gradient, the parameters and running
statistics after the update; `make_eval_step`; the same step at
`grad_accum_fold=2` (two micro-batches, `applied` 0 then 1). The JAX
gradient trees map through `transducer_state_dict` like the parameters.
Tolerance: rtol 1e-4, atol 1e-4. Module-scoped fixtures hold the JAX
side, so each JAX jit compiles once.
"""
from functools import partial

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc.train import accum_tx as jax_accum_tx
from cat_tpu.rnnt import train as jax_train
from cat_tpu_torch.rnnt import train
from cat_tpu_torch.utils.from_jax import transducer_state_dict
from cat_tpu_torch.utils.scheduler import build_scheduler
from tests.test_torch_transducer import (CFG, SCHED, TOL, V, _batch,
                                         _jax_init, _np_tree, _perturbed,
                                         _torch_batch)

torch.set_num_threads(2)
NOISE = 1e-6  # gradient magnitude of float32 rounding noise here


@pytest.fixture(scope="module")
def jax_step():
    """The JAX side of the whole-step comparison, with the Pallas scans in
    interpret mode, as numpy trees."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAT_TPU_RNNT_IMPL", "pallas")
        model, sched, tx, state = _jax_init(CFG)
        params = _perturbed(state.params, 2)
        state = state.replace(params=params, opt_state=tx.init(params))
        stats0 = _np_tree(state.batch_stats)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        loss_fn = jax_train.make_loss_fn(model)
        (loss, (stats, _)), grads = jax.jit(jax.value_and_grad(
            partial(loss_fn, train=True), has_aux=True))(
            state.params, state.batch_stats, batch, jax.random.PRNGKey(0))
        ev = jax_train.make_eval_step(model)(state, batch)
        step = jax_train.make_train_step(model, tx, grad_clip=5.0)
        new_state, metrics = step(state, batch, jnp.float32(sched.lr),
                                  jax.random.PRNGKey(0))
        return {"lr": sched.lr, "params": _np_tree(params), "stats0": stats0,
                "loss": float(loss), "grads": _np_tree(grads),
                "stats": _np_tree(stats),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "eval": {k: float(v) for k, v in ev.items()},
                "new_params": _np_tree(new_state.params),
                "new_stats": _np_tree(new_state.batch_stats)}


def _port(params, stats):
    model = train.build_model(CFG, V, device="cpu")
    model.load_state_dict(transducer_state_dict(params, stats))
    return model


def _compare(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name].numpy(),
                                   err_msg=f"{what} {name}", **TOL)


def _compare_update(model, g_port, g_jax, old, new, lr):
    """The weights and statistics after one Adam step against JAX's
    (`new`), from the same weights `old`, with the applied gradients of
    both sides. Adam's first step moves a weight by lr·g/(|g| + 1e-8):
    where the exact gradient is 0 (the depthwise conv bias under batch
    norm, the key bias under the softmax) it follows either package's
    rounding noise, so weights whose gradient is noise-level in both are
    held to a step within lr; every other gradient must agree in sign."""
    got = {n: t.detach().numpy() for n, t in model.state_dict().items()}
    want = {n: t.numpy() for n, t in new.items()}
    n_noisy = n_all = 0
    for name, _ in model.named_parameters():
        gp, gj = g_port[name], g_jax[name]
        noisy = np.maximum(np.abs(gp), np.abs(gj)) <= NOISE
        n_noisy, n_all = n_noisy + noisy.sum(), n_all + noisy.size
        assert (np.sign(gp) == np.sign(gj))[~noisy].all(), name
        for new_ in (got[name], want[name]):
            assert (np.abs(new_ - old[name].numpy())[noisy]
                    <= lr * (1 + 1e-4)).all(), name
        np.testing.assert_allclose(got[name][~noisy], want[name][~noisy],
                                   err_msg=f"updated {name}", **TOL)
    assert n_noisy <= 0.02 * n_all
    for name, _ in model.named_buffers():
        np.testing.assert_allclose(got[name], want[name],
                                   err_msg=f"updated {name}", **TOL)


def test_train_step_gradients_match_jax(jax_step):
    model = _port(jax_step["params"], jax_step["stats0"])
    model.train()
    loss, _ = train.make_loss_fn(model)(_torch_batch(), None, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-4)
    want = transducer_state_dict(jax_step["grads"], jax_step["stats"])
    buffers = dict(model.named_buffers())
    _compare({n: p.grad.numpy() for n, p in model.named_parameters()},
             {n: t for n, t in want.items() if n not in buffers}, "grad")
    _compare({n: b.numpy() for n, b in buffers.items()},
             {n: t for n, t in want.items() if n in buffers}, "batch stats")


def test_train_step_update_matches_jax(jax_step):
    model = _port(jax_step["params"], jax_step["stats0"])
    sched, opt = build_scheduler(SCHED, model.parameters())
    assert sched.lr == jax_step["lr"]
    step = train.make_train_step(model, opt, grad_clip=5.0)
    state, metrics = step(train.init_state(model, opt), _torch_batch(),
                          sched.lr, torch.Generator().manual_seed(0))
    want = jax_step["metrics"]
    assert metrics["skipped"] == want["skipped"] == 0
    np.testing.assert_allclose(metrics["loss"].item(), want["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), want["grad_norm"],
                               rtol=1e-4)
    assert want["grad_norm"] > 5.0  # the clipping was exercised
    clip = min(1.0, 5.0 / (want["grad_norm"] + 1e-6))
    g_jax = transducer_state_dict(jax_step["grads"], jax_step["stats"])
    _compare_update(model, {n: p.grad.numpy() for n, p in
                            model.named_parameters()},
                    {n: g_jax[n].numpy() * clip for n in g_jax},
                    transducer_state_dict(jax_step["params"],
                                          jax_step["stats0"]),
                    transducer_state_dict(jax_step["new_params"],
                                          jax_step["new_stats"]),
                    jax_step["lr"])


def test_eval_step_matches_jax(jax_step):
    model = _port(jax_step["params"], jax_step["stats0"])
    got = train.make_eval_step(model)(None, _torch_batch())
    want = jax_step["eval"]
    assert np.isfinite(got["loss_sum"].item())
    np.testing.assert_allclose(got["loss_sum"].item(), want["loss_sum"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["count"].item(), want["count"],
                               rtol=1e-6)


def _adam_mu(opt_state):
    found = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def jax_fold():
    """JAX's fold-2 step on micro-batches 0 and 1, Pallas scans in
    interpret mode, as numpy trees."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAT_TPU_RNNT_IMPL", "pallas")
        model, sched, wrapped, state = _jax_init(
            CFG, wrap=lambda tx: jax_accum_tx(tx, 2, 5.0))
        params = _perturbed(state.params, 2)
        state = state.replace(params=params, opt_state=wrapped.init(params))
        out = {"lr": sched.lr, "params": _np_tree(params),
               "stats0": _np_tree(state.batch_stats), "metrics": []}
        step = jax_train.make_train_step(model, wrapped, grad_clip=5.0,
                                         grad_accum_fold=2)
        for i in range(2):
            batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
            state, m = step(state, batch, jnp.float32(sched.lr),
                            jax.random.PRNGKey(i))
            out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params_after"] = _np_tree(state.params)
        out["stats_after"] = _np_tree(state.batch_stats)
        out["mu"] = _np_tree(_adam_mu(state.opt_state.inner))
    return out


def test_fold2_step_matches_jax(jax_fold):
    model = _port(jax_fold["params"], jax_fold["stats0"])
    sched, opt = build_scheduler(SCHED, model.parameters())
    step = train.make_train_step(model, opt, grad_clip=5.0,
                                 grad_accum_fold=2)
    state = train.init_state(model, opt)
    start = {n: t.clone() for n, t in model.named_parameters()}
    for i in range(2):
        state, m = step(state, _torch_batch(i), sched.lr,
                        torch.Generator().manual_seed(0))
        want = jax_fold["metrics"][i]
        assert m["applied"] == want["applied"] == i
        assert m["skipped"] == want["skipped"] == 0
        np.testing.assert_allclose(m["loss"].item(), want["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), want["grad_norm"],
                                   rtol=1e-4)
        if i == 0:
            assert not opt.state
            for name, p in model.named_parameters():
                assert torch.equal(p, start[name]), name
    assert jax_fold["metrics"][1]["grad_norm"] > 5.0  # clipping exercised
    g_jax = transducer_state_dict(jax_fold["mu"], jax_fold["stats_after"])
    g_port = {n: opt.state[p]["exp_avg"].numpy() / 0.1
              for n, p in model.named_parameters()}
    _compare(g_port, {n: g_jax[n] / 0.1 for n in g_port}, "applied grad")
    _compare_update(model, g_port, {n: g_jax[n].numpy() / 0.1
                                    for n in g_port},
                    transducer_state_dict(jax_fold["params"],
                                          jax_fold["stats0"]),
                    transducer_state_dict(jax_fold["params_after"],
                                          jax_fold["stats_after"]),
                    jax_fold["lr"])
