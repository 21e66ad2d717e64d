"""Port parity: the JoinAP output layers (iumien crf-joinap, cv-lang10
multi-phoneme), in float32 on the CPU, P a seeded (8, 51) matrix.

- `JoinAPLinearEncoder` and `JoinAPNonLinearEncoder` over a 2-cell, d =
  64, kernel-15 `ConformerNet` head and over an `LSTM` head, bi- and
  unidirectional, weights carried across by `from_jax.joinap_state_dict`:
  logits rtol 1e-3, atol 1e-3 (the tolerance of
  `tests/test_torch_encoder.py`), lengths exact. The state_dict holds the
  converted JAX params and batch_stats, one for one over the conformer
  head, and no P.
- One CTC-CRF train step (dense 3-gram denominator, lambda 0.1, Noam +
  Adam, clipping at 5) of the linear layer over the conformer head in
  the stacked-cell layout of `scan_layers`, against `cat_tpu`'s
  `make_train_step`: loss and grad norm rtol 1e-4, every gradient and
  every updated weight rtol 1e-4, atol 1e-4.
- A checkpoint of the JAX package's `CheckpointManager` loads into the
  port and gives JAX's logits; it averages with a port checkpoint.
- A P whose rows differ from num_classes raises.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc import train as jax_train
from cat_tpu.fst.ngram import train_ngram as jax_train_ngram
from cat_tpu.ops.crf_dense import DenseDen as JaxDenseDen
from cat_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.ctc import train
from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.ops.crf_dense import DenseDen
from cat_tpu_torch.utils.checkpoint import (average_checkpoints,
                                            model_weights, save_checkpoint)
from cat_tpu_torch.utils.from_jax import joinap_state_dict
from cat_tpu_torch.utils.scheduler import build_scheduler

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
V, F, LAMB = 8, 80, 0.1
LENGTHS = np.array([60, 47, 33], np.int32)
HEADS = {
    "conformer": ("ConformerNet", dict(num_cells=2, hdim=64, num_heads=4,
                                       kernel_size=15, dropout_rate=0.0)),
    "blstm": ("LSTM", dict(hdim=16, num_layers=2, bidirectional=True,
                           dropout_rate=0.0)),
    "lstm": ("LSTM", dict(hdim=16, num_layers=1, bidirectional=False,
                          dropout_rate=0.0)),
}
SCHED = {"type": "SchedulerNoam",
         "kwargs": {"dim_model": 64, "warmup_step": 100, "stop_step": 1000,
                    "peak_factor": 5.0},
         "optimizer": {"type": "Adam",
                       "kwargs": {"lr": 1e-3, "betas": [0.9, 0.98]}}}
NOISE = 1e-6  # gradient magnitude of float32 rounding noise here


@pytest.fixture(scope="module")
def pv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("pv") / "phono_vec.npy"
    np.save(path, np.random.default_rng(0).standard_normal(
        (V, 51)).astype(np.float32))
    return str(path)


def _config(kind, head, pv_path, **head_extra):
    head_type, head_kw = HEADS[head]
    kwargs = {"pv_path": pv_path, "enc_head_type": head_type,
              "enc_head_kwargs": dict(head_kw, **head_extra)}
    if kind == "JoinAPNonLinearEncoder":
        kwargs["ap_hdim"] = 24
    return {"encoder": {"type": kind, "kwargs": kwargs}}


def _port_config(config):
    """The port's config: `idim` set in the head's kwargs, as the pipeline
    sets it (`pipeline/asr.py` `_with_feat_dim`)."""
    kw = dict(config["encoder"]["kwargs"])
    kw["enc_head_kwargs"] = dict(kw["enc_head_kwargs"], idim=F)
    return {"encoder": dict(config["encoder"], kwargs=kw)}


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 60, F)).astype(np.float32)
    return x * (np.arange(60)[None, :, None] < LENGTHS[:, None, None])


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_variables(model, seed=0):
    """Initialised variables, perturbed so every term shows."""
    v = jax.jit(partial(model.init, deterministic=True))(
        jax.random.PRNGKey(seed), _feats(), LENGTHS)
    rng = np.random.default_rng(seed + 1)
    noise = lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                       ).astype(np.float32)
    params = jax.tree_util.tree_map(noise, v["params"])
    stats = jax.tree_util.tree_map(lambda a: np.abs(noise(a)) + 0.5,
                                   v.get("batch_stats", {}))
    return params, stats


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("kind", ["JoinAPLinearEncoder",
                                  "JoinAPNonLinearEncoder"])
def test_joinap_logits_match_jax(pv_path, kind, head):
    config = _config(kind, head, pv_path)
    jm = jax_train.build_model(config, V)
    params, stats = _jax_variables(jm)
    want, want_len = jax.jit(partial(jm.apply, deterministic=True))(
        {"params": params, "batch_stats": stats}, _feats(), LENGTHS)
    model = train.build_model(_port_config(config), V, device="cpu")
    sd = joinap_state_dict(model, params, stats)
    assert set(sd) == set(model.state_dict())
    if head == "conformer":  # an LSTM cell's gate kernels are concatenated
        assert len(sd) == len(jax.tree_util.tree_leaves((params, stats)))
    assert "P" not in model.state_dict() and model.P.shape == (V, 51)
    model.load_state_dict(sd)
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(_feats()),
                             torch.from_numpy(LENGTHS))
    assert got.dtype == torch.float32 and got.shape[-1] == V
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    valid = np.arange(got.shape[1])[None, :] < np.asarray(want_len)[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **LOGIT_TOL)


def _seqs():
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(1, V, size=int(rng.integers(3, 10)))))
            for _ in range(50)]


def _batch():
    rng = np.random.default_rng(2)
    llens = np.array([5, 4, 2], np.int32)
    labels = rng.integers(1, V, (3, 5)).astype(np.int32)
    labels *= np.arange(5)[None, :] < llens[:, None]
    return {"feats": _feats(), "feat_lengths": LENGTHS, "labels": labels,
            "label_lengths": llens,
            "weight": np.array([1.0, 0.5, 2.0], np.float32)}


@pytest.fixture(scope="module")
def jax_step(pv_path):
    """One JAX CTC-CRF train step of the linear JoinAP layer over the
    conformer head (stacked cells), as numpy."""
    config = _config("JoinAPLinearEncoder", "conformer", pv_path,
                     scan_layers=True)
    model = jax_train.build_model(config, V)
    sched, tx = jax_build_scheduler(SCHED)
    state = jax_train.init_state(model, tx, F, jax.random.PRNGKey(3))
    params, _ = _jax_variables(model, 3)
    state = state.replace(params=params, opt_state=tx.init(params))
    den = JaxDenseDen.from_ngram(jax_train_ngram(_seqs(), order=3), V)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(0)
    loss_fn = jax_train.make_loss_fn(model, "crf", den, LAMB, None)
    (loss, (stats, _)), grads = jax.jit(jax.value_and_grad(
        partial(loss_fn, train=True), has_aux=True))(
        state.params, state.batch_stats, batch, key)
    stats0 = _np(state.batch_stats)
    step = jax_train.make_train_step(model, tx, "crf", den, LAMB, None,
                                     grad_clip=5.0)
    new_state, metrics = step(state, batch, jnp.float32(sched.lr), key)
    return {"config": config, "lr": sched.lr, "params": _np(params),
            "stats0": stats0, "loss": float(loss), "grads": _np(grads),
            "stats": _np(stats),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "new_params": _np(new_state.params),
            "new_stats": _np(new_state.batch_stats)}


def test_train_step_matches_jax(jax_step):
    model = train.build_model(_port_config(jax_step["config"]), V,
                              device="cpu")
    model.load_state_dict(joinap_state_dict(model, jax_step["params"],
                                            jax_step["stats0"]))
    den = DenseDen.from_ngram(train_ngram(_seqs(), order=3), V)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model.train()
    loss, _ = train.make_loss_fn(model, "crf", den, LAMB)(batch, None, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-4)
    want = joinap_state_dict(model, jax_step["grads"], jax_step["stats"])
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name].numpy(), err_msg=name,
                                   **TOL)

    model.load_state_dict(joinap_state_dict(model, jax_step["params"],
                                            jax_step["stats0"]))
    sched, opt = build_scheduler(SCHED, model.parameters())
    step = train.make_train_step(model, opt, "crf", den, LAMB, None,
                                 grad_clip=5.0)
    _, metrics = step(train.init_state(model, opt), batch, sched.lr,
                      torch.Generator().manual_seed(0))
    m = jax_step["metrics"]
    assert metrics["skipped"] == m["skipped"] == 0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), m[k], rtol=1e-4)
    # Adam's first step moves a weight by lr·g / (|g| + 1e-8), g the
    # clipped gradient: where g is rounding noise in either package (the
    # depthwise bias under batch norm, the key bias under the softmax) the
    # step follows the noise, so such weights are held to a step within
    # lr; every other gradient must agree in sign
    clip = min(1.0, 5.0 / (m["grad_norm"] + 1e-6))
    new = joinap_state_dict(model, jax_step["new_params"],
                            jax_step["new_stats"])
    old = joinap_state_dict(model, jax_step["params"], jax_step["stats0"])
    lr = jax_step["lr"]
    for name, p in model.state_dict().items():
        p, w = p.detach().numpy(), new[name].numpy()
        if name not in grads:
            np.testing.assert_allclose(p, w, err_msg=name, **TOL)
            continue
        gp, gj = grads[name] * clip, want[name].numpy() * clip
        noisy = np.maximum(np.abs(gp), np.abs(gj)) <= NOISE
        assert (np.sign(gp) == np.sign(gj))[~noisy].all(), name
        np.testing.assert_allclose(p[~noisy], w[~noisy], err_msg=name, **TOL)
        for q in (p, w):
            assert (np.abs(q - old[name].numpy())[noisy]
                    <= lr * (1 + 1e-4)).all(), name


def test_a_jax_checkpoint_gives_jax_logits(pv_path, tmp_path):
    config = _config("JoinAPLinearEncoder", "conformer", pv_path,
                     scan_layers=True)
    jm = jax_train.build_model(config, V)
    _, tx = jax_build_scheduler(SCHED)
    state = jax_train.init_state(jm, tx, F, jax.random.PRNGKey(5))
    params, stats = _jax_variables(jm, 5)
    state = state.replace(params=params, batch_stats=stats)
    cm = JaxCkpt(str(tmp_path / "check"))
    path = cm.path(cm.save({"state": state}, 1.0, 1, 1))
    want, _ = jax.jit(partial(jm.apply, deterministic=True))(
        {"params": params, "batch_stats": stats}, _feats(), LENGTHS)
    model = train.build_model(_port_config(config), V, device="cpu")
    model.load_state_dict(model_weights(model, path))
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(_feats()),
                             torch.from_numpy(LENGTHS))
    valid = np.arange(got.shape[1])[None, :] < got_len.numpy()[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **LOGIT_TOL)
    # a port checkpoint of another model holds the same weights: the two
    # average
    other = train.build_model(_port_config(config), V, device="cpu", seed=1)
    port_path = str(tmp_path / "port.ckpt")
    save_checkpoint(port_path, {"state": {"model": other.state_dict()}})
    mean = average_checkpoints([path, port_path], model)
    jax_sd = model_weights(model, path)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(
            mean[k], ((jax_sd[k].double() + v.double()) / 2).float(),
            rtol=0, atol=0)


def test_p_rows_must_equal_num_classes(pv_path):
    config = _port_config(_config("JoinAPLinearEncoder", "lstm", pv_path))
    with pytest.raises(ValueError, match="num_classes 9"):
        train.build_model(config, V + 1, device="cpu")
