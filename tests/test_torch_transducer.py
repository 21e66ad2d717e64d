"""Port parity for the RNN-T model, in float32 on the CPU.

- `LSTMPredictor`: the full-sequence pass against the step-by-step one
  (1e-6), and against the JAX module (2 layers, edim != hdim).
- `JointNet` ("add", "cat", relu), `HAT` (with `ilm_logp`) and `LogAdd`
  against the JAX modules, on lattice inputs and on decode-step rows.
- `transducer_state_dict` from both cell layouts (`scan_layers` on and
  off): the port's eval forward against the JAX model's logits.
- `make_eval_step` of a `LogAdd` transducer (the fused simple loss) and a
  `HAT` one (`joiner_normalized`) against `cat_tpu.rnnt.train`'s, with
  its Pallas lattice scans in interpret mode (`CAT_TPU_RNNT_IMPL=pallas`).
- `_append_eos` against JAX's; the predictor time mask (drawn from the
  step's generator, then applied to the predictor output); an unknown
  topo and an unported joiner raise.
The whole train step is in `test_torch_rnnt_train.py`, which shares this
file's model (CFG) and batches. Tolerance: rtol 1e-4, atol 1e-4 unless
stated.
"""
from functools import partial

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cat_tpu.models import decoders as jax_decoders
from cat_tpu.models import joiner as jax_joiner
from cat_tpu.rnnt import train as jax_train
from cat_tpu.utils.manager import TrainState
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.models import decoders, joiner
from cat_tpu_torch.ops.specaug import mask_time
from cat_tpu_torch.rnnt import train
from cat_tpu_torch.utils.from_jax import (joiner_state_dict,
                                          predictor_state_dict,
                                          transducer_state_dict)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
V = 12
ENC_KW = dict(num_cells=2, hdim=64, num_heads=4, kernel_size=7,
              dropout_rate=0.0)
CFG = {"encoder": {"type": "ConformerNet", "kwargs": ENC_KW},
       "predictor": {"type": "LSTMPredictor",
                     "kwargs": {"hdim": 32, "num_layers": 2}},
       "joiner": {"type": "JointNet",
                  "kwargs": {"hdim": 32, "join_mode": "add"}}}
SCHED = {"type": "SchedulerNoam",
         "kwargs": {"dim_model": 64, "warmup_step": 100, "stop_step": 1000,
                    "peak_factor": 5.0},
         "optimizer": {"type": "Adam",
                       "kwargs": {"lr": 1e-3, "betas": [0.9, 0.98]}}}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape))
        .astype(np.float32), tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    flens = np.array([60, 47, 33], np.int32)
    feats = rng.standard_normal((3, 60, 80)).astype(np.float32)
    feats *= (np.arange(60)[None, :, None] < flens[:, None, None])
    llens = np.array([5, 3, 0], np.int32) if seed == 0 else \
        np.array([4, 5, 2], np.int32)
    labels = rng.integers(1, V, (3, 5)).astype(np.int32)
    labels *= np.arange(5)[None, :] < llens[:, None]
    return {"feats": feats, "feat_lengths": flens, "labels": labels,
            "label_lengths": llens,
            "weight": rng.uniform(0.5, 2.0, 3).astype(np.float32)}


def _torch_batch(seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


def test_lstm_predictor_matches_jax_and_its_steps():
    rng = np.random.default_rng(0)
    jm = jax_decoders.LSTMPredictor(vocab_size=V, hdim=16, num_layers=2,
                                    edim=8)
    tokens = rng.integers(0, V, (3, 7)).astype(np.int32)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), tokens)["params"], 1,
                        0.3)
    want, _ = jm.apply({"params": params}, tokens)
    port = decoders.LSTMPredictor(V, hdim=16, num_layers=2, edim=8)
    port.load_state_dict(predictor_state_dict(params))
    got, _ = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    state = port.init_state(3)
    for u in range(tokens.shape[1]):
        out, state = port.step(torch.from_numpy(tokens[:, u]), state)
        torch.testing.assert_close(out, got[:, u], rtol=1e-6, atol=1e-6)
    j_state = jm.init_state(3)
    j_out, _ = jm.apply({"params": params}, jnp.asarray(tokens[:, 0]),
                        j_state, method=jm.step)
    np.testing.assert_allclose(got[:, 0].detach().numpy(), np.asarray(j_out),
                               **TOL)


JOINERS = {"add": (jax_joiner.JointNet, joiner.JointNet,
                   dict(hdim=16, join_mode="add")),
           "cat": (jax_joiner.JointNet, joiner.JointNet,
                   dict(hdim=16, join_mode="cat")),
           "relu": (jax_joiner.JointNet, joiner.JointNet,
                    dict(hdim=16, join_mode="add", act="relu")),
           "hat": (jax_joiner.HAT, joiner.HAT, dict(hdim=16)),
           "logadd": (jax_joiner.LogAdd, joiner.LogAdd, {})}


@pytest.mark.parametrize("name", sorted(JOINERS))
def test_joiners_match_jax(name):
    jcls, pcls, kw = JOINERS[name]
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 5, 24)).astype(np.float32)
    pred = rng.standard_normal((2, 4, 20)).astype(np.float32)
    jm = jcls(odim=V, **kw)
    params = _perturbed(jm.init(jax.random.PRNGKey(1), enc, pred)["params"],
                        3, 0.2)
    port = pcls(V, **kw, denc=24, dpred=20)
    port.load_state_dict(joiner_state_dict(params))
    te, tp = torch.from_numpy(enc), torch.from_numpy(pred)
    for args, targs in (((enc, pred), (te, tp)),
                        ((enc[:, 2], pred[:, 1]), (te[:, 2], tp[:, 1]))):
        want = jm.apply({"params": params}, *args)
        got = port(*targs)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **TOL)
    if name == "hat":
        # the JAX `HAT.ilm_logp` defines its layers outside `@compact` and
        # cannot be applied, so its formula is written out on its params
        fp, fo = params["fc_pred"], params["fc_out"]
        h = np.tanh(pred @ fp["kernel"] + fp["bias"])
        want = jax.nn.log_softmax((h @ fo["kernel"] + fo["bias"])[..., 1:], -1)
        np.testing.assert_allclose(port.ilm_logp(tp).detach().numpy(),
                                   np.asarray(want), **TOL)


def jax_variables(model, seed):
    """Random (params, batch_stats) of a JAX TransducerModel, shaped by
    tracing its `init` (no compile): matrices normal with variance
    1/fan_in, vectors 0.1-normal (norm scales around 1), running
    variances around 1."""
    shapes = jax.eval_shape(
        partial(model.init, deterministic=True), jax.random.PRNGKey(0),
        jnp.zeros((2, 16, 80)), jnp.array([16, 16]),
        jnp.zeros((2, 4), jnp.int32), jnp.array([4, 4]))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1])
        x = rng.standard_normal(s.shape)
        # stacked cells (`scan_layers`) carry a leading cells axis
        shape = s.shape[1:] if "'cells'" in str(path) else s.shape
        if len(shape) >= 2:
            x /= np.sqrt(np.prod(shape[:-1]))
        else:
            x *= 0.1
            if "var" in name:
                x = 1 + np.abs(x)
            elif "scale" in name:
                x = 1 + x
        return x.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v.get("batch_stats", {})


def _jax_init(cfg, seed=3, wrap=lambda tx: tx):
    """(model, scheduler, tx, TrainState) with random variables; `wrap`
    wraps the optimizer (gradient accumulation)."""
    model = jax_train.build_model(cfg, V)
    sched, tx = jax_build_scheduler(SCHED)
    tx = wrap(tx)
    params, stats = jax_variables(model, seed)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params), step=jnp.asarray(0))
    return model, sched, tx, state


@pytest.mark.parametrize("scan_layers", [False, True])
def test_transducer_state_dict_both_layouts(scan_layers):
    cfg = dict(CFG, encoder={"type": "ConformerNet",
                             "kwargs": dict(ENC_KW, scan_layers=scan_layers)})
    model, _, _, state = _jax_init(cfg)
    params = _perturbed(state.params, 4)
    stats = jax.tree_util.tree_map(lambda a: np.abs(np.asarray(a)) + 0.5,
                                   state.batch_stats)
    b = _batch()
    want, want_len = jax.jit(partial(model.apply, deterministic=True))(
        {"params": params, "batch_stats": stats}, b["feats"],
        b["feat_lengths"], b["labels"], b["label_lengths"])
    port = train.build_model(cfg, V, device="cpu")
    port.load_state_dict(transducer_state_dict(params, stats))
    with torch.no_grad():
        got, got_len = port(*(torch.from_numpy(b[k]) for k in (
            "feats", "feat_lengths", "labels", "label_lengths")))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == (3, 14, 6, V) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_options_raise():
    """An unknown topo raises (the monotonic "rna" and "ctct" are ported,
    `test_torch_rnnt_rna.py`); so does an unported joiner."""
    model = train.build_model(CFG, V, device="cpu")
    with pytest.raises(ValueError, match="topo"):
        train.make_loss_fn(model, topo="bogus")
    for topo in ("rna", "ctct"):
        train.make_loss_fn(model, topo=topo)
    bad = dict(CFG, joiner={"type": "Bogus", "kwargs": {}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.build_model(bad, V, device="cpu")


@pytest.mark.parametrize("joiner_type", ["LogAdd", "HAT"])
def test_eval_loss_of_other_joiners_matches_jax(monkeypatch, joiner_type):
    monkeypatch.setenv("CAT_TPU_RNNT_IMPL", "pallas")
    cfg = {"encoder": {"type": "ConformerNet",
                       "kwargs": dict(num_cells=1, hdim=32, num_heads=2,
                                      kernel_size=7, dropout_rate=0.0)},
           "predictor": {"type": "LSTMPredictor", "kwargs": {"hdim": 16}},
           "joiner": {"type": joiner_type,
                      "kwargs": {} if joiner_type == "LogAdd"
                      else {"hdim": 16}}}
    normalized = joiner_type == "HAT"
    model, _, _, state = _jax_init(cfg)
    state = state.replace(params=_perturbed(state.params, 5, 0.2))
    want = jax_train.make_eval_step(model, joiner_normalized=normalized)(
        state, {k: jnp.asarray(v) for k, v in _batch(1).items()})
    port = train.build_model(cfg, V, device="cpu")
    port.load_state_dict(transducer_state_dict(_np_tree(state.params),
                                               _np_tree(state.batch_stats)))
    got = train.make_eval_step(port, joiner_normalized=normalized)(
        None, _torch_batch(1))
    assert np.isfinite(got["loss_sum"].item())
    np.testing.assert_allclose(got["loss_sum"].item(),
                               float(want["loss_sum"]), rtol=1e-4)


def test_append_eos_matches_jax():
    labels = np.array([[3, 4, 0], [5, 0, 0], [0, 0, 0]], np.int32)
    llens = np.array([2, 1, 0], np.int32)
    want = jax_train._append_eos(jnp.asarray(labels), jnp.asarray(llens), 11)
    got = train._append_eos(torch.from_numpy(labels).long(),
                            torch.from_numpy(llens).long(), 11)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_predictor_mask_is_drawn_and_applied():
    """In training mode with num_predictor_mask > 0 the joiner sees the
    predictor output with the masks drawn first from the step's
    generator (dropout 0 draws nothing): widths <= floor(range · (U_n +
    1)), the masked rows zero."""
    cfg = dict(CFG, trainer={"num_predictor_mask": 2,
                             "predictor_mask_range": 0.5})
    model = train.build_model(cfg, V, device="cpu").train()
    b = _torch_batch(1)
    labels, llens = b["labels"].long(), b["label_lengths"].long()
    with torch.no_grad():
        got, _ = model(b["feats"], b["feat_lengths"], labels, llens,
                       torch.Generator().manual_seed(3))
        enc, _ = model.encoder(b["feats"], b["feat_lengths"])
        pred, _ = model.predictor(F.pad(labels, (1, 0)), llens + 1)
        starts, widths = model.draw_predictor_masks(
            torch.Generator().manual_seed(3), llens + 1, pred.shape[1])
        masked = mask_time(pred, starts, widths)
        want = model.joiner(enc, masked)
    assert (widths <= ((llens[:, None] + 1) * 0.5).floor()).all()
    assert (masked == 0).all(-1).any() and not torch.equal(masked, pred)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
