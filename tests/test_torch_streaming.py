"""Port parity for CUSIDE streaming (`cat_tpu_torch.ctc.streaming`) and the
unified CTC trainer (`cat_tpu_torch.ctc.train_unified`) against
`cat_tpu.ctc.streaming` and `cat_tpu.ctc.train_unified`, in float32 on the
CPU, inputs drawn with numpy from fixed seeds.

- `make_chunks`: the windows of JAX's, exactly, at the left edge, the
  right edge, a T that is no multiple of the chunk and a T shorter than
  one chunk.
- `SimuNet` through `unified_state_dict` (flax's `GRUCell` as
  `torch.nn.GRU` with b_hr = b_hz = 0) on chunks of frames.
- `full_forward` and `chunk_forward` with future "simu", "none" and
  "real", on a 2-cell conformer (d = 32, chunk 8/8/4: r = 20 // 4 = 5,
  one output frame a chunk) and on a BLSTM (r = 1): the outputs, the
  out_lengths (min(ceil(len / r), C·width)) and simu_l1; `chunk_infer`.
- One unified CTC train step at dropout 0 without SpecAugment against
  JAX's `make_train_step`: the joint loss and its three terms, the
  gradient norm, every gradient, the updated weights; the running
  statistics are the chunk pass's alone (the step's buffers equal those
  of the chunk pass run alone from the start, and differ from the full
  pass's); the eval step. `loss_type` "crf" trains the same CTC step
  (ROADMAP.md C.13). A non-finite loss is not skipped, as in JAX.
Tolerance: rtol 1e-4, atol 1e-4 unless stated.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc import streaming as jax_streaming
from cat_tpu.ctc import train_unified as jax_unified
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.ctc import streaming, train_unified
from cat_tpu_torch.utils.from_jax import unified_state_dict
from cat_tpu_torch.utils.scheduler import build_scheduler
from tests.test_torch_rnnt_train import _compare_update
from tests.test_torch_transducer import SCHED, TOL, _np_tree, _perturbed

torch.set_num_threads(2)
V, FEAT = 7, 16
UNIFIED = {"chunk": 8, "left_context": 8, "right_context": 4,
           "feat_dim": FEAT, "simu_hidden": 8}
ENCODERS = {
    "conformer": {"type": "ConformerNet",
                  "kwargs": dict(num_cells=2, hdim=32, num_heads=2,
                                 kernel_size=5, dropout_rate=0.0)},
    "blstm": {"type": "LSTM",
              "kwargs": dict(hdim=8, num_layers=1, bidirectional=True,
                             dropout_rate=0.0)}}


def cfg(encoder="conformer"):
    return {"encoder": ENCODERS[encoder], "unified": dict(UNIFIED),
            "scheduler": SCHED}


def port_cfg(c):
    """The config with the port's own `idim`."""
    out = dict(c, encoder=dict(c["encoder"]))
    out["encoder"]["kwargs"] = dict(c["encoder"]["kwargs"], idim=FEAT)
    return out


def batch(seed=0, labels_max=3):
    rng = np.random.default_rng(seed)
    flens = np.array([60, 47, 33], np.int32)
    feats = rng.standard_normal((3, 60, FEAT)).astype(np.float32)
    feats *= np.arange(60)[None, :, None] < flens[:, None, None]
    llens = np.array([labels_max, 2, 1], np.int32)
    labels = rng.integers(1, V, (3, labels_max)).astype(np.int32)
    labels *= np.arange(labels_max)[None, :] < llens[:, None]
    return {"feats": feats, "feat_lengths": flens, "labels": labels,
            "label_lengths": llens,
            "weight": rng.uniform(0.5, 2.0, 3).astype(np.float32)}


def torch_batch(seed=0):
    return {k: torch.from_numpy(v) for k, v in batch(seed).items()}


def jax_batch(seed=0):
    return {k: jnp.asarray(v) for k, v in batch(seed).items()}


@pytest.mark.parametrize("T,chunk,left,right", [
    (20, 8, 4, 2), (16, 8, 8, 4), (5, 8, 8, 4), (23, 4, 0, 3)])
def test_make_chunks_matches_jax(T, chunk, left, right):
    x = np.random.default_rng(T).standard_normal((2, T, 3)).astype(
        np.float32)
    want, want_c = jax_streaming.make_chunks(jnp.asarray(x), chunk, left,
                                             right)
    got, C = streaming.make_chunks(torch.from_numpy(x), chunk, left, right)
    assert C == want_c == -(-T // chunk)
    assert got.shape == (2, C, left + chunk + right, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the left edge is zero, the first chunk's frames are 0..chunk-1, the
    # right context past T is zero
    assert (got[:, 0, :left] == 0).all()
    n = min(chunk, T)
    np.testing.assert_array_equal(got[:, 0, left:left + n].numpy(),
                                  x[:, :n])
    past = C * chunk + right - T
    if past > 0:
        assert (got[:, -1, left + chunk + right - past:] == 0).all()


def _jax_model(c, seed=0):
    """The JAX UnifiedEncoder and its variables: init_state's weights
    perturbed, running statistics drawn positive."""
    model = jax_unified.build_model(c, V)
    _, tx = jax_build_scheduler(c["scheduler"])
    state = jax_unified.init_state(model, tx, FEAT, jax.random.PRNGKey(seed))
    params = _perturbed(state.params, seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(np.asarray(a)) + 0.5).astype(np.float32),
        state.batch_stats)
    return model, tx, state.replace(params=params, batch_stats=stats,
                                    opt_state=tx.init(params))


def _port_model(c, params, stats):
    model = train_unified.build_model(port_cfg(c), V, device="cpu")
    model.load_state_dict(unified_state_dict(model, params, stats))
    return model


@pytest.fixture(scope="module", params=sorted(ENCODERS))
def models(request):
    c = cfg(request.param)
    jm, _, state = _jax_model(c)
    params, stats = _np_tree(state.params), _np_tree(state.batch_stats)
    return c, jm, params, stats, _port_model(c, params, stats)


def test_simunet_matches_jax(models):
    _, jm, params, _, port = models
    x = np.random.default_rng(3).standard_normal((5, 8, FEAT)).astype(
        np.float32)
    want = jm.simu.apply({"params": params["simu"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.simu(torch.from_numpy(x))
    assert got.shape == (5, 4, FEAT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (port.simu.gru.bias_hh_l0[:16] == 0).all()


def _variables(params, stats):
    v = {"params": params}
    if stats:
        v["batch_stats"] = stats
    return v


@pytest.mark.parametrize("future", ["simu", "none", "real"])
def test_chunk_forward_matches_jax(models, future):
    c, jm, params, stats, port = models
    b = batch(1)
    want, want_len, want_l1 = jm.apply(
        _variables(params, stats), jnp.asarray(b["feats"]),
        jnp.asarray(b["feat_lengths"]), deterministic=True,
        method=jm.chunk_forward, future=future)
    port.eval()
    with torch.no_grad():
        got, got_len, l1 = port.chunk_forward(
            torch.from_numpy(b["feats"]), torch.from_numpy(b["feat_lengths"]),
            future=future)
    C = 8  # ceil(60 / 8)
    r = 5 if c["encoder"]["type"] == "ConformerNet" else 1
    width = 8 // r
    assert got.shape[1] == C * width
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(
        got_len.numpy(), np.minimum(-(-b["feat_lengths"] // r), C * width))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(l1), float(want_l1), rtol=1e-5,
                               atol=1e-7)
    assert (float(l1) > 0) == (future == "simu")
    out, out_len = streaming.chunk_infer(
        port, torch.from_numpy(b["feats"]),
        torch.from_numpy(b["feat_lengths"]), future)
    want_out, want_out_len = jax_streaming.chunk_infer(
        jm, _variables(params, stats), jnp.asarray(b["feats"]),
        jnp.asarray(b["feat_lengths"]), future)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(want_out_len))


def test_full_forward_matches_jax(models):
    _, jm, params, stats, port = models
    b = batch(2)
    want, want_len = jm.apply(
        _variables(params, stats), jnp.asarray(b["feats"]),
        jnp.asarray(b["feat_lengths"]), deterministic=True,
        method=jm.full_forward)
    port.eval()
    with torch.no_grad():
        got, got_len = port(torch.from_numpy(b["feats"]),
                            torch.from_numpy(b["feat_lengths"]))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's unified CTC loss, gradients, train step and eval step on the
    conformer model, as numpy trees."""
    c = cfg("conformer")
    jm, tx, state = _jax_model(c)
    sched, _ = jax_build_scheduler(c["scheduler"])
    b = jax_batch()
    loss_fn = jax_streaming.make_unified_loss_fn(jm)
    (loss, (stats, lf, lc, l1)), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, state.batch_stats, b, jax.random.PRNGKey(0),
                          True), has_aux=True))(state.params)
    ev = jax_unified.make_eval_step(jm)(state, b)
    params0, stats0 = _np_tree(state.params), _np_tree(state.batch_stats)
    new_state, metrics = jax_unified.make_train_step(jm, tx, grad_clip=5.0)(
        state, b, jnp.float32(sched.lr), jax.random.PRNGKey(0))
    return {"cfg": c, "lr": sched.lr, "params": params0, "stats0": stats0,
            "loss": [float(x) for x in (loss, lf, lc, l1)],
            "grads": _np_tree(grads), "stats": _np_tree(stats),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "eval": {k: float(v) for k, v in ev.items()},
            "new_params": _np_tree(new_state.params),
            "new_stats": _np_tree(new_state.batch_stats)}


def test_unified_ctc_gradients_match_jax(jax_step):
    port = _port_model(jax_step["cfg"], jax_step["params"],
                       jax_step["stats0"])
    port.train()
    loss, terms = streaming.make_unified_loss_fn(port)(torch_batch(), None,
                                                       True)
    loss.backward()
    np.testing.assert_allclose([loss.item()] + [t.item() for t in terms],
                               jax_step["loss"], rtol=1e-4)
    want = unified_state_dict(port, jax_step["grads"], jax_step["stats"])
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    for name, b in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(),
                                       err_msg=name, **TOL)


def test_unified_ctc_step_matches_jax(jax_step):
    port = _port_model(jax_step["cfg"], jax_step["params"],
                       jax_step["stats0"])
    sched, opt = build_scheduler(SCHED, port.parameters())
    assert sched.lr == jax_step["lr"]
    step = train_unified.make_train_step(port, opt, grad_clip=5.0)
    _, m = step(train_unified.init_state(port, opt), torch_batch(), sched.lr,
                torch.Generator().manual_seed(0))
    want = jax_step["metrics"]
    for k in ("loss", "loss_full", "loss_chunk", "loss_simu", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), want[k], rtol=1e-4,
                                   err_msg=k)
    assert want["grad_norm"] > 5.0  # the clipping was exercised
    clip = min(1.0, 5.0 / (want["grad_norm"] + 1e-6))
    g_jax = unified_state_dict(port, jax_step["grads"], jax_step["stats"])
    _compare_update(port, {n: p.grad.numpy() for n, p in
                           port.named_parameters()},
                    {n: g_jax[n].numpy() * clip for n in g_jax},
                    unified_state_dict(port, jax_step["params"],
                                       jax_step["stats0"]),
                    unified_state_dict(port, jax_step["new_params"],
                                       jax_step["new_stats"]),
                    jax_step["lr"])


def test_running_statistics_are_the_chunk_pass_s(jax_step):
    """The step keeps the chunk pass's update of the start statistics:
    equal to the chunk pass run alone in training mode, unlike the full
    pass's."""
    c = jax_step["cfg"]
    b = torch_batch()
    after = {}
    for what in ("step", "chunk", "full"):
        port = _port_model(c, jax_step["params"], jax_step["stats0"])
        if what == "step":
            _, opt = build_scheduler(SCHED, port.parameters())
            train_unified.make_train_step(port, opt)(
                train_unified.init_state(port, opt), b, 1e-3, None)
        else:
            port.train()
            with torch.no_grad():
                getattr(port, f"{what}_forward")(b["feats"],
                                                 b["feat_lengths"])
        after[what] = {n: t.clone() for n, t in port.named_buffers()
                       if n.endswith(("running_mean", "running_var"))}
    assert after["step"]
    for name, t in after["step"].items():
        torch.testing.assert_close(t, after["chunk"][name], rtol=0, atol=0)
        assert not torch.allclose(t, after["full"][name]), name


def test_unified_ctc_eval_step_matches_jax(jax_step):
    port = _port_model(jax_step["cfg"], jax_step["params"],
                       jax_step["stats0"])
    got = train_unified.make_eval_step(port)(None, torch_batch())
    np.testing.assert_allclose(got["loss_sum"].item(),
                               jax_step["eval"]["loss_sum"], rtol=1e-4)
    np.testing.assert_allclose(got["count"].item(),
                               jax_step["eval"]["count"], rtol=1e-6)


def test_crf_config_trains_ctc_and_nothing_is_skipped(jax_step):
    """loss_type, den and lamb are ignored (C.13); the step has no NaN/Inf
    guard: a non-finite loss still steps the optimizer."""
    b = torch_batch()
    ms = []
    for kw in ({}, {"loss_type": "crf", "den": object(), "lamb": 0.5}):
        port = _port_model(jax_step["cfg"], jax_step["params"],
                           jax_step["stats0"])
        _, opt = build_scheduler(SCHED, port.parameters())
        ms.append(train_unified.make_train_step(port, opt, **kw)(
            train_unified.init_state(port, opt), b, 1e-3, None)[1])
    assert ms[0]["loss"].item() == ms[1]["loss"].item()
    port = _port_model(jax_step["cfg"], jax_step["params"],
                       jax_step["stats0"])
    _, opt = build_scheduler(SCHED, port.parameters())
    bad = dict(b, feats=b["feats"].clone())
    bad["feats"][0, 3, 2] = float("nan")
    state, m = train_unified.make_train_step(port, opt)(
        train_unified.init_state(port, opt), bad, 1e-3, None)
    assert not torch.isfinite(m["loss"]) and m["skipped"] == 0
    assert state.step == 1 and state.skipped == 0
    assert any(not torch.isfinite(p).all() for p in port.parameters())
