"""Port parity for the CUSIDE unified transducer
(`cat_tpu_torch.rnnt.train_unified`) against `cat_tpu.rnnt.train_unified`,
in float32 on the CPU, inputs drawn with numpy from fixed seeds. The model:
a 2-cell, d = 32 conformer (chunk 8/8/4), a 16-wide LSTM predictor, and
either the LogAdd joiner (the fused simple loss, as aishell rnnt-cuside)
or an "add" JointNet with topo "rna" (the monotonic loss); V = 7, dropout
0, no SpecAugment, JAX's lattice scans in Pallas interpret mode
(`CAT_TPU_RNNT_IMPL=pallas`).

- One train step against JAX's `make_train_step`: the joint loss,
  loss_full, loss_chunk and loss_simu, the gradient norm, every gradient,
  the updated weights, and the running statistics (the chunk pass's).
- A fold-2 step (two micro-batches, `applied` 0 then 1) and the eval step.
- Streaming greedy and beam decoding (`streaming=True`: the chunk pass)
  against `cat_tpu.rnnt.decode`'s, and the decode CLI's `--mode streaming`
  on a JAX unified checkpoint written by the test.
Tolerance: rtol 1e-4, atol 1e-4 unless stated.
"""
import json
import os
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc.train import accum_tx as jax_accum_tx
from cat_tpu.rnnt import decode as jax_decode
from cat_tpu.rnnt import train_unified as jax_unified
from cat_tpu.utils.checkpoint import CheckpointManager
from cat_tpu.utils.data import pack_speech_data
from cat_tpu.utils.manager import TrainState
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu.utils.tokenizer import SimpleTokenizer
from cat_tpu_torch.rnnt import decode, train_unified
from cat_tpu_torch.utils.from_jax import unified_state_dict
from cat_tpu_torch.utils.scheduler import build_scheduler
from tests.test_torch_rnnt_train import _compare, _compare_update
from tests.test_torch_streaming import (FEAT, UNIFIED, V, jax_batch,
                                        port_cfg, torch_batch)
from tests.test_torch_transducer import SCHED, _np_tree, _perturbed

torch.set_num_threads(2)
ENC = {"type": "ConformerNet",
       "kwargs": dict(num_cells=2, hdim=32, num_heads=2, kernel_size=5,
                      dropout_rate=0.0)}
JOINERS = {"logadd": ({"type": "LogAdd", "kwargs": {}}, "rnnt"),
           "rna": ({"type": "JointNet", "kwargs": {"hdim": 16}}, "rna")}


def cfg(joiner):
    j, topo = JOINERS[joiner]
    return {"encoder": ENC, "unified": dict(UNIFIED),
            "predictor": {"type": "LSTMPredictor",
                          "kwargs": {"hdim": 16, "num_layers": 1}},
            "joiner": j, "trainer": {"topo": topo}, "scheduler": SCHED}


def _jax_init(c, wrap=None):
    model = jax_unified.build_model(c, V)
    sched, tx = jax_build_scheduler(c["scheduler"])
    if wrap:
        tx = wrap(tx)
    state = jax_unified.init_state(model, tx, FEAT, jax.random.PRNGKey(0))
    params = _perturbed(state.params, 1)
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(np.asarray(a)) + 0.5).astype(np.float32),
        state.batch_stats)
    return model, sched, tx, state.replace(params=params, batch_stats=stats,
                                           opt_state=tx.init(params))


def _port(c, params, stats):
    model = train_unified.build_model(port_cfg(c), V, device="cpu")
    model.load_state_dict(unified_state_dict(model, params, stats))
    return model


@pytest.fixture(scope="module", params=sorted(JOINERS))
def jax_step(request):
    """JAX's loss, gradients, train step and eval step, as numpy trees."""
    c = cfg(request.param)
    topo = c["trainer"]["topo"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAT_TPU_RNNT_IMPL", "pallas")
        model, sched, tx, state = _jax_init(c)
        b = jax_batch()
        loss_fn = jax_unified.make_loss_fn(model, topo=topo)
        (loss, (stats, lf, lc, l1)), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, state.batch_stats, b, jax.random.PRNGKey(0),
                              True), has_aux=True))(state.params)
        ev = jax_unified.make_eval_step(model, topo=topo)(state, b)
        out = {"cfg": c, "topo": topo, "lr": sched.lr,
               "params": _np_tree(state.params),
               "stats0": _np_tree(state.batch_stats),
               "loss": [float(x) for x in (loss, lf, lc, l1)],
               "grads": _np_tree(grads), "stats": _np_tree(stats),
               "eval": {k: float(v) for k, v in ev.items()}}
        new_state, m = jax_unified.make_train_step(
            model, tx, grad_clip=5.0, topo=topo)(
            state, b, jnp.float32(sched.lr), jax.random.PRNGKey(0))
        out.update(metrics={k: float(v) for k, v in m.items()},
                   new_params=_np_tree(new_state.params),
                   new_stats=_np_tree(new_state.batch_stats))
    return out


def test_unified_gradients_match_jax(jax_step):
    port = _port(jax_step["cfg"], jax_step["params"], jax_step["stats0"])
    port.train()
    loss, _, terms = train_unified.make_loss_fn(port, topo=jax_step["topo"])(
        torch_batch(), None, True)
    loss.backward()
    np.testing.assert_allclose(
        [loss.item()] + [terms[k].item() for k in ("loss_full", "loss_chunk",
                                                   "loss_simu")],
        jax_step["loss"], rtol=1e-4)
    want = unified_state_dict(port, jax_step["grads"], jax_step["stats"])
    buffers = dict(port.named_buffers())
    _compare({n: p.grad.numpy() for n, p in port.named_parameters()},
             {n: t for n, t in want.items() if n not in buffers}, "grad")
    _compare({n: b.numpy() for n, b in buffers.items()},
             {n: t for n, t in want.items() if n in buffers}, "batch stats")


def test_unified_step_matches_jax(jax_step):
    port = _port(jax_step["cfg"], jax_step["params"], jax_step["stats0"])
    sched, opt = build_scheduler(SCHED, port.parameters())
    step = train_unified.make_train_step(port, opt, grad_clip=5.0,
                                         topo=jax_step["topo"])
    _, m = step(train_unified.init_state(port, opt), torch_batch(), sched.lr,
                torch.Generator().manual_seed(0))
    want = jax_step["metrics"]
    assert m["skipped"] == want["skipped"] == 0
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


def test_unified_eval_step_matches_jax(jax_step):
    port = _port(jax_step["cfg"], jax_step["params"], jax_step["stats0"])
    got = train_unified.make_eval_step(port, topo=jax_step["topo"])(
        None, torch_batch())
    np.testing.assert_allclose(got["loss_sum"].item(),
                               jax_step["eval"]["loss_sum"], rtol=1e-4)
    np.testing.assert_allclose(got["count"].item(),
                               jax_step["eval"]["count"], rtol=1e-6)


@pytest.fixture(scope="module")
def jax_fold():
    """JAX's fold-2 step (LogAdd) on micro-batches 0 and 1."""
    c = cfg("logadd")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAT_TPU_RNNT_IMPL", "pallas")
        model, sched, wrapped, state = _jax_init(
            c, wrap=lambda tx: jax_accum_tx(tx, 2, 5.0))
        out = {"cfg": c, "lr": sched.lr, "params": _np_tree(state.params),
               "stats0": _np_tree(state.batch_stats), "metrics": []}
        step = jax_unified.make_train_step(model, wrapped, grad_clip=5.0,
                                           grad_accum_fold=2)
        for i in range(2):
            state, m = step(state, jax_batch(i), jnp.float32(sched.lr),
                            jax.random.PRNGKey(i))
            out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params_after"] = _np_tree(state.params)
        out["stats_after"] = _np_tree(state.batch_stats)
    return out


def test_unified_fold2_step_matches_jax(jax_fold):
    port = _port(jax_fold["cfg"], jax_fold["params"], jax_fold["stats0"])
    sched, opt = build_scheduler(SCHED, port.parameters())
    step = train_unified.make_train_step(port, opt, grad_clip=5.0,
                                         grad_accum_fold=2)
    state = train_unified.init_state(port, opt)
    start = {n: t.clone() for n, t in port.named_parameters()}
    for i in range(2):
        state, m = step(state, torch_batch(i), sched.lr,
                        torch.Generator().manual_seed(0))
        want = jax_fold["metrics"][i]
        assert m["applied"] == want["applied"] == i
        np.testing.assert_allclose(m["loss"].item(), want["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), want["grad_norm"],
                                   rtol=1e-4)
        if i == 0:
            for name, p in port.named_parameters():
                assert torch.equal(p, start[name]), name
    after = unified_state_dict(port, jax_fold["params_after"],
                               jax_fold["stats_after"])
    got = port.state_dict()
    moved = 0
    for name, p in port.named_parameters():
        # Adam's first step: lr·g/(|g| + eps) per weight, so the weights
        # agree where the gradient is above rounding noise
        diff = np.abs(got[name].numpy() - after[name].numpy())
        assert (diff <= 1e-4 + 2 * jax_fold["lr"]).all(), name
        moved += int(not torch.equal(p, start[name]))
    assert moved > len(start) // 2
    for name, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), after[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def decode_models():
    """The LogAdd unified model with a sharper encoder projection and a
    raised blank, so that the searches both emit and skip."""
    c = cfg("logadd")
    model, _, _, state = _jax_init(c)
    params, stats = _np_tree(state.params), _np_tree(state.batch_stats)
    params["joiner"]["fc_enc"]["kernel"] *= 3.0
    params["joiner"]["fc_enc"]["bias"][0] += 1.0
    variables = {"params": params, "batch_stats": stats}
    return c, model, variables, _port(c, params, stats).eval()


def _feats(seed):
    b = jax_batch(seed)
    return np.array(b["feats"]), np.array(b["feat_lengths"])


def test_streaming_greedy_matches_jax(decode_models):
    _, model, variables, port = decode_models
    feats, flens = _feats(2)
    want_t, want_c = jax_decode.make_greedy_decoder(
        model, max_symbols=3, max_out=24, streaming=True)(variables, feats,
                                                          flens)
    got_t, got_c = decode.make_greedy_decoder(
        port, max_symbols=3, max_out=24, streaming=True)(feats, flens)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_c.max() > 0
    offline, _ = decode.make_greedy_decoder(port, max_symbols=3,
                                            max_out=24)(feats, flens)
    assert not torch.equal(offline, got_t)


def test_streaming_beam_matches_jax(decode_models):
    _, model, variables, port = decode_models
    feats, flens = _feats(3)
    want = jax_decode.RNNTBeamDecoder(model, variables, beam_width=4,
                                      streaming=True).decode(feats, flens,
                                                             nbest=3)
    got = decode.RNNTBeamDecoder(port, beam_width=4, streaming=True).decode(
        feats, flens, nbest=3)
    assert [[p for _, p in n] for n in got] == [[p for _, p in n]
                                                for n in want]
    np.testing.assert_allclose([[s for s, _ in n] for n in got],
                               [[s for s, _ in n] for n in want], rtol=1e-4)
    assert any(len(n[0][1]) for n in got)


def test_streaming_needs_a_unified_model(decode_models):
    from cat_tpu_torch.rnnt import train
    c = dict(port_cfg(cfg("logadd")))
    c.pop("unified")
    plain = train.build_model(c, V, device="cpu")
    for make in (decode.make_greedy_decoder, decode.RNNTBeamDecoder):
        with pytest.raises(ValueError, match="unified"):
            make(plain, streaming=True)


def test_decode_cli_streaming_matches_jax(tmp_path, decode_models):
    c, model, variables, _ = decode_models
    root = str(tmp_path)
    tok = SimpleTokenizer(list("abcde"), level="char")
    assert tok.vocab_size == V
    tok.save(os.path.join(root, "tokenizer.tknz"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(port_cfg(c), f)
    with open(os.path.join(root, "hyper-p.json"), "w") as f:
        json.dump({"tokenizer": {"file": "tokenizer.tknz"},
                   "train": {"bin": "cat_tpu.rnnt.train_unified"}}, f)
    feats, flens = _feats(4)
    utts = [(f"utt{i}", feats[i, :n], [2, 3]) for i, n in enumerate(flens)]
    pack_speech_data(os.path.join(root, "pkl", "dev"), utts)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    CheckpointManager(os.path.join(root, "check")).save(
        {"state": TrainState(params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]),
                             step=np.asarray(0))}, 1.0, 0, 0)
    out = tmp_path / "hyp.txt"
    decode.main([root, "--device", "cpu", "--mode", "streaming",
                 "--beam-width", "4", "--nbest", "2", "--output", str(out)])
    with open(str(out) + ".nbest.pkl", "rb") as f:
        nbest = pickle.load(f)
    beam = jax_decode.RNNTBeamDecoder(model, variables, beam_width=4,
                                      streaming=True)
    lines = []
    for uid, f, _ in utts:
        want = beam.decode(f[None], np.array([len(f)]), nbest=2)[0]
        lines.append(f"{uid}\t{tok.decode(want[0][1])}\n")
        assert [h for _, h in nbest[uid].values()] == [
            tok.decode(p) for _, p in want]
        np.testing.assert_allclose([s for s, _ in nbest[uid].values()],
                                   [s for s, _ in want], rtol=1e-4)
    assert out.read_text() == "".join(sorted(lines))
