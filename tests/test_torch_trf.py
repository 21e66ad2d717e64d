"""Port parity of the TRF LMs (`cat_tpu_torch/lm/trf.py`,
`lm/train_trf.py`) against `cat_tpu.lm.trf` and `cat_tpu.lm.train_trf`:
the same JAX parameters, carried over by `from_jax.trf_state_dict`, on
seeded batches of the `LmLoader` convention, in float32.

- `hist_length` and `length_prior` exact;
- each energy function's E, φ, the noise LM's NLL, `rebm_score` and
  `trf_score` within 1e-5;
- the NCE and DNCE losses, their metrics and gradients within 1e-4 given
  JAX's own noise samples (drawn by JAX's `make_noise_sampler` with the
  keys its loss uses: the loss's key for NCE; `k1, rng = split(rng)` for
  the data-side mixture, when it has samples, and then `k2, rng =
  split(rng)` for the noise side in DNCE);
- the port's sampler on its own terms (its draws cannot match
  `jax.random`'s): lengths in [1, max_len - 1], <s> first, targets the
  inputs shifted, and log_pn the drawn tokens' log-probs under the noise
  LM's full pass plus log π[length] (without the </s> term, as JAX's
  sampler); the same generator state draws the same samples;
- the train step and the eval step (its fixed noise seed) of
  `train_trf`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.lm import train_trf as jtt
from cat_tpu.lm import trf as jtrf
from cat_tpu.utils import data as jdata
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.lm import train_trf as ptt
from cat_tpu_torch.lm import trf as ptrf
from cat_tpu_torch.utils import data as pdata
from cat_tpu_torch.utils.from_jax import model_state_dict
from cat_tpu_torch.utils.scheduler import build_scheduler

V = 9
MAX_LEN = 16
SCHED = {"type": "SchedulerFixedStop", "kwargs": {"stop_step": 100},
         "optimizer": {"type": "Adam", "kwargs": {"lr": 3e-3}}}


def config(energy="sumtargetlogit", method="nce", **kw):
    return {"decoder": {"type": "TRFNCE", "kwargs": {
        "energy_func": energy, "method": method, "noise_rate": 1.0,
        "alpha": 0.5, "noise_max_len": 10, "max_len": MAX_LEN,
        "ebm": {"type": "LSTMPredictor", "kwargs": {"hdim": 8}},
        "noise": {"type": "LSTMPredictor", "kwargs": {"hdim": 6}}, **kw}},
        "scheduler": SCHED}


def batch(seed, N=5, U=9):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((N, U), np.int32)
    targets = np.zeros((N, U), np.int32)
    lens = rng.integers(1, U + 1, N).astype(np.int32)
    lens[0] = U
    for n, L in enumerate(lens):
        ids = rng.integers(1, V, L - 1)
        tokens[n, 1:L] = ids
        targets[n, :L - 1] = ids
    return dict(tokens=tokens, targets=targets, lengths=lens)


def jnp_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in b.items()}


def models_of(cfg):
    jmodel = jtt.build_model(cfg, num_classes=V)
    _, tx = jax_build_scheduler(SCHED)
    jstate = jtt.init_state(jmodel, tx, jax.random.PRNGKey(7))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    pmodel = ptt.build_model(cfg, num_classes=V, device="cpu")
    sd = model_state_dict(pmodel, params, {})
    assert set(sd) == set(pmodel.state_dict())
    pmodel.load_state_dict(sd)
    return jmodel, params, pmodel


def test_hist_length_and_length_prior_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for lens, max_len in ((rng.integers(1, 30, 50), 20),
                          (rng.integers(1, 10, 7), 64)):
        want = jtrf.hist_length(lens, max_len)
        got = ptrf.hist_length(lens, max_len)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    seqs = [[int(x) for x in rng.integers(1, V, int(rng.integers(0, 25)))]
            for _ in range(40)]
    pdata.pack_corpus(str(tmp_path), seqs)
    np.testing.assert_array_equal(
        ptt.length_prior(pdata.CorpusDataset(str(tmp_path)), 20),
        jtt.length_prior(jdata.CorpusDataset(str(tmp_path)), 20))


@pytest.mark.parametrize("energy", ptrf.ENERGY_FUNCS)
def test_energy_phi_and_scores_match_jax(energy):
    cfg = config(energy)
    jmodel, params, pmodel = models_of(cfg)
    assert (pmodel.energy_lin is not None) == (energy == "hidden2scalar")
    b = batch(1)
    jb, tb = jnp_batch(b), torch_batch(b)
    args = (jb["tokens"], jb["targets"], jb["lengths"])
    targs = (tb["tokens"], tb["targets"], tb["lengths"])
    v = {"params": params}
    pi = jtrf.hist_length(np.asarray([2, 3, 3, 5, 8]), MAX_LEN)
    with torch.no_grad():
        for name, want, got in (
                ("energy", jmodel.apply(v, *args, method=jmodel.energy),
                 pmodel.energy(*targs)),
                ("phi", jmodel.apply(v, *args, method=jmodel.phi),
                 pmodel.phi(*targs)),
                ("noise_nll", jmodel.apply(v, *args,
                                           method=jmodel.noise_nll),
                 pmodel.noise_nll(*targs)),
                ("rebm", jtrf.rebm_score(jmodel, params, *args),
                 ptrf.rebm_score(pmodel, *targs)),
                ("trf", jtrf.trf_score(jmodel, params, pi, *args),
                 ptrf.trf_score(pmodel, pi, *targs))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def _jax_samples(jmodel, params, pi, method, B, rng, opts):
    n = max(int(B * opts["noise_rate"]), 1)
    sampler = lambda k: jtrf.make_noise_sampler(
        jmodel, k, opts["max_len"], pi)
    as_torch = lambda s: tuple(torch.from_numpy(np.asarray(x)).long()
                               if np.asarray(x).dtype.kind == "i"
                               else torch.from_numpy(np.asarray(x))
                               for x in s)
    if method == "nce":
        return {"noise": as_torch(sampler(n)(params, rng))}
    a = opts["alpha"]
    out = {}
    n_in = int(B * (1.0 - a) / a) if a < 1.0 else 0
    if n_in > 0:  # JAX splits k1 off only when the mixture has samples
        k1, rng = jax.random.split(rng)
        out["data"] = as_torch(sampler(n_in)(params, k1))
    k2, rng = jax.random.split(rng)
    out["noise"] = as_torch(sampler(max(int(B * opts["noise_rate"] / a),
                                        1))(params, k2))
    return out


@pytest.mark.parametrize("method,energy,alpha", [
    ("nce", "sumtargetlogit", 0.5), ("nce", "hidden2scalar", 0.5),
    ("dnce", "sumtargetlogit", 0.5), ("dnce", "sumtokenlogit", 0.25),
    ("dnce", "logsumexplogit", 1.0)])
def test_trf_loss_metrics_and_grads_match_jax(method, energy, alpha):
    cfg = config(energy, method, alpha=alpha)
    jmodel, params, pmodel = models_of(cfg)
    opts = jtt.loss_options(cfg)
    assert opts == ptt.loss_options(cfg)
    pi = jtrf.hist_length(np.asarray([2, 3, 3, 5, 8, 9, 4]), MAX_LEN)
    b = batch(2)
    rng = jax.random.PRNGKey(11)
    jloss = jtrf.make_trf_loss(jmodel, pi, **opts)
    (want, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params, jnp_batch(b), rng)
    samples = _jax_samples(jmodel, params, pi, method, 5, rng, opts)
    pmodel.train()
    loss, pm = ptrf.make_trf_loss(pmodel, pi, **opts)(
        torch_batch(b), torch.Generator().manual_seed(0), samples)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4,
                               atol=1e-5)
    assert pm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want_g = model_state_dict(pmodel, jax.tree_util.tree_map(np.asarray,
                                                             jgrads), {})
    for name, p in pmodel.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want_g[name]
        if float(w.norm()) < 1e-7:
            assert float(g.abs().max()) < 1e-6, name
            continue
        err = float((g - w).norm() / w.norm())
        assert err <= 1e-4, (name, err)
    noise_grads = [p.grad for n, p in pmodel.named_parameters()
                   if n.startswith("noise_model.")]
    assert all(g is None for g in noise_grads) == (method == "nce")


@pytest.mark.parametrize("greedy", [False, True])
def test_noise_sampler_is_self_consistent(greedy):
    _, _, pmodel = models_of(config())
    pi = ptrf.hist_length(np.asarray([1, 2, 3, 3, 4, 6, 12, 20]), MAX_LEN)
    max_len = 10
    sample = ptrf.make_noise_sampler(pmodel, 64, max_len, pi, greedy)
    tokens, targets, lens, log_pn = sample(torch.Generator().manual_seed(3))
    assert tokens.shape == targets.shape == (64, max_len)
    assert int(lens.min()) >= 1 and int(lens.max()) <= max_len - 1
    assert len(set(lens.tolist())) > 3
    assert (tokens[:, 0] == 0).all()
    assert torch.equal(tokens[:, 1:], targets[:, :-1])
    U = torch.arange(max_len)[None, :]
    assert (tokens[U >= lens[:, None]] == 0).all()
    with torch.no_grad():
        logits, _ = pmodel.noise_model(tokens, lens)
    lp = torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    drawn = torch.where(U < (lens - 1)[:, None], lp, 0.0).sum(1)
    log_pi = torch.log(torch.from_numpy(pi) + ptrf.EPS)
    np.testing.assert_allclose(log_pn.numpy(),
                               (drawn + log_pi[lens]).numpy(), rtol=1e-5,
                               atol=1e-5)
    again = sample(torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(again,
                                                 (tokens, targets, lens,
                                                  log_pn)))
    if greedy:  # argmax: every sequence is the same greedy path
        assert (tokens[lens == lens.max()] == tokens[lens == lens.max()][0]
                ).all()


def test_train_and_eval_steps(tmp_path):
    cfg = config("sumtargetlogit", "dnce")
    _, _, pmodel = models_of(cfg)
    pi = ptrf.hist_length(np.asarray([2, 3, 5, 8, 9]), MAX_LEN)
    opts = ptt.loss_options(cfg)
    sched, opt = build_scheduler(SCHED, pmodel.parameters())
    state = ptt.init_state(pmodel, opt)
    step = ptt.make_train_step(pmodel, opt, pi, opts)
    evaluate = ptt.make_eval_step(pmodel, pi, opts)
    tb = torch_batch(batch(5))
    first = evaluate(state, tb)
    assert first["count"] == 5.0
    assert float(evaluate(state, tb)["loss_sum"]) == float(first["loss_sum"])
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, m = step(state, tb, 3e-3, gen)
        assert m["skipped"] == 0 and np.isfinite(float(m["loss"]))
        assert {"loss_data", "loss_noise", "loss_noise_kl"} <= set(m)
    assert state.step == 2
    moved = [k for k, v in pmodel.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any(k.startswith("noise_model.") for k in moved)
    assert any(k.startswith("udlying_nn.") for k in moved)
    assert not pmodel.noise_model.training
