"""Port parity of the neural LM trainer (`cat_tpu_torch/lm/train.py`),
the packed corpus (`utils/data.py`) and the fusion scorer
(`lm/scorer.py`) against `cat_tpu.lm.train`, `cat_tpu.utils.data` and
`cat_tpu.lm.scorer`, on seeded corpora, in float32:

- `pack_corpus` byte-equal, `CorpusDataset` items equal;
- `LmLoader` batches exactly JAX's over two epochs and two seeds;
- the masked CE loss and the eval step within 1e-5 relative; three Adam
  steps (clipping at 5, the scheduler's lr) from the same weights track
  JAX's parameters within 1e-4, for an LSTM and a transformer LM;
- `sentence_nll` and `perplexity` within 1e-5 relative;
- `NeuralLMScorer.logp` within 1e-5 of JAX's over contexts of lengths
  0-9; a repeated context is served from the cache (no forward).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.lm import scorer as jscorer
from cat_tpu.lm import train as jtrain
from cat_tpu.utils import data as jdata
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.lm import scorer as pscorer
from cat_tpu_torch.lm import train as ptrain
from cat_tpu_torch.utils import data as pdata
from cat_tpu_torch.utils.from_jax import model_state_dict
from cat_tpu_torch.utils.scheduler import build_scheduler

V = 11
SCHED = {"type": "SchedulerFixedStop", "kwargs": {"stop_step": 1000},
         "optimizer": {"type": "Adam", "kwargs": {"lr": 3e-3}}}
CONFIGS = {
    "lstm": {"decoder": {"type": "LSTMPredictor",
                         "kwargs": {"hdim": 12, "num_layers": 2}}},
    "transformer": {"decoder": {"type": "CausalTransformer", "kwargs": {
        "hdim": 16, "num_layers": 2, "num_heads": 2, "ff_dim": 32,
        "max_len": 64, "dropout_rate": 0.0}}},
}


def corpus(seed, n=60, lo=1, hi=20):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, V, int(rng.integers(lo, hi)))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    seqs = corpus(0)
    jdata.pack_corpus(str(root / "jax"), seqs)
    pdata.pack_corpus(str(root / "port"), seqs)
    return root, seqs


def test_pack_corpus_matches_jax(packed):
    root, seqs = packed
    with np.load(root / "jax" / "corpus.npz") as a, \
            np.load(root / "port" / "corpus.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ds = pdata.CorpusDataset(str(root / "jax"))
    assert len(ds) == len(seqs)
    assert all(list(ds[i]) == s and ds.token_length(i) == len(s)
               for i, s in enumerate(seqs))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("opts", [dict(), dict(token_budget=60,
                                               num_buckets=2, max_len=9)])
def test_lm_loader_matches_jax(packed, seed, opts):
    root, _ = packed
    jl = jtrain.LmLoader(jdata.CorpusDataset(str(root / "jax")), seed=seed,
                         **opts)
    pl = ptrain.LmLoader(pdata.CorpusDataset(str(root / "port")), seed=seed,
                         **opts)
    assert pl.buckets == jl.buckets and pl.batch_sizes == jl.batch_sizes
    for epoch in (1, 2):
        want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    eval_j = jtrain.LmLoader(jdata.CorpusDataset(str(root / "jax")),
                             shuffle=False, **opts)
    eval_p = ptrain.LmLoader(pdata.CorpusDataset(str(root / "port")),
                             shuffle=False, **opts)
    for g, w in zip(eval_p, eval_j):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def _models(name):
    cfg = CONFIGS[name]
    jmodel = jtrain.build_model(cfg, num_classes=V)
    _, tx = jax_build_scheduler(SCHED)
    jstate = jtrain.init_state(jmodel, tx, jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    pmodel = ptrain.build_model(cfg, num_classes=V, device="cpu")
    pmodel.load_state_dict(model_state_dict(pmodel, params, {}))
    return jmodel, tx, jstate, pmodel


def _batch(packed, i=0):
    root, _ = packed
    loader = ptrain.LmLoader(pdata.CorpusDataset(str(root / "port")),
                             token_budget=200, num_buckets=2, seed=1)
    return list(loader.epoch(1))[i]


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_eval_and_three_adam_steps_match_jax(packed, name):
    jmodel, tx, jstate, pmodel = _models(name)
    jloss_fn = jtrain.make_loss_fn(jmodel)
    jeval = jtrain.make_eval_step(jmodel)
    jstep = jtrain.make_train_step(jmodel, tx)
    sched, opt = build_scheduler(SCHED, pmodel.parameters())
    state = ptrain.init_state(pmodel, opt)
    step = ptrain.make_train_step(pmodel, opt)
    evaluate = ptrain.make_eval_step(pmodel)
    loss_fn = ptrain.make_loss_fn(pmodel)
    gen = torch.Generator().manual_seed(0)
    for k in range(3):
        b = _batch(packed, k)
        jb = {key: jnp.asarray(v) for key, v in b.items()}
        tb = _torch_batch(b)
        want_loss, (_, want_seq, want_n) = jloss_fn(
            jstate.params, {}, jb, jax.random.PRNGKey(0), False)
        with torch.no_grad():
            loss, per_seq, _ = loss_fn(tb, None, False)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(per_seq.numpy(), np.asarray(want_seq),
                                   rtol=1e-5)
        je, pe = jeval(jstate, jb), evaluate(state, tb)
        assert int(pe["count"]) == int(je["count"]) == int(want_n)
        np.testing.assert_allclose(float(pe["loss_sum"]),
                                   float(je["loss_sum"]), rtol=1e-5)
        sched.update_lr_step(k + 1)
        jstate, jm = jstep(jstate, jb, jnp.asarray(sched.lr),
                           jax.random.PRNGKey(k))
        state, m = step(state, tb, sched.lr, gen)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert m["skipped"] == 0
    want = model_state_dict(pmodel, jax.tree_util.tree_map(
        np.asarray, jstate.params), {})
    start = _models(name)[3].state_dict()
    for k, v in pmodel.state_dict().items():
        if k.endswith(".k.bias"):
            # the key bias adds q·b to every score of a query, which the
            # softmax cancels: its exact gradient is 0, and Adam scales
            # the rounding noise of either package to steps of ±lr
            for w in (v, want[k]):
                assert float((w - start[k]).abs().max()) <= 3 * 3e-3 * 1.01
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sentence_nll_and_perplexity_match_jax(name):
    jmodel, _, jstate, pmodel = _models(name)
    seqs = corpus(3, n=21, lo=0, hi=40)
    want = jtrain.sentence_nll(jmodel, jstate.params, seqs)
    got = ptrain.sentence_nll(pmodel, seqs, batch_size=8)
    assert got.dtype == np.float64 and got.shape == (21,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(ptrain.perplexity(pmodel, seqs),
                               jtrain.perplexity(jmodel, jstate.params,
                                                 seqs), rtol=1e-5)
    # truncation at max_len: ids beyond max_len - 1 are not scored
    np.testing.assert_allclose(
        ptrain.sentence_nll(pmodel, seqs, max_len=16),
        jtrain.sentence_nll(jmodel, jstate.params, seqs, max_len=16),
        rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_neural_lm_scorer_matches_jax(name):
    jmodel, _, jstate, pmodel = _models(name)
    js = jscorer.NeuralLMScorer(jmodel, jstate.params)
    ps = pscorer.NeuralLMScorer(pmodel)
    rng = np.random.default_rng(4)
    contexts = [tuple(int(x) for x in rng.integers(1, V, L))
                for L in range(10)]
    for ctx in contexts:
        for tok in (0, 1, V - 1):
            np.testing.assert_allclose(ps.logp(ctx, tok), js.logp(ctx, tok),
                                       rtol=0, atol=1e-5)
    assert ps.forwards == len(contexts)
    row = ps.dist(contexts[3])
    assert row.dtype == np.float32
    np.testing.assert_allclose(np.log(np.sum(10.0 ** row.astype(
        np.float64))), 0.0, atol=1e-5)
    for ctx in contexts:  # served from the cache
        ps.logp(list(ctx), 2)
    assert ps.forwards == len(contexts)


def test_build_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrain.build_model(CONFIGS["lstm"], num_classes=V)
