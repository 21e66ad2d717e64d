"""Port parity of LLM-P2G (`cat_tpu_torch/p2g/train.py`, the decoder
`TransformerDecoder` and the seq2seq data of `utils/data.py`) against
`cat_tpu.p2g`, `cat_tpu.models.decoders` and `cat_tpu.utils.data`: the
same JAX parameters carried over by `utils/from_jax.py` (`p2g_state_dict`),
the same seeded batches, float32, dropout 0, toy sizes (hdim 32, 2 + 2
layers, 2 heads).

- `TransformerDecoder` with and without memory, causal or not, padded
  lengths; `P2GSeq2Seq`; `seq_logp`; `tkm_loss` at K = 3 with a -1e30
  padding candidate; the per-sequence CE with label smoothing 0.1;
  `marginalized_rescore`: within 1e-5 relative;
- one "ce" (label smoothing 0.1) and one "tkm" train step against JAX's
  `make_train_step`: loss 1e-5, grad norm 1e-4, parameters after Adam
  1e-4 (the attention key biases, whose exact gradient is 0, by bound);
- `greedy_generate` tokens and lengths, and `marginalized_decode`'s
  hypotheses (JAX's K searches, here one batch), equal on weights with
  clear margins; `danp_expand` equal;
- `Seq2SeqLoader` batch for batch with and without candidates at
  multiple_of 1 and 8; `pack_seq2seq` files read by either package;
- dropout at rate 0.1: the feed-forward's forward and backward draw one
  mask, keeping about 0.9; the attention masks (U, U) and (U, S), one a
  call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.models import decoders as jd
from cat_tpu.p2g import train as jp2g
from cat_tpu.utils import data as jdata
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch import models
from cat_tpu_torch.models import decoders as pd
from cat_tpu_torch.ops import dropout as dropout_op
from cat_tpu_torch.p2g import train as pp2g
from cat_tpu_torch.utils import data as pdata
from cat_tpu_torch.utils.from_jax import (model_state_dict,
                                          transformer_decoder_state_dict)
from cat_tpu_torch.utils.scheduler import build_scheduler

V_P, V_G = 11, 13
KW = dict(hdim=32, enc_layers=2, dec_layers=2, num_heads=2, ff_dim=64,
          dropout_rate=0.0)
CFG = {"p2g": {"kwargs": KW}}
LR = 3e-3
NOISE = 1e-5  # a gradient element below it is float32 noise around 0
SCHED = {"type": "SchedulerFixedStop", "kwargs": {"stop_step": 1000},
         "optimizer": {"type": "Adam", "kwargs": {"lr": LR}}}
RTOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def t(a):
    a = np.asarray(a)
    return torch.from_numpy(a).long() if a.dtype.kind in "iub" \
        else torch.from_numpy(a.copy())


def seq_batch(seed, N=4, S=9, U=7):
    """Sources, targets (as `batch_to_step` makes them) and K = 3
    candidates, the last utterance's third a padding candidate."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, V_P, (N, S)).astype(np.int32)
    src_lens = np.asarray([S, S - 2, 4, 1][:N], np.int32)
    tgt = rng.integers(1, V_G, (N, U - 1)).astype(np.int32)
    tgt_lens = np.asarray([U - 1, 3, U - 2, 1][:N], np.int32)
    b = pdata.Seq2SeqBatch(src, src_lens, tgt, tgt_lens,
                           np.asarray([1, 1, 1, 0][:N], np.float32))
    d = pp2g.batch_to_step(b)
    K = 3
    d["cands"] = rng.integers(1, V_P, (N, K, S)).astype(np.int32)
    d["cand_lens"] = rng.integers(1, S + 1, (N, K)).astype(np.int32)
    d["cand_scores"] = rng.normal(size=(N, K)).astype(np.float32)
    d["cand_lens"][-1, -1] = 1
    d["cand_scores"][-1, -1] = -1e30
    return d


def jax_pair(seed=2):
    """A JAX P2GSeq2Seq, its optimizer and initial state, and the port's
    model holding the same weights."""
    jmodel = jp2g.build_model(CFG, V_P, V_G)
    _, tx = jax_build_scheduler(SCHED)
    state = jp2g.init_state(jmodel, tx, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    pmodel = pp2g.build_model(CFG, V_P, V_G, device="cpu")
    sd = model_state_dict(pmodel, params, {})
    assert set(sd) == set(pmodel.state_dict())
    pmodel.load_state_dict(sd)
    return jmodel, tx, state, params, pmodel


@pytest.fixture(scope="module")
def pair():
    return jax_pair()


@pytest.fixture(scope="module")
def jax_fns(pair):
    """JAX's forward, per-sequence losses and rescoring, jitted once."""
    jmodel = pair[0]
    fwd = jax.jit(jmodel.apply)
    ce = jax.jit(lambda p, b: jp2g.make_per_seq_fn(
        jmodel, "ce", label_smoothing=0.1)(p, b, jax.random.PRNGKey(0),
                                           True))
    tkm = jax.jit(lambda p, b: jp2g.make_per_seq_fn(
        jmodel, "tkm", t_weight=1.5)(p, b, None, False))
    return fwd, ce, tkm


def test_p2g_converter_round_trips_every_parameter(pair):
    params, pmodel = pair[3], pair[4]
    assert set(model_state_dict(pmodel, params, {})) == set(
        pmodel.state_dict())
    names = [n for n, _ in pmodel.named_parameters()]
    assert any(".cross.k." in n for n in names) \
        and any(".lnx." in n for n in names)


@pytest.mark.parametrize("memory,causal", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_transformer_decoder_matches_jax(memory, causal):
    rng = np.random.default_rng(4)
    N, U, S, D = 3, 7, 5, 32
    toks = rng.integers(0, V_G, (N, U)).astype(np.int32)
    lens = np.asarray([U, 4, 1], np.int32)
    mem = rng.normal(size=(N, S, D)).astype(np.float32)
    mlens = np.asarray([S, 2, 3], np.int32)
    kw = dict(hdim=D, num_layers=2, num_heads=2, ff_dim=64,
              num_classes=V_G, dropout_rate=0.0, causal=causal)
    jmod = jd.TransformerDecoder(vocab_size=V_G, **kw)
    # JAX makes the cross layers at its first call with memory, the port
    # up front; a call without memory skips them in both
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(1), jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(mem), jnp.asarray(mlens))["params"])
    margs = (jnp.asarray(mem), jnp.asarray(mlens)) if memory else ()
    pmod = models.get_decoder("TransformerDecoder")(vocab_size=V_G, **kw)
    sd = transformer_decoder_state_dict(params)
    assert set(sd) == set(pmod.state_dict())
    pmod.load_state_dict(sd)
    want, _ = jax.jit(jmod.apply)({"params": params}, jnp.asarray(toks),
                                  jnp.asarray(lens), *margs)
    got, got_lens = pmod(t(toks), t(lens), *(t(m) for m in
                                             ((mem, mlens) if memory
                                              else ())))
    assert torch.equal(got_lens, t(lens))
    assert rel(got.detach(), want) <= RTOL
    # no lengths: JAX's decoding call (the causal mask alone)
    want, _ = jax.jit(jmod.apply)({"params": params}, jnp.asarray(toks),
                                  None, *margs)
    got, _ = pmod(t(toks), None, *(t(m) for m in ((mem, mlens) if memory
                                                  else ())))
    assert rel(got.detach(), want) <= RTOL


def test_p2g_forward_seq_logp_and_ce_match_jax(pair, jax_fns):
    params, pmodel = pair[3], pair[4]
    fwd, ce, _ = jax_fns
    d = seq_batch(1)
    jb = {k: jnp.asarray(v) for k, v in d.items()}
    tb = {k: t(v) for k, v in d.items()}
    want = fwd({"params": params}, jb["src"], jb["src_lens"], jb["tgt_in"],
               jb["tgt_lens"])
    with torch.no_grad():
        got = pmodel(tb["src"], tb["src_lens"], tb["tgt_in"], tb["tgt_lens"])
        assert rel(got, want) <= RTOL
        assert rel(pp2g.seq_logp(got, tb["tgt_out"], tb["tgt_lens"]),
                   jp2g.seq_logp(want, jb["tgt_out"], jb["tgt_lens"])) \
            <= RTOL
        # the per-sequence CE with label smoothing 0.1 (train mode, rate 0)
        pmodel.train()
        got_ce = pp2g.make_per_seq_fn(pmodel, "ce", label_smoothing=0.1)(
            tb, None, True)
        pmodel.eval()
    assert rel(got_ce, ce({"params": params}, jb)) <= RTOL


def test_tkm_loss_and_marginalized_rescore_match_jax(pair, jax_fns):
    jmodel, params, pmodel = pair[0], pair[3], pair[4]
    d = seq_batch(3)
    jb = {k: jnp.asarray(v) for k, v in d.items()}
    tb = {k: t(v) for k, v in d.items()}
    want = jax_fns[2]({"params": params}, jb)
    with torch.no_grad():
        got = pp2g.make_per_seq_fn(pmodel, "tkm", t_weight=1.5)(tb, None,
                                                                False)
    assert torch.isfinite(got).all() and rel(got, want) <= RTOL
    # hypotheses (N, J, U) with lengths 0 .. U
    rng = np.random.default_rng(8)
    N, J, U = 4, 2, 6
    hyps = rng.integers(1, V_G, (N, J, U)).astype(np.int32)
    hlens = np.asarray([[6, 2], [0, 5], [3, 3], [1, 6]], np.int32)
    want = jp2g.marginalized_rescore(
        jmodel, {"params": params}, jb["cands"], jb["cand_lens"],
        jb["cand_scores"], jnp.asarray(hyps), jnp.asarray(hlens),
        t_weight=1.5)
    got = pp2g.marginalized_rescore(pmodel, tb["cands"], tb["cand_lens"],
                                    tb["cand_scores"], t(hyps), t(hlens),
                                    t_weight=1.5)
    assert got.shape == (N, J) and rel(got, want) <= RTOL


@pytest.mark.parametrize("mode", ["ce", "tkm"])
def test_train_step_matches_jax(mode):
    jmodel, tx, jstate, _, pmodel = jax_pair(seed=5)
    kw = dict(mode=mode, t_weight=1.5) if mode == "tkm" \
        else dict(mode=mode, label_smoothing=0.1)
    jstep = jp2g.make_train_step(jmodel, tx, **kw)
    sched, opt = build_scheduler(SCHED, pmodel.parameters())
    step = pp2g.make_train_step(pmodel, opt, **kw)
    state = pp2g.init_state(pmodel, opt)
    d = seq_batch(6)
    sched.update_lr_step(1)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in d.items()},
                       jnp.asarray(sched.lr), jax.random.PRNGKey(0))
    state, m = step(state, {k: t(v) for k, v in d.items()}, sched.lr,
                    torch.Generator().manual_seed(0))
    assert state.step == 1 and set(m) == {"loss", "grad_norm"}
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want = model_state_dict(pmodel, jax.tree_util.tree_map(
        np.asarray, jstate.params), {})
    for name, p in pmodel.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        diff = np.abs(got - w)
        off = diff > 1e-4
        # an element whose gradient is float32 noise around an exact 0 (the
        # key biases, whose q·b the softmax cancels; the encoder's position
        # projection's rows of sinusoid columns constant over these short
        # inputs): Adam moves it by +-lr in either package
        noise = (p.grad.abs() < NOISE).numpy()
        assert (diff[off] <= 2 * LR).all() and noise[off].all(), \
            (name, diff.max())
        if name.endswith(".k.bias"):
            assert noise.all()


def test_greedy_generate_matches_jax():
    """Weights with clear margins: the head's kernel scaled by 30; eos is
    the token JAX's search (with no eos) emits at step 3 of row 0, so that
    rows end at different steps."""
    jmodel, _, _, params, pmodel = jax_pair(seed=7)
    params["decoder"]["head"]["kernel"] = params["decoder"]["head"][
        "kernel"] * 30.0
    pmodel.load_state_dict(model_state_dict(pmodel, params, {}))
    d = seq_batch(9)
    src, slens = jnp.asarray(d["src"]), jnp.asarray(d["src_lens"])
    free, _ = jp2g.greedy_generate(jmodel, {"params": params}, src, slens,
                                   eos=-1, max_len=8)
    eos = int(np.asarray(free)[0, 3])
    want, want_lens = jp2g.greedy_generate(jmodel, {"params": params}, src,
                                           slens, eos=eos, max_len=8)
    got, got_lens = pp2g.greedy_generate(pmodel, t(d["src"]),
                                         t(d["src_lens"]), eos=eos,
                                         max_len=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert int(got_lens[0]) <= 3 and int(got_lens.max()) > int(got_lens[0])
    got, got_lens = pp2g.greedy_generate(pmodel, t(d["src"]),
                                         t(d["src_lens"]), eos=-1,
                                         max_len=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(free))
    assert (got_lens == 8).all()


def test_marginalized_decode_matches_jax():
    """JAX's TKM decoding (a greedy search a candidate, then
    `marginalized_rescore`) against `marginalized_decode`, which searches
    all N·K candidates in one batch: hypotheses and lengths equal, scores
    within 1e-5 relative, on the head-scaled weights of the greedy test."""
    jmodel, _, _, params, pmodel = jax_pair(seed=7)
    params["decoder"]["head"]["kernel"] = params["decoder"]["head"][
        "kernel"] * 30.0
    pmodel.load_state_dict(model_state_dict(pmodel, params, {}))
    d = seq_batch(10)
    jc, jl = jnp.asarray(d["cands"]), jnp.asarray(d["cand_lens"])
    gens = [jp2g.greedy_generate(jmodel, {"params": params}, jc[:, k],
                                 jl[:, k], max_len=6)
            for k in range(jc.shape[1])]
    want_h = np.stack([np.asarray(g) for g, _ in gens], 1)
    want_l = np.stack([np.asarray(n) for _, n in gens], 1)
    want_s = jp2g.marginalized_rescore(
        jmodel, {"params": params}, jc, jl, jnp.asarray(d["cand_scores"]),
        jnp.asarray(want_h), jnp.asarray(want_l), t_weight=1.5)
    hyps, lens, scores = pp2g.marginalized_decode(
        pmodel, t(d["cands"]), t(d["cand_lens"]), t(d["cand_scores"]),
        max_len=6, t_weight=1.5)
    np.testing.assert_array_equal(hyps.numpy(), want_h)
    np.testing.assert_array_equal(lens.numpy(), want_l)
    assert rel(scores, want_s) <= RTOL


def test_danp_expand_matches_jax():
    utts = [("a", [3, 4]), ("b", [5]), ("c", [6, 7, 8])]
    nbest = {"a": [(-2.0, [1, 2]), (0.0, [2]), (-1.0, [3, 3])],
             "c": [(-0.5, [9])]}
    for k in (None, 1, 2):
        assert pp2g.danp_expand(utts, nbest, k) == jp2g.danp_expand(
            utts, nbest, k)


def pairs(seed, n=37, nbest=True):
    """(uid, src, tgt[, nbest]) of n utterances; every fifth without
    candidates, the candidates 0-4 a pair of lengths 1-14."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        src = [int(x) for x in rng.integers(1, V_P, int(rng.integers(1, 30)))]
        tgt = [int(x) for x in rng.integers(1, V_G, int(rng.integers(1, 9)))]
        item = (f"u{i:03d}", src, tgt)
        if nbest:
            item += ([(float(rng.normal()),
                       [int(x) for x in rng.integers(
                           1, V_P, int(rng.integers(1, 15)))])
                      for _ in range(0 if i % 5 == 0
                                     else int(rng.integers(1, 5)))],)
        out.append(item)
    return out


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq2seq")
    for nb in (True, False):
        items = pairs(11, nbest=nb)
        jdata.pack_seq2seq(str(root / f"jax{int(nb)}"), items)
        pdata.pack_seq2seq(str(root / f"port{int(nb)}"), items)
    return root


@pytest.mark.parametrize("nbest", [True, False])
def test_pack_seq2seq_files_read_by_either_package(packed, nbest):
    a_dir, b_dir = packed / f"jax{int(nbest)}", packed / f"port{int(nbest)}"
    with np.load(a_dir / "seq2seq.npz") as a, \
            np.load(b_dir / "seq2seq.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert (a_dir / "uids.txt").read_text() == (b_dir / "uids.txt").read_text()
    for pdir, jdir in ((a_dir, b_dir), (b_dir, a_dir)):
        p, j = pdata.Seq2SeqDataset(str(pdir)), jdata.Seq2SeqDataset(str(jdir))
        assert len(p) == len(j) == 37 and p.uids == j.uids
        assert p.has_nbest == j.has_nbest == nbest
        for i in range(len(p)):
            for x, y in zip(p[i], j[i]):
                np.testing.assert_array_equal(x, y)
            assert p.frame_length(i) == j.frame_length(i)
            assert p.label_length(i) == j.label_length(i)
            got, want = p.nbest(i), j.nbest(i)
            assert [s for s, _ in got] == [s for s, _ in want]
            assert all(np.array_equal(x, y) for (_, x), (_, y) in
                       zip(got, want))


@pytest.mark.parametrize("nbest", [True, False])
@pytest.mark.parametrize("multiple_of", [1, 8])
def test_seq2seq_loader_matches_jax(packed, nbest, multiple_of):
    path = str(packed / f"port{int(nbest)}")
    kw = dict(frame_budget=120, num_buckets=3, multiple_of=multiple_of)
    for num_cands in ((None, 2) if nbest else (None,)):
        for shuffle, seed in ((True, 0), (True, 3), (False, 0)):
            jl = jdata.Seq2SeqLoader(jdata.Seq2SeqDataset(path),
                                     shuffle=shuffle, seed=seed,
                                     num_cands=num_cands, **kw)
            pl = pdata.Seq2SeqLoader(pdata.Seq2SeqDataset(path),
                                     shuffle=shuffle, seed=seed,
                                     num_cands=num_cands, **kw)
            assert pl.buckets == jl.buckets
            assert pl.batch_sizes == jl.batch_sizes
            assert pl.tgt_caps == jl.tgt_caps and pl.K == jl.K
            assert pl.num_batches() == jl.num_batches()
            for epoch in (1, 2):
                want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
                assert len(got) == len(want) > 1
                for g, w in zip(got, want):
                    assert g.uids == w.uids
                    gd, wd = g.asdict(), w.asdict()
                    assert gd.keys() == wd.keys()
                    assert ("cands" in gd) == nbest
                    for k in wd:
                        assert gd[k].dtype == wd[k].dtype
                        np.testing.assert_array_equal(gd[k], wd[k])
                    assert len(g.weight) % multiple_of == 0


def test_dropout_masks_at_rate_0_1(monkeypatch):
    """Train mode at rate 0.1: each decoder layer's feed-forward dropout
    launches once forward and once backward with the same seed and the
    same mask (the zeros of its output), keeping about 0.9; the attention
    draws one (U, U) self mask and one (U, S) cross mask a layer."""
    model = pp2g.build_model({"p2g": {"kwargs": dict(KW, dropout_rate=0.1)}},
                             V_P, V_G, device="cpu")
    calls, scales = [], []
    apply, scale = dropout_op.dropout_apply, pd.dropout_mask

    def record_apply(x, rate, seed, stream=0):
        out = apply(x, rate, seed, stream)
        calls.append((rate, tuple(seed), out == 0, x != 0))
        return out

    def record_scale(seed, stream, rows, cols, rate, device=None):
        out = scale(seed, stream, rows, cols, rate, device)
        scales.append(out)
        return out

    monkeypatch.setattr(dropout_op, "dropout_apply", record_apply)
    monkeypatch.setattr(pd, "dropout_mask", record_scale)
    d = seq_batch(2, N=4, S=40, U=30)
    tb = {k: t(v) for k, v in d.items()}
    model.train()
    logits = model(tb["src"], tb["src_lens"], tb["tgt_in"], tb["tgt_lens"],
                   torch.Generator().manual_seed(0))
    forward = list(calls)
    pp2g.seq_logp(logits, tb["tgt_out"], tb["tgt_lens"]).sum().backward()
    backward = calls[len(forward):]
    L = KW["dec_layers"]
    assert len(forward) == len(backward) == L
    assert len({c[1] for c in forward}) == L
    by_seed = {c[1]: c for c in backward}
    assert set(by_seed) == {c[1] for c in forward}
    for rate, seed, zero, nonzero in forward:
        # dropped where both the input and the cotangent are nonzero
        _, _, zero_b, nonzero_b = by_seed[seed]
        both = nonzero & nonzero_b
        assert rate == 0.1 and both.float().mean() > 0.5
        assert torch.equal(zero[both], zero_b[both])
    dropped = torch.cat([z[nz] for _, _, z, nz in forward]).float().mean()
    assert abs(float(dropped) - 0.1) < 0.02
    U, S = tb["tgt_in"].shape[1], tb["src"].shape[1]
    assert [tuple(x.shape) for x in scales] == [(1, U, U), (1, U, S)] * L
    kept = torch.cat([(x > 0).float().flatten() for x in scales]).mean()
    assert abs(float(kept) - 0.9) < 0.02
    # eval mode draws nothing
    calls.clear()
    scales.clear()
    model.eval()
    with torch.no_grad():
        model(tb["src"], tb["src_lens"], tb["tgt_in"], tb["tgt_lens"])
    assert not calls and not scales
