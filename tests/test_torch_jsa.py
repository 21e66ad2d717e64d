"""Port parity for JSA-SPG's trainer (`cat_tpu_torch.ctc.train_jsa`) and
its task adapter against `cat_tpu`, in float32 on the CPU.

Models at the template's widths (egs/template/exp/asr-jsa): S2P a
1-layer BLSTM of 16, P2G and G2P 1-cell `EmbeddingEncoder`s of d = 16 (2
heads, conv kernel 3); 5 phonemes and 4 graphemes (blank included), 6
feature dims, upsample 3. Batches as tests/test_jsa.py makes them: each
grapheme g spoken as the phoneme pair (g, g % 2 + 1), 4 frames each, plus
noise, drawn with numpy from fixed seeds. Weights: JAX's init perturbed
by 0.05, carried across by `from_jax.jsa_state_dict`.

- The three losses for a fixed z, and every parameter's gradient, against
  the JAX trainer's loss: losses within 1e-5 relative, gradients within
  1e-4 relative norm (the P2G and G2P key biases, whose exact gradient is
  0, within 1e-5 absolute); the clip scale min(1, 5 / (|g| + 1e-6)) as
  JAX's for the same norm.
- Three train steps with every utterance's z supervised (Adam, lr 3e-3):
  metrics within 1e-4 and every parameter within 1e-4 + 1e-4·|x|, except
  an element whose gradient was below 1e-5 (float32 noise around an exact
  0: the key biases, and the position projection's rows of sinusoid
  columns that are constant over these short inputs, which the softmax
  cancels) at some step, which Adam moves by +-lr: within 2·lr a step.
- `sample_z` over two rounds of the batch from the same weights: the
  same proposals, cache and acceptance counts, except for an utterance
  whose G2P n-best has two scores within 1e-3 of each other (a near-tie
  the two packages' rounding may break apart), which is exempt; at most
  one of the four is.
- Supervised substitution: a batch with half its utterances supervised
  takes their phonemes and samples the others, as JAX's step does.
- `manager_steps`' dev loss (greedy-z cascade) within 1e-4 of JAX's.
- A JAX checkpoint of the three models loads into the port's `JsaModel`.
- A ConformerNet's weights without batch_stats do not convert (KeyError),
  in either layout; as the JSA S2P they start from flax's initial
  statistics (mean 0, var 1), equal to a fresh JAX init's.
- Both JSA recipes pass the pipeline's checks, the bins map to the port's
  adapter and module, `EmbeddingEncoder` is registered.
- egs/template/exp/asr-jsa through stages 1-4 of `pipeline.asr` with
  `--device cpu` on a tiny yes/no corpus, with and without `text_phone`
  (max_epochs 60 -> 2): every stage's files.
"""
import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc import train_jsa as jax_jsa
from cat_tpu.models.encoders import ConformerNet as JaxConformerNet
from cat_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from cat_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
from cat_tpu.utils.data import Batch as JaxBatch
from cat_tpu.utils.manager import TrainState as JaxTrainState
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.ctc import train_jsa
from cat_tpu_torch.ctc.decode import prefix_beam_search
from cat_tpu_torch.models import encoders, get_encoder
from cat_tpu_torch.pipeline import asr, tasks
from cat_tpu_torch.utils.checkpoint import model_weights
from cat_tpu_torch.utils.data import Batch
from cat_tpu_torch.utils.from_jax import (conformer_state_dict,
                                          jsa_state_dict, model_state_dict)
from cat_tpu_torch.utils.scheduler import build_scheduler
from tests.test_torch_transducer import _perturbed

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, G, F, UP = 5, 4, 6, 3
TOKEN_ENC = {"type": "EmbeddingEncoder",
             "kwargs": {"num_cells": 1, "hdim": 16, "num_heads": 2,
                        "kernel_size": 3, "dropout_rate": 0.0}}
CFG = {"s2p": {"type": "LSTM", "kwargs": {"hdim": 16, "num_layers": 1,
                                          "bidirectional": True,
                                          "dropout_rate": 0.0}},
       "p2g": TOKEN_ENC, "g2p": TOKEN_ENC}
SCHED = {"type": "SchedulerFixedStop", "kwargs": {"stop_step": 100000},
         "optimizer": {"type": "Adam", "kwargs": {"lr": 3e-3}}}
LR = 3e-3
NOISE = 1e-5  # the key biases' gradients: float32 noise around an exact 0
TIE = 1e-3


def make_batch(seed, B=4, T=40):
    """tests/test_jsa.py's batch: grapheme g -> phonemes (g, g % 2 + 1),
    4 frames each, then 2 silent frames, plus noise."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((B, T, F), np.float32)
    labels = np.zeros((B, 4), np.int32)
    flen = np.zeros((B,), np.int32)
    llen = np.zeros((B,), np.int32)
    zs = {}
    for n in range(B):
        ng = int(rng.integers(1, 4))
        t, z = 0, []
        for u in range(ng):
            g = int(rng.integers(1, G))
            labels[n, u] = g
            for ph in (g, g % 2 + 1):
                feats[n, t:t + 4, :] = ph
                t += 4
                z.append(ph)
            t += 2
        feats[n] += rng.standard_normal((T, F)).astype(np.float32) * 0.1
        flen[n], llen[n] = min(t, T), ng
        zs[f"u{seed}_{n}"] = z
    arrays = (feats, flen, labels, llen, np.ones((B,), np.float32))
    uids = list(zs)
    return arrays, uids, zs


def batches(seed):
    arrays, uids, zs = make_batch(seed)
    return (JaxBatch(*arrays, uids=uids), Batch(*arrays, uids=list(uids)),
            zs)


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX trainer for the module (its jitted functions compile once)
    and its perturbed initial weights."""
    s2p, p2g, g2p = jax_jsa.build_models(CFG, num_phonemes=P,
                                         num_graphemes=G)
    _, tx = jax_build_scheduler(SCHED)
    jt = jax_jsa.JsaTrainer(s2p, p2g, g2p, tx, feat_dim=F, num_phonemes=P,
                            num_graphemes=G, num_samples=3, beam_width=4,
                            upsample=UP)
    return jt, _perturbed(jax.tree_util.tree_map(np.asarray, jt.params), 1)


@pytest.fixture
def fresh(jax_trainer):
    """The JAX trainer reset to the perturbed weights, a fresh optimizer,
    sampler and sampling rng, and a port trainer with the same weights."""
    jt, params = jax_trainer
    jt.params = params
    jt.opt_state = jt.tx.init(params)
    jt.sampler = jax_jsa.JsaState()
    jt._np_rng = np.random.default_rng(0)
    model = train_jsa.build_model(CFG, P, G, feat_dim=F, device="cpu")
    model.load_state_dict(jsa_state_dict(model, params, {}))
    _, opt = build_scheduler(SCHED, model.parameters())
    pt = train_jsa.JsaTrainer(model, opt, P, G, num_samples=3, beam_width=4,
                              upsample=UP)
    return jt, pt


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _jax_losses(jt, params, db):
    """The JAX trainer's loss_fn (its dropout rates are 0)."""
    def one(net, p, x, xl, labels, ll):
        lg, ol = net.apply({"params": p}, x, xl, deterministic=True)
        per = jax_ctc_loss(jax.nn.log_softmax(lg, -1), labels, ol, ll,
                           reduction="none")
        return jax_jsa._wmean(per, db["weight"])

    parts = (one(jt.s2p, params["s2p"], db["feats"], db["feat_lengths"],
                 db["z"], db["z_lengths"]),
             one(jt.p2g, params["p2g"], db["z_up"], db["z_up_lengths"],
                 db["y"], db["y_lengths"]),
             one(jt.g2p, params["g2p"], db["y_up"], db["y_up_lengths"],
                 db["z"], db["z_lengths"]))
    return parts[0] + parts[1] + parts[2], parts


def test_losses_gradients_and_clip_for_a_fixed_z(fresh):
    jt, pt = fresh
    _, batch, zs = batches(0)
    b = pt.device_batch(batch, [zs[u] for u in batch.uids])
    db = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    (total_j, parts_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: _jax_losses(jt, p, db), has_aux=True))(jt.params)
    pt.model.train()
    total, parts = pt.loss_fn(b, torch.Generator().manual_seed(0))
    total.backward()
    for got, want in zip((total, *parts), (total_j, *parts_j)):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    want = jsa_state_dict(pt.model, g_j, {})
    grads = dict(pt.model.named_parameters())
    assert set(want) == set(grads)
    for name, g in want.items():
        got = grads[name].grad.numpy()
        if name.endswith("mhsa.k.bias"):
            assert np.abs(got).max() < NOISE and np.abs(g).max() < NOISE
            continue
        assert _rel(got, g) < 1e-4, (name, _rel(got, g))
    gnorm = train_jsa.global_grad_norm(pt.params)
    gnorm_j = float(jnp.sqrt(sum(jnp.sum(x ** 2) for x in
                                 jax.tree_util.tree_leaves(g_j))))
    assert abs(float(gnorm) - gnorm_j) <= 1e-4 * gnorm_j
    for g in (gnorm_j, 0.5, 5.0, 50.0):
        want = float(jnp.minimum(1.0, 5.0 / (jnp.float32(g) + 1e-6)))
        assert abs(float(train_jsa.clip_scale(torch.tensor(g))) - want) \
            <= 1e-7


def test_supervised_train_steps_match_jax(fresh):
    jt, pt = fresh
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    noisy = {}  # elements whose gradient was float32 noise at some step
    for step in range(3):
        jb, pb, zs = batches(step)
        key, sub = jax.random.split(key)
        m_j = jt.train_step(jb, sub, supervised_z=zs, lr=LR)
        m = pt.train_step(pb, gen, supervised_z=zs, lr=LR)
        assert set(m) == set(m_j)
        for k in m:
            assert abs(m[k] - m_j[k]) <= 1e-4 * max(abs(m_j[k]), 1.0), \
                (step, k, m[k], m_j[k])
        want = jsa_state_dict(pt.model, jt.params, {})
        for name, p in pt.model.named_parameters():
            noisy[name] = noisy.get(name, False) | (p.grad.abs() < NOISE)
            got, w = p.detach().numpy(), want[name].numpy()
            diff = np.abs(got - w)
            off = diff > 1e-4 + 1e-4 * np.abs(w)
            # Adam turns a gradient of float32 noise into a step of +-lr
            assert (diff[off] <= 2 * LR * (step + 1)).all() and \
                noisy[name].numpy()[off].all(), (step, name, diff.max())
    assert pt.sampler.proposed == jt.sampler.proposed == 0


def _near_tie(pt, y):
    """Whether the G2P n-best of y has two scores within TIE."""
    with torch.no_grad():
        y_up = np.repeat(np.asarray(y, np.int64), UP)
        lp, ol = train_jsa.log_probs(pt.g2p, *pt._ids([y_up]))
        scores = [s for s, _ in prefix_beam_search(
            lp[0].numpy(), int(ol[0]), beam_width=pt.beam_width,
            nbest=pt.K)]
    return any(abs(a - b) < TIE for a, b in zip(scores, scores[1:]))


def test_sample_z_matches_jax(fresh):
    jt, pt = fresh
    _, batch, _ = batches(1)
    pt.model.eval()
    exempt = set()
    for _ in range(2):
        for j, uid in enumerate(batch.uids):
            y = batch.labels[j, :batch.label_lengths[j]]
            args = (uid, batch.feats[j, :batch.feat_lengths[j]],
                    int(batch.feat_lengths[j]), y)
            z_j = jt.sample_z(*args)
            with torch.no_grad():
                z = pt.sample_z(*args)
            if _near_tie(pt, y):
                exempt.add(uid)
            if uid in exempt:
                continue
            assert list(z) == list(z_j), (uid, z, z_j)
            (zc, w), (zc_j, w_j) = pt.sampler.cache[uid], \
                jt.sampler.cache[uid]
            assert list(zc) == list(zc_j)
            assert abs(w - w_j) <= 1e-4 * max(abs(w_j), 1.0)
    assert len(exempt) <= 1, exempt
    if not exempt:
        assert pt.sampler.accepted == jt.sampler.accepted
        assert pt.sampler.acceptance_rate == jt.sampler.acceptance_rate
    assert pt.sampler.proposed == jt.sampler.proposed == 8


def test_supervised_substitution(fresh):
    jt, pt = fresh
    jb, pb, zs = batches(2)
    half = {u: zs[u] for u in pb.uids[:2]}
    zs_port = pt.draw_z(pb, half)
    assert zs_port[:2] == [half[u] for u in pb.uids[:2]]
    assert pt.sampler.proposed == 2
    m_j = jt.train_step(jb, jax.random.PRNGKey(0), supervised_z=half, lr=LR)
    assert jt.sampler.proposed == 2
    assert pt.sampler.acceptance_rate == m_j["acceptance_rate"] == 1.0
    for uid in pb.uids[2:]:
        assert list(pt.sampler.cache[uid][0]) == \
            list(jt.sampler.cache[uid][0])


def test_manager_dev_loss_matches_jax(fresh):
    jt, pt = fresh
    jb, pb, _ = batches(3)
    jstate, _, jeval = jax_jsa.manager_steps(jt)
    state, _, peval = train_jsa.manager_steps(pt)
    want = jeval(jstate, jb)
    got = peval(state, pb)
    assert float(got["count"]) == float(want["count"]) == 4.0
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= \
        1e-4 * abs(float(want["loss_sum"]))


def test_jax_checkpoint_loads_into_the_port(tmp_path, fresh):
    jt, pt = fresh
    _, tx = jax_build_scheduler(SCHED)
    state = JaxTrainState(params=jt.params, batch_stats={},
                          opt_state=tx.init(jt.params), step=jnp.asarray(0))
    ckpt = JaxCkpt(str(tmp_path / "jax"))
    ckpt.save({"state": state}, 1.0, 1, 1)
    got = model_weights(pt.model, ckpt.path(ckpt.best()))
    want = model_state_dict(pt.model, jt.params, {})
    assert set(got) == set(want) == set(pt.model.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("layout", [{}, {"scan_layers": True}])
def test_conformer_conversion_needs_batch_stats(jax_trainer, layout):
    """A ConformerNet's weights without its batch_stats do not convert:
    JAX raises on such a model's eval forward as well. Only the JSA S2P,
    whose JAX trainer keeps none, starts from flax's initial statistics,
    which `jsa_state_dict` builds for it on purpose."""
    kw = dict(num_cells=2, hdim=16, num_heads=2, kernel_size=3,
              dropout_rate=0.0, **layout)
    jm = JaxConformerNet(num_classes=P, **kw)
    v = jax.jit(partial(jm.init, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 20)),
        jnp.asarray([16], jnp.int32))
    s2p = jax.tree_util.tree_map(np.asarray, v["params"])
    with pytest.raises(KeyError):
        conformer_state_dict(s2p, {})
    _, params = jax_trainer
    cfg = dict(CFG, s2p={"type": "ConformerNet", "kwargs": kw})
    model = train_jsa.build_model(cfg, P, G, feat_dim=20, device="cpu")
    got = jsa_state_dict(model, dict(params, s2p=s2p), {})
    model.load_state_dict(got)
    want = conformer_state_dict(s2p, jax.tree_util.tree_map(
        np.asarray, v["batch_stats"]))
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 4
    for k in stats:
        assert torch.equal(got["s2p." + k], want[k]), k


JSA_RECIPES = ["jsa-spg/exp/jsa", "template/exp/asr-jsa"]


@pytest.mark.parametrize("name", JSA_RECIPES)
def test_jsa_recipe_passes_the_checks(name):
    src = os.path.join(REPO, "egs", *name.split("/"))
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    asr.check_train(hyper, config)
    asr.check_decode(hyper, config)
    task = tasks.get_task(hyper)
    assert isinstance(task, tasks.JsaTask)
    assert task.module() is train_jsa
    assert tasks.train_module(hyper["train"]["bin"]) is train_jsa
    for key in ("p2g", "g2p"):
        assert get_encoder(config[key]["type"]) is encoders.EmbeddingEncoder


@pytest.mark.parametrize("pkg", ["cat_tpu", "cat_tpu_torch"])
def test_jsa_bin_maps_to_the_adapter(pkg):
    hyper = {"train": {"bin": f"{pkg}.ctc.train_jsa"}}
    assert isinstance(tasks.get_task(hyper), tasks.JsaTask)
    # the P2G bin raised (§A.8) until the P2G slice gave it its adapter
    assert isinstance(tasks.get_task({"train": {"bin": f"{pkg}.p2g.train"}}),
                      tasks.P2gTask)


def _jsa_corpus(root, phones):
    """egs/template/local/make_data_jsa.py's corpus at 12 train and 4 dev
    utterances: yes/no tones, lexicon yes -> J E S, no -> N O, and (with
    phones) text_phone."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "egs", "template", "local"))
    import make_data
    from cat_tpu.utils.audio import write_wav

    rng = np.random.default_rng(1)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "lexicon.txt"), "w") as f:
        f.write("yes J E S\nno N O\n")
    for split, n in (("train", 12), ("dev", 4)):
        d = os.path.join(root, split)
        os.makedirs(os.path.join(d, "wav"))
        scp, text = [], []
        for i in range(n):
            words = list(rng.choice(["yes", "no"],
                                    size=int(rng.integers(1, 4))))
            uid = f"{split}_{i:03d}"
            path = os.path.join(d, "wav", uid + ".wav")
            write_wav(path, make_data.make_utt(rng, words), make_data.SR)
            scp.append(f"{uid} {path}")
            text.append(f"{uid} {' '.join(words)}")
        for name, lines in (("wav.scp", scp), ("text", text)) + \
                ((("text_phone", text),) if phones else ()):
            with open(os.path.join(d, name), "w") as f:
                f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("phones", [True, False])
def test_template_asr_jsa_stages_1_to_4(tmp_path, phones):
    data = str(tmp_path / "data")
    _jsa_corpus(data, phones)
    src = os.path.join(REPO, "egs", "template", "exp", "asr-jsa")
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    hyper["data"] = {"train": os.path.join(data, "train"),
                     "dev": os.path.join(data, "dev")}
    hyper["tokenizer"]["option-init"]["lexicon"] = os.path.join(
        data, "lexicon.txt")
    hyper["train"]["option"]["max_epochs"] = 2
    expdir = tmp_path / "exp"
    expdir.mkdir()
    for name, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(expdir / name, "w") as f:
            json.dump(obj, f)
    asr.main([str(expdir), "--device", "cpu"])
    sup = expdir / "pkl" / "train" / "phones.json"
    assert sup.exists() == phones
    if phones:
        assert sorted(json.loads(sup.read_text())) == \
            [f"train_{i:03d}" for i in range(12)]
    with open(expdir / "check" / "checkpoint.list") as f:
        assert len(f.read().splitlines()) == 2
    with open(expdir / "wer_dev.json") as f:
        res = json.load(f)
    assert res["mode"] == "marginalize" and np.isfinite(res["wer"])
    assert res["device_s"] > 0 and res["host_s"] > 0
    assert len((expdir / "decode_dev.txt").read_text().splitlines()) == 4
    assert (expdir / "readme.md").exists()
