"""Port parity for multichannel end-to-end ASR (`cat_tpu_torch.ctc.
train_me2e*`, `ctc.decode_me2e`, `utils.data_prep --channels` and the
ME2E task of `pipeline.asr`) against `cat_tpu`, in float32 on the CPU.

Models at toy widths: 2 channels at 8 kHz, fft 64, 12 mel bins, mask nets
of 8 units; a 1-cell conformer (d = 16, 2 heads, conv kernel 3, dropout
0). `Me2eModel` has aishell4's front end (DNN-WPE, 5 taps, delay 3, then
MVDR); `ChunkMe2eModel` an MVDR front end under chunks of 16 STFT frames
with 16 left and 8 right (win 40 -> 9 encoder frames, r = 4), a SimuNet
of 8. Batches: 3 utterances of 2400, 2100 and 1800 samples (74, 64 and 55
frames), noise over a shared delayed source, drawn with numpy from fixed
seeds. Weights: JAX's init perturbed, running statistics drawn positive,
carried across by `utils.from_jax`.

- Eval logits within 1e-4 relative norm, output lengths equal, the eval
  loss within 1e-4; the chunk pass for every future (outputs 1e-4
  relative norm, lengths equal, simu_l1 within 1e-5).
- Three train steps (lr 1e-3, clipping at 5) from the same weights
  against JAX's `make_train_step`: loss, gradient norm and the chunk
  model's terms each step within 1e-4, the running statistics after the
  first step within 1e-5 of JAX's batch_stats (later, the variances
  within 1e-4 and the means within lr a step: they follow the depthwise
  biases), the parameters after each step within 1e-4 (an element whose
  gradient is float32 noise at some step, as the conformer's key and
  depthwise biases are, moves within lr a step).
- The guard: a batch with an inf sample after those steps: skipped 1.0,
  the parameters, Adam's moments and count, and the running statistics
  as JAX's, NaN equal to NaN.
- Decoding, offline and streaming: greedy hypotheses equal JAX's, the
  width-4 beam's prefixes equal and its scores within 1e-4.
- Weights: a checkpoint of either package loads into the port's model.
- `data_prep --channels 2` writes JAX's packed data exactly (a 2-channel,
  a mono and a 3-channel source, speed perturbation 0.9).
- egs/template/exp/asr-me2e through stages 1-4 of `pipeline.asr` with
  `--device cpu` on a few synthesized 2-channel utterances (max_epochs
  cut to 2): every stage's files.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc import decode_me2e as jax_decode
from cat_tpu.ctc import train_me2e as jax_me2e
from cat_tpu.ctc import train_me2e_chunk as jax_chunk
from cat_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
from cat_tpu.utils.manager import TrainState as JaxTrainState
from cat_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from cat_tpu_torch.ctc import decode_me2e, train_me2e, train_me2e_chunk
from cat_tpu_torch.utils.checkpoint import model_weights, save_checkpoint
from cat_tpu_torch.utils.from_jax import model_state_dict
from cat_tpu_torch.utils.scheduler import build_scheduler
from tests.test_torch_front import rel
from tests.test_torch_transducer import SCHED, _np_tree, _perturbed

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, CH, L, SR = 7, 2, 2400, 8000
LENS = np.array([2400, 2100, 1800], np.int32)
LR, STEPS = 1e-3, 3
NOISE = 1e-6  # gradient magnitude of float32 rounding noise here
FRONT = dict(num_bins=12, sample_rate=SR, frame_length=64, frame_shift=32,
             fft_size=64, mask_hidden=8)
ENCODER = {"type": "ConformerNet",
           "kwargs": dict(num_cells=1, hdim=16, num_heads=2, kernel_size=3,
                          dropout_rate=0.0)}
CFGS = {"plain": {"frontend": {"kwargs": dict(FRONT, use_wpe=True)},
                  "encoder": ENCODER, "scheduler": SCHED},
        "chunk": {"frontend": {"kwargs": FRONT}, "encoder": ENCODER,
                  "unified": {"chunk": 16, "left_context": 16,
                              "right_context": 8, "simu_hidden": 8},
                  "scheduler": SCHED}}
JAX_TASK = {"plain": jax_me2e, "chunk": jax_chunk}
TASK = {"plain": train_me2e, "chunk": train_me2e_chunk}


def batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((3, L + CH)).astype(np.float32)
    wave = np.stack([src[:, CH - c:CH - c + L] for c in range(CH)], 1) * 0.1
    wave = wave + 0.3 * rng.standard_normal((3, CH, L)).astype(np.float32)
    wave *= np.arange(L) < LENS[:, None, None]
    llens = np.array([4, 3, 2], np.int32)
    labels = rng.integers(1, V, (3, 4)).astype(np.int32)
    labels *= np.arange(4)[None, :] < llens[:, None]
    return {"feats": wave.astype(np.float32), "feat_lengths": LENS,
            "labels": labels, "label_lengths": llens,
            "weight": rng.uniform(0.5, 2.0, 3).astype(np.float32)}


def tb(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port(kind, params, stats):
    model = TASK[kind].build_model(CFGS[kind], V, device="cpu")
    model.load_state_dict(model_state_dict(model, params, stats))
    return model


def _setup(kind):
    """The JAX model and TrainState (perturbed weights, positive running
    statistics), its jitted train step run STEPS times on batch 0 then once
    on a poisoned batch (the states after each), and its eval logits."""
    task = JAX_TASK[kind]
    jm = task.build_model(CFGS[kind], V)
    _, tx = jax_build_scheduler(SCHED)
    state = task.init_state(jm, tx, num_channels=CH,
                            rng=jax.random.PRNGKey(0), num_samples=L)
    params = _perturbed(_np_tree(state.params), 1)
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(np.asarray(a)) + 0.5).astype(np.float32),
        state.batch_stats)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             stats),
                          opt_state=tx.init(params))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    b = batch()
    logits, olens = jax.jit(lambda v, w, n: jm.apply(v, w, n))(
        variables, jnp.asarray(b["feats"]), jnp.asarray(LENS))
    ev = task.make_eval_step(jm)(state, jb(b))
    step = task.make_train_step(jm, tx, grad_clip=5.0)
    states, metrics = [], []
    for i in range(STEPS + 1):
        bi = b if i < STEPS else poisoned(b)
        state, m = step(state, jb(bi), jnp.float32(LR),
                        jax.random.PRNGKey(i))
        states.append((_np_tree(state.params), _np_tree(state.batch_stats),
                       _adam(state.opt_state)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"kind": kind, "jm": jm, "tx": tx, "params": params,
            "stats": _np_tree(stats),
            "logits": np.asarray(logits), "olens": np.asarray(olens),
            "eval": float(ev["loss_sum"]), "states": states,
            "metrics": metrics}


@pytest.fixture(scope="module")
def plain():
    return _setup("plain")


@pytest.fixture(scope="module")
def chunk():
    return _setup("chunk")


@pytest.fixture(params=sorted(CFGS))
def setup(request):
    return request.getfixturevalue(request.param)


def poisoned(b):
    bad = dict(b, feats=b["feats"].copy())
    bad["feats"][1, 0, 700] = np.inf
    return bad


def _adam(opt_state):
    """(count, mu, nu) of optax's Adam inside the injected state."""
    inner = opt_state.inner_state[0]
    return int(inner.count), _np_tree(inner.mu), _np_tree(inner.nu)


def test_forward_and_eval_loss_match_jax(setup):
    s = setup
    port = _port(s["kind"], s["params"], s["stats"])
    b = batch()
    with torch.no_grad():
        logits, olens = port(torch.from_numpy(b["feats"]),
                             torch.from_numpy(LENS))
    np.testing.assert_array_equal(olens.numpy(), s["olens"])
    assert rel(logits.numpy(), s["logits"]) < 1e-4
    ev = TASK[s["kind"]].make_eval_step(port)(None, tb(b))
    np.testing.assert_allclose(ev["loss_sum"].item(), s["eval"], rtol=1e-4)


@pytest.mark.parametrize("future", ["simu", "none", "real"])
def test_chunk_forward_matches_jax(chunk, future):
    s = chunk
    port = _port("chunk", s["params"], s["stats"])
    b = batch(1)
    jm = s["jm"]
    want, want_len, want_l1 = jax.jit(lambda v, w, n: jm.apply(
        v, w, n, deterministic=True, method=jm.chunk_forward,
        future=future))({"params": s["params"], "batch_stats": s["stats"]},
                        jnp.asarray(b["feats"]), jnp.asarray(LENS))
    with torch.no_grad():
        got, got_len, l1 = port.chunk_forward(
            torch.from_numpy(b["feats"]), torch.from_numpy(LENS),
            future=future)
    # 5 windows of 40 frames, 9 encoder frames each: r = 4, width 4
    assert got.shape == (3, 20, V)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert rel(got.numpy(), want) < 1e-4
    np.testing.assert_allclose(float(l1), float(want_l1), rtol=1e-5,
                               atol=1e-8)
    assert (float(l1) > 0) == (future == "simu")
    out, out_len = train_me2e_chunk.bf_chunk_infer(
        port, torch.from_numpy(b["feats"]), torch.from_numpy(LENS), future)
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    np.testing.assert_array_equal(out_len.numpy(), got_len.numpy())


def _equal(got, want, what, tol=1e-4, noisy=None):
    for name, w in want.items():
        g = got[name]
        w = w.numpy() if torch.is_tensor(w) else w
        m = np.ones(w.shape, bool) if noisy is None else ~noisy.get(
            name, np.zeros(w.shape, bool))
        np.testing.assert_allclose(g[m], w[m], rtol=tol, atol=tol,
                                   equal_nan=True, err_msg=f"{what} {name}")


def test_train_steps_and_guard_track_jax(setup):
    s = setup
    kind = s["kind"]
    port = _port(kind, s["params"], s["stats"])
    _, opt = build_scheduler(SCHED, port.parameters())
    step = TASK[kind].make_train_step(port, opt, grad_clip=5.0)
    state = TASK[kind].init_state(port, opt)
    names = [n for n, _ in port.named_parameters()]
    conv = lambda p, st: model_state_dict(port, p, st)
    old = {n: p.detach().clone().numpy() for n, p in port.named_parameters()}
    noisy = {n: np.zeros(p.shape, bool) for n, p in port.named_parameters()}
    b = batch()
    for i in range(STEPS + 1):
        bi = b if i < STEPS else poisoned(b)
        state, m = step(state, tb(bi), LR, None)
        want = s["metrics"][i]
        params, stats, (count, mu, nu) = s["states"][i]
        assert m["skipped"] == want["skipped"] == float(i == STEPS)
        keys = ["loss", "grad_norm"] + (
            ["utt_loss", "chunk_loss", "simu_l1"] if kind == "chunk" else [])
        for k in keys:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4,
                                       equal_nan=True, err_msg=f"{k} {i}")
        if i < STEPS:
            for n, p in port.named_parameters():
                noisy[n] |= np.abs(p.grad.numpy()) <= NOISE
        got = {n: p.detach().numpy() for n, p in port.named_parameters()}
        wantp = {n: v.numpy() for n, v in conv(params, stats).items()
                 if n in names}
        _equal(got, wantp, f"params after step {i + 1}", noisy=noisy)
        for n in names:  # a noise-level element moves within lr a step
            assert (np.abs(got[n] - old[n])[noisy[n]]
                    <= (i + 1) * LR * (1 + 1e-4)).all(), n
        buffers = {n: b_.numpy() for n, b_ in port.named_buffers()
                   if n.endswith(("running_mean", "running_var"))}
        assert buffers
        want_stats = {n: v.numpy() for n, v in conv(params, stats).items()
                      if n in buffers}
        if i == 0:
            _equal(buffers, want_stats, "statistics after step 1", tol=1e-5)
        for n, w in want_stats.items():
            # later means follow the depthwise biases, whose gradient is
            # noise (batch norm cancels it): within lr a step
            np.testing.assert_array_equal(np.isnan(buffers[n]), np.isnan(w))
            tol = 1e-4 if n.endswith("var") else (i + 1) * LR
            np.testing.assert_allclose(buffers[n], w, rtol=1e-4, atol=tol,
                                       equal_nan=True, err_msg=n)
        osd = opt.state_dict()
        assert all(int(st["step"]) == count for st in osd["state"].values())
        for what, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            ref = {n: v.numpy() for n, v in conv(tree, stats).items()
                   if n in names}
            got_m = {n: opt.state[p][what].numpy()
                     for n, p in port.named_parameters()}
            _equal(got_m, ref, f"Adam {what} after step {i + 1}",
                   noisy=noisy)
    assert state.step == STEPS + 1 and state.skipped == 1
    # the poisoned pass's statistics are kept, as in JAX
    assert not all(np.isfinite(b_.numpy()).all() for n, b_ in
                   port.named_buffers() if n.endswith("running_var"))


@pytest.mark.parametrize("kind,mode", [("plain", "offline"),
                                       ("chunk", "offline"),
                                       ("chunk", "streaming")])
def test_decoder_matches_jax(request, kind, mode):
    s = request.getfixturevalue(kind)
    params = dict(s["params"])
    enc = dict(params["encoder"])
    enc["classifier"] = {k: v * 4.0 for k, v in enc["classifier"].items()}
    params["encoder"] = enc
    port = _port(s["kind"], params, s["stats"])
    b = batch(2)
    wave = np.ascontiguousarray(b["feats"].transpose(0, 2, 1))
    for beam in (1, 4):
        dec = decode_me2e.make_me2e_decoder(port, mode, beam_width=beam,
                                            channels_last=True)
        jdec = jax_decode.make_me2e_decoder(
            s["jm"], params, s["stats"], mode, beam_width=beam,
            channels_last=True)
        got = dec(wave, LENS, nbest=4, max_len=16)
        want = jdec(wave, LENS, nbest=4, max_len=16)
        for g, w in zip(got, want):
            assert [h for _, h in g] == [h for _, h in w], (beam, g, w)
            np.testing.assert_allclose([x for x, _ in g], [x for x, _ in w],
                                       rtol=1e-4, atol=1e-4)


def test_checkpoints_of_either_package_load(setup, tmp_path):
    s = setup
    kind = s["kind"]
    state = JaxTrainState(params=s["params"], batch_stats=s["stats"],
                          opt_state=s["tx"].init(s["params"]),
                          step=jnp.asarray(0))
    ckpt = JaxCkpt(str(tmp_path / "jax"))
    ckpt.save({"state": state}, 1.0, 1, 1)
    port = TASK[kind].build_model(CFGS[kind], V, device="cpu", seed=3)
    want = _port(kind, s["params"], s["stats"]).state_dict()
    got = model_weights(port, ckpt.path(ckpt.best()))
    assert set(got) == set(port.state_dict())
    for n, t in got.items():
        torch.testing.assert_close(t, want[n], rtol=0, atol=0)
    save_checkpoint(str(tmp_path / "port.pt"), {"state": {
        "model": want, "optimizer": {}, "step": 0, "skipped": 0,
        "fold": None}})
    port.load_state_dict(model_weights(port, str(tmp_path / "port.pt")))
    for n, t in port.state_dict().items():
        torch.testing.assert_close(t, want[n], rtol=0, atol=0)


def _manifest(d, rng):
    """wav.scp + text of three sources: 2 channels, mono, 3 channels."""
    from cat_tpu_torch.utils.audio import write_wav
    os.makedirs(d / "wav")
    scp, text = [], []
    for i, ch in enumerate((2, 1, 3)):
        w = rng.uniform(-0.5, 0.5, (3000 + 500 * i, ch)).astype(np.float32)
        path = d / "wav" / f"u{i}.wav"
        write_wav(str(path), w[:, 0] if ch == 1 else w, SR)
        scp.append(f"u{i} {path}")
        text.append(f"u{i} yes no")
    (d / "wav.scp").write_text("\n".join(scp) + "\n")
    (d / "text").write_text("\n".join(text) + "\n")


def test_data_prep_channels_matches_jax(tmp_path):
    from cat_tpu.utils import data_prep as jax_prep
    from cat_tpu.utils.data import SpeechDataset
    from cat_tpu_torch.utils import data_prep
    from cat_tpu_torch.utils import tokenizer as tknz

    d = tmp_path / "manifest"
    _manifest(d, np.random.default_rng(0))
    tok_path = tmp_path / "tok.tknz"
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("yes no\n")
    tknz.initialize({"type": "SimpleTokenizer", "option-init": {
        "level": "word", "corpus": str(corpus)}}).save(str(tok_path))
    args = [str(d), None, "--tokenizer", str(tok_path), "--channels", "2",
            "--speed-perturb", "0.9"]
    jax_prep.main([args[0], str(tmp_path / "jax")] + args[2:])
    data_prep.main([args[0], str(tmp_path / "port")] + args[2:]
                   + ["--device", "cpu"])
    want = SpeechDataset(str(tmp_path / "jax"))
    got = SpeechDataset(str(tmp_path / "port"))
    assert got.uids == want.uids and len(got) == 6 and got.feat_dim == 2
    for i in range(len(want)):
        (gf, gl), (wf, wl) = got[i], want[i]
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gl, wl)
    mono = got[got.uids.index("u1")][0]
    np.testing.assert_array_equal(mono[:, 0], mono[:, 1])


def _me2e_corpus(root, n_train=8, n_dev=4):
    """A 2-channel yes/no corpus as egs/template/local/make_data_me2e.py
    writes it: channel 1 is channel 0 two samples later with more noise."""
    sys.path.insert(0, os.path.join(REPO, "egs", "template", "local"))
    import make_data

    from cat_tpu_torch.utils.audio import write_wav
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("dev", n_dev)):
        d = root / split
        os.makedirs(d / "wav")
        scp, text = [], []
        for i in range(n):
            words = list(rng.choice(["yes", "no"],
                                    size=int(rng.integers(1, 4))))
            mono = make_data.make_utt(rng, words)
            ch1 = np.roll(mono, 2) + rng.standard_normal(len(mono)).astype(
                np.float32) * 0.02
            uid = f"{split}_{i:03d}"
            path = d / "wav" / (uid + ".wav")
            write_wav(str(path), np.stack([mono, ch1], 1), make_data.SR)
            scp.append(f"{uid} {path}")
            text.append(f"{uid} {' '.join(words)}")
        (d / "wav.scp").write_text("\n".join(scp) + "\n")
        (d / "text").write_text("\n".join(text) + "\n")


def test_template_asr_me2e_four_stages_on_the_cpu(tmp_path):
    from cat_tpu_torch.pipeline import asr
    from cat_tpu_torch.utils.data import SpeechDataset

    data = tmp_path / "data"
    _me2e_corpus(data)
    src = os.path.join(REPO, "egs", "template", "exp", "asr-me2e")
    expdir = tmp_path / "exp"
    os.makedirs(expdir)
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    hyper["data"] = {"train": str(data / "train"), "dev": str(data / "dev")}
    hyper["train"]["option"]["max_epochs"] = 2
    (expdir / "hyper-p.json").write_text(json.dumps(hyper))
    with open(os.path.join(src, "config.json")) as f:
        (expdir / "config.json").write_text(f.read())
    asr.main([str(expdir), "--device", "cpu"])
    for name in ("tokenizer.tknz", "pkl/train/meta.npz", "pkl/dev/meta.npz",
                 "check/checkpoint.list", "check/metrics.jsonl", "readme.md",
                 "decode_dev.txt", "nbest_dev.pkl", "wer_dev.json"):
        assert os.path.exists(expdir / name), name
    ds = SpeechDataset(str(expdir / "pkl" / "dev"))
    assert ds.feat_dim == 2 and len(ds) == 4
    lines = (expdir / "decode_dev.txt").read_text().splitlines()
    assert len(lines) == 4
    res = json.loads((expdir / "wer_dev.json").read_text())
    assert np.isfinite(res["wer"]) and res["rtf"] > 0
