"""Port parity for sharded streaming data: `cat_tpu_torch.utils.
data_sharded` against `cat_tpu.utils.data_sharded`, on the CPU.

- The three cases of `tests/test_sharded.py` on the port: shard count
  and brace/glob expansion, host split coverage, static batch shapes.
- Shards written by either package read array for array equal in the
  other (exactly).
- `ShardedSpeechDataset.epoch(i)`: the items, in order, equal to JAX's,
  for seeds 0 and 1, host splits (0, 1), (0, 2) and (1, 2) and shuffle
  buffers 1, 4 and 256.
- `StreamingBucketLoader`: every batch equal to JAX's (every array, the
  uids, the weight-0 repeats), on items that include ones longer than
  the largest bucket, infeasible ones (frames // 4 <= labels) and labels
  past their bucket's cap; the port's counts of each.
- A corrupt shard raises in the consumer; a consumer that stops early
  stops the thread.
- `python -m cat_tpu_torch.utils.data_prep --format shards` against JAX's
  CLI: the same shard files, uids, offsets and labels, features within
  1e-3 + 1e-4·|x| (the tolerance of `tests/test_torch_data_prep.py`).
- The Manager over shards: a run resumed from its mid-epoch checkpoint
  gives the uninterrupted run's batches and ends with its train state bit
  for bit.
"""
import os
import threading

import numpy as np
import pytest
import torch

from cat_tpu.utils import data_prep as jax_prep
from cat_tpu.utils import data_sharded as jax_sh
from cat_tpu.utils.audio import write_wav
from cat_tpu.utils.tokenizer import SimpleTokenizer
from cat_tpu_torch.ctc import train
from cat_tpu_torch.utils import data, data_prep
from cat_tpu_torch.utils.checkpoint import CheckpointManager
from cat_tpu_torch.utils.data_sharded import (ShardedSpeechDataset,
                                              StreamingBucketLoader,
                                              expand_shards, write_shards)
from cat_tpu_torch.utils.manager import Manager
from cat_tpu_torch.utils.scheduler import build_scheduler

torch.set_num_threads(2)
KEYS = ("feats", "offsets", "labels", "label_offsets", "uids")


def make_utts(n, dim=8, seed=0, frames=(40, 200), labels=(2, 8)):
    rng = np.random.default_rng(seed)
    for i in range(n):
        T = int(rng.integers(*frames))
        feats = rng.standard_normal((T, dim)).astype(np.float32)
        lab = list(rng.integers(1, 5, size=int(rng.integers(*labels))))
        yield f"u{i:04d}", feats, lab


# ------------------------------------------- tests/test_sharded.py's cases

def test_write_and_expand(tmp_path):
    n = write_shards(str(tmp_path), make_utts(23), shard_size=10)
    assert n == 3
    shards = expand_shards(str(tmp_path / "shard-{000000..000002}.npz"))
    assert len(shards) == 3
    assert expand_shards(str(tmp_path / "shard-*.npz")) == shards


def test_host_split_and_coverage(tmp_path):
    write_shards(str(tmp_path), make_utts(40), shard_size=10)
    pattern = str(tmp_path / "shard-*.npz")
    seen = set()
    for host in range(2):
        ds = ShardedSpeechDataset(pattern, host_index=host, host_count=2,
                                  shuffle_buffer=8)
        for uid, f, l in ds.epoch(0):
            assert uid not in seen
            seen.add(uid)
    assert len(seen) == 40


def test_streaming_loader_static_shapes(tmp_path):
    write_shards(str(tmp_path), make_utts(60), shard_size=15)
    ds = ShardedSpeechDataset(str(tmp_path / "shard-*.npz"),
                              shuffle_buffer=16)
    loader = StreamingBucketLoader(ds, frame_budget=1600,
                                   buckets=(100, 200), feat_dim=8,
                                   multiple_of=4)
    shapes = set()
    count = 0
    for batch in loader.epoch(0):
        assert isinstance(batch, data.Batch)
        shapes.add(batch.feats.shape)
        assert batch.feats.shape[0] % 4 == 0
        count += int(batch.weight.sum())
    assert len(shapes) <= 2
    assert count > 40  # most utterances feasible and bucketed


# ------------------------------------------------------------- vs JAX

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_read_equal_in_both_packages(tmp_path, writer):
    write = write_shards if writer == "port" else jax_sh.write_shards
    tok = SimpleTokenizer.from_corpus(["ab c", "ba c"], level="char")
    utts = [(u, f, "ab c" if i % 2 else l) for i, (u, f, l) in
            enumerate(make_utts(23, seed=3))]
    assert write(str(tmp_path / "a"), utts, tok, shard_size=10) == 3
    other = jax_sh.write_shards if writer == "port" else write_shards
    other(str(tmp_path / "b"), utts, tok, shard_size=10)
    for name in sorted(os.listdir(tmp_path / "a")):
        with np.load(tmp_path / "a" / name) as a, \
                np.load(tmp_path / "b" / name) as b:
            assert sorted(a.files) == sorted(b.files) == sorted(KEYS)
            for k in KEYS:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pattern = str(tmp_path / "a" / "shard-*.npz")
    got = list(ShardedSpeechDataset(pattern, shuffle_buffer=4).epoch(0))
    want = list(jax_sh.ShardedSpeechDataset(pattern,
                                            shuffle_buffer=4).epoch(0))
    _same_items(got, want)


def _same_items(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gf, gl), (_, wf, wl) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gl, wl)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """47 utterances in 5 shards: some longer than the largest bucket
    (160), some infeasible, some with labels past their bucket's cap."""
    root = tmp_path_factory.mktemp("shards")
    write_shards(str(root), make_utts(47, seed=5, frames=(20, 190),
                                      labels=(1, 40)), shard_size=10)
    return str(root / "shard-*.npz")


@pytest.mark.parametrize("buffer", [1, 4, 256])
@pytest.mark.parametrize("host", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_epoch_order_matches_jax(shards, seed, host, buffer):
    kw = dict(host_index=host[0], host_count=host[1], shuffle_buffer=buffer,
              seed=seed)
    ds = ShardedSpeechDataset(shards, **kw)
    jds = jax_sh.ShardedSpeechDataset(shards, **kw)
    for epoch in (0, 3):
        _same_items(list(ds.epoch(epoch)), list(jds.epoch(epoch)))


@pytest.mark.parametrize("caps", [None, [6, 9, 30]])
def test_loader_batches_match_jax(shards, caps):
    kw = dict(frame_budget=400, buckets=(60, 110, 160), label_caps=caps,
              feat_dim=8)
    ds = ShardedSpeechDataset(shards, shuffle_buffer=8, seed=2)
    loader = StreamingBucketLoader(ds, **kw)
    want = list(jax_sh.StreamingBucketLoader(
        jax_sh.ShardedSpeechDataset(shards, shuffle_buffer=8, seed=2),
        **kw).epoch(1))
    got = list(loader.epoch(1))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert g.uids == w.uids
        for k in ("feats", "feat_lengths", "labels", "label_lengths",
                  "weight"):
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert any((b.weight == 0).any() for b in got)  # weight-0 repeats
    # the counts against the items themselves
    items = list(ds.epoch(1))
    caps = loader.label_caps
    too_long = [u for u, f, l in items if len(f) > 160]
    infeasible = [u for u, f, l in items if len(f) // 4 <= len(l)]
    kept = {u: (f, l) for u, f, l in items
            if len(f) // 4 > len(l) and len(f) <= 160}
    cut = [u for u, (f, l) in kept.items()
           if len(l) > caps[loader._bucket_of(len(f))]]
    assert sorted(u for b in got for u in b.uids) == sorted(kept)
    assert too_long and infeasible and cut
    assert loader.stats == {"items": 47, "infeasible": len(infeasible),
                            "too_long": len([u for u in too_long
                                             if u not in infeasible]),
                            "labels_cut": len(cut)}


def test_a_corrupt_shard_raises_in_the_consumer(tmp_path):
    write_shards(str(tmp_path), make_utts(30), shard_size=10)
    with open(tmp_path / "shard-000001.npz", "wb") as f:
        f.write(b"not an npz archive")
    loader = StreamingBucketLoader(
        ShardedSpeechDataset(str(tmp_path / "shard-*.npz"),
                             shuffle_shards=False, shuffle_buffer=1),
        frame_budget=400, buckets=(100, 200), feat_dim=8)
    before = threading.active_count()
    seen = []
    with pytest.raises(Exception, match="pickle|zip|npz|load"):
        for b in loader.epoch(0):
            seen.append(b)
    assert threading.active_count() == before
    # a consumer that stops early stops the producer too
    it = StreamingBucketLoader(
        ShardedSpeechDataset(str(tmp_path / "shard-000000.npz")),
        frame_budget=40, buckets=(200,), feat_dim=8, prefetch=1).epoch(0)
    next(it)
    it.close()
    assert threading.active_count() == before


def _tone(path, seconds, freq, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * freq * t) + 0.01 * rng.standard_normal(
        t.shape)
    write_wav(str(path), x.astype(np.float32), sr)


def test_data_prep_shards_match_jax(tmp_path):
    d = tmp_path / "manifest"
    d.mkdir()
    scp, text = [], []
    for r in range(5):
        _tone(d / f"r{r}.wav", 0.5 + 0.2 * r, 300 + 100 * r, 8000, r)
        scp.append(f"r{r} {d / f'r{r}.wav'}")
        text.append(f"r{r} ab c{'a' * r}")
    (d / "wav.scp").write_text("\n".join(scp) + "\n")
    (d / "text").write_text("\n".join(text) + "\n")
    tok = SimpleTokenizer.from_corpus(["ab c", "ca"], level="char")
    tok.save(str(tmp_path / "tok.tknz"))
    args = [str(d), "--tokenizer", str(tmp_path / "tok.tknz"), "--format",
            "shards", "--shard-size", "2", "--num-mel-bins", "40"]
    jax_prep.main([args[0], str(tmp_path / "jax")] + args[1:])
    data_prep.main([args[0], str(tmp_path / "port")] + args[1:]
                   + ["--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 3
    for name in names:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            for k in ("offsets", "labels", "label_offsets", "uids"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            err = np.abs(a["feats"] - b["feats"])
            assert a["feats"].shape == b["feats"].shape
            assert (err <= 1e-3 + 1e-4 * np.abs(b["feats"])).all()


# ----------------------------------------------------- Manager over shards

def _manager(tmp_path, name, seed, shard_dir, dev_dir):
    model = train.build_model({"encoder": {"type": "LSTM", "kwargs": dict(
        hdim=8, num_layers=2, dropout_rate=0.1, idim=8)}}, 5,
        device="cpu", seed=seed)
    sched, opt = build_scheduler(
        {"type": "SchedulerNoam", "kwargs": {
            "dim_model": 8, "warmup_step": 10, "stop_step": 1000,
            "peak_factor": 2.0},
         "optimizer": {"type": "Adam", "kwargs": {"betas": [0.9, 0.98]}}},
        model.parameters())
    seen = []

    def transform(batch):
        seen.append(list(batch.uids))
        return batch.asdict()

    loader = StreamingBucketLoader(
        ShardedSpeechDataset(str(shard_dir / "shard-*.npz"),
                             shuffle_buffer=6, seed=0),
        frame_budget=400, buckets=(100, 200), feat_dim=8)
    mgr = Manager(
        train.make_train_step(model, opt, "ctc"),
        train.make_eval_step(model, "ctc"), train.init_state(model, opt),
        sched, CheckpointManager(str(tmp_path / name), keep_last=100),
        loader, data.BucketedLoader(data.SpeechDataset(str(dev_dir)),
                                    shuffle=False, frame_budget=400,
                                    num_buckets=1),
        gen=torch.Generator().manual_seed(11), max_epochs=2, check_freq=3,
        verbose=False, batch_transform=transform)
    return mgr, seen


def test_mid_epoch_resume_over_shards_is_bitwise(tmp_path):
    write_shards(str(tmp_path / "shards"), make_utts(40, seed=7),
                 shard_size=8)
    data.pack_speech_data(str(tmp_path / "dev"), make_utts(6, seed=8))
    a, seen_a = _manager(tmp_path, "a", 0, tmp_path / "shards",
                         tmp_path / "dev")
    at = {}
    save = a.save

    def save_and_note(metric):
        name = save(metric)
        if a.global_step == 3:
            at.update(path=a.ckpt.path(name), gen=a.gen.get_state(),
                      batches=len(seen_a))
        return name

    a.save = save_and_note
    a.run()
    assert a.global_step > 6 and at["batches"] > 3

    b, seen_b = _manager(tmp_path, "b", 7, tmp_path / "shards",
                         tmp_path / "dev")
    b.resume(at["path"])
    assert (b.global_step, b.epoch) == (3, 0)
    b.gen.set_state(at["gen"])
    b.run()
    assert (b.global_step, b.epoch) == (a.global_step, a.epoch)
    assert seen_b == seen_a[at["batches"]:]
    assert b.ckpt.entries == a.ckpt.entries[1:]
    sa, sb = a.state.state_dict(), b.state.state_dict()
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
