"""Port parity: `cat_tpu_torch.utils.data` against `cat_tpu.utils.data`.

- `pack_speech_data` writes the same split: `feats.bin` and `uids.txt`
  byte for byte, every array of `meta.npz` equal with the same dtype (the
  zip container itself carries write times, so it is not compared byte
  for byte); either package's `SpeechDataset` reads the other's split.
- `make_buckets` gives the same edges.
- `BucketedLoader`: the same buckets, batch sizes, label caps and
  `num_batches`, and every batch's arrays, weights and uids exactly equal
  for epochs 1 and 2, with shuffle on and off, `multiple_of` > 1, two
  hosts (each host's slice), `max_label_len` and `drop_infeasible`.
"""
import os

import numpy as np
import pytest

from cat_tpu.utils import data as jax_data
from cat_tpu_torch.utils import data as port_data


class _Tok:
    """A tokenizer stand-in: one id per character."""

    def encode(self, text):
        return [ord(c) - ord("a") + 1 for c in text]


def _utterances(n=40, seed=0, dim=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = int(rng.integers(12, 90))
        feats = rng.standard_normal((T, dim)).astype(np.float32)
        U = int(rng.integers(1, max(T // 5, 2) + 2))
        trans = ("".join(chr(ord("a") + int(c)) for c in
                         rng.integers(0, 20, U)) if i % 3 == 0
                 else [int(c) for c in rng.integers(1, 30, U)])
        out.append((f"utt{i:03d}", feats, trans))
    return out


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("splits")
    utts = _utterances()
    return (jax_data.pack_speech_data(str(root / "jax"), utts, _Tok()),
            port_data.pack_speech_data(str(root / "port"), utts, _Tok()))


def test_pack_speech_data_writes_the_same_split(splits):
    jdir, pdir = splits
    for name in ("feats.bin", "uids.txt"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    jm = np.load(os.path.join(jdir, "meta.npz"))
    pm = np.load(os.path.join(pdir, "meta.npz"))
    assert sorted(jm.files) == sorted(pm.files)
    for k in jm.files:
        assert jm[k].dtype == pm[k].dtype, k
        np.testing.assert_array_equal(jm[k], pm[k], err_msg=k)
    a, b = jax_data.SpeechDataset(pdir), port_data.SpeechDataset(jdir)
    assert a.uids == b.uids and len(a) == len(b)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)


def test_make_buckets_matches_jax():
    rng = np.random.default_rng(3)
    for n_b in (1, 2, 5, 8):
        lens = rng.integers(5, 3000, int(rng.integers(3, 400)))
        assert port_data.make_buckets(lens, n_b) == \
            jax_data.make_buckets(lens, n_b)
        assert port_data.make_buckets(lens, n_b, min_len=64) == \
            jax_data.make_buckets(lens, n_b, min_len=64)


OPTIONS = {
    "shuffled": dict(frame_budget=400, num_buckets=3),
    "ordered": dict(frame_budget=400, num_buckets=3, shuffle=False),
    "multiple_of": dict(frame_budget=300, num_buckets=4, multiple_of=3,
                        seed=5),
    "host0_of_2": dict(frame_budget=500, num_buckets=2, host_count=2,
                       host_index=0),
    "host1_of_2": dict(frame_budget=500, num_buckets=2, host_count=2,
                       host_index=1, multiple_of=3),
    "caps": dict(frame_budget=350, num_buckets=3, max_label_len=4,
                 drop_infeasible=False),
    "divisor": dict(frame_budget=350, num_buckets=2, feasibility_divisor=8),
}


@pytest.mark.parametrize("opt", sorted(OPTIONS))
def test_bucketed_loader_matches_jax(splits, opt):
    kw = OPTIONS[opt]
    jdir, pdir = splits
    j = jax_data.BucketedLoader(jax_data.SpeechDataset(jdir), **kw)
    p = port_data.BucketedLoader(port_data.SpeechDataset(pdir), **kw)
    np.testing.assert_array_equal(p.indices, j.indices)
    assert p.buckets == j.buckets
    assert p.batch_sizes == j.batch_sizes
    assert p.label_caps == j.label_caps
    assert p.multiple_of == j.multiple_of
    assert p.num_batches() == j.num_batches()
    for epoch in (1, 2):
        jb, pb = list(j.epoch(epoch)), list(p.epoch(epoch))
        assert len(pb) == len(jb) == j.num_batches()
        for a, b in zip(pb, jb):
            assert a.uids == b.uids
            da, db = a.asdict(), b.asdict()
            assert sorted(da) == sorted(db)
            for k in db:
                assert da[k].dtype == db[k].dtype, k
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    if kw.get("shuffle", True):
        assert [b.uids for b in p.epoch(1)] != [b.uids for b in p.epoch(2)]
