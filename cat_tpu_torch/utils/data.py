"""Packed speech datasets and bucketed batching (counterpart of
`pack_speech_data`, `SpeechDataset`, `make_buckets`, `Batch` and
`BucketedLoader` in `cat_tpu/utils/data.py`).

A split directory holds `meta.npz` (frame and label offsets, the flat
labels, the feature width), `feats.bin` (one flat float32 memmap of all
frames) and `uids.txt`; both packages write and read the same format.
`BucketedLoader` groups utterances into a fixed set of (frames, labels,
batch size) shapes and pads a short batch by repeating its utterances
with weight 0. The epoch order comes from `np.random.default_rng(seed +
epoch)`, as in the JAX package, so both packages make the same batches.
The batches are numpy arrays on the host; the `Manager` puts them on the
model's device. `WeightedConcatDataset`, `CorpusDataset` and the
seq2seq datasets wait for the ME2E, LM and P2G slices (ROADMAP.md).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def pack_speech_data(out_dir, utterances, tokenizer=None):
    """Pack features and transcripts into `out_dir`.

    utterances: iterable of (uid, feats (T, F) float32, transcript), the
    transcript a string (encoded by `tokenizer`) or a list of ids."""
    os.makedirs(out_dir, exist_ok=True)
    feat_offsets = [0]
    label_offsets = [0]
    labels_flat = []
    uids = []
    feat_dim = None
    with open(os.path.join(out_dir, "feats.bin"), "wb") as fbin:
        for uid, feats, trans in utterances:
            feats = np.ascontiguousarray(feats, np.float32)
            if feat_dim is None:
                feat_dim = feats.shape[1]
            if feats.shape[1] != feat_dim:
                raise ValueError(f"{uid}: {feats.shape[1]} features, the "
                                 f"split has {feat_dim}")
            fbin.write(feats.tobytes())
            feat_offsets.append(feat_offsets[-1] + feats.shape[0])
            ids = tokenizer.encode(trans) if isinstance(trans, str) \
                else list(trans)
            labels_flat.extend(ids)
            label_offsets.append(label_offsets[-1] + len(ids))
            uids.append(uid)
    np.savez(os.path.join(out_dir, "meta.npz"),
             feat_offsets=np.asarray(feat_offsets, np.int64),
             label_offsets=np.asarray(label_offsets, np.int64),
             labels=np.asarray(labels_flat, np.int32),
             feat_dim=np.int32(feat_dim or 0))
    with open(os.path.join(out_dir, "uids.txt"), "w") as f:
        f.write("\n".join(uids))
    return out_dir


class SpeechDataset:
    """Memmap-backed packed dataset: __getitem__ -> (feats, labels)."""

    def __init__(self, path):
        meta = np.load(os.path.join(path, "meta.npz"))
        self.feat_offsets = meta["feat_offsets"]
        self.label_offsets = meta["label_offsets"]
        self.labels = meta["labels"]
        self.feat_dim = int(meta["feat_dim"])
        self.feats = np.memmap(os.path.join(path, "feats.bin"),
                               dtype=np.float32, mode="r").reshape(
                                   -1, self.feat_dim)
        with open(os.path.join(path, "uids.txt")) as f:
            self.uids = f.read().splitlines()

    def __len__(self):
        return len(self.feat_offsets) - 1

    def frame_length(self, i):
        return int(self.feat_offsets[i + 1] - self.feat_offsets[i])

    def label_length(self, i):
        return int(self.label_offsets[i + 1] - self.label_offsets[i])

    def __getitem__(self, i):
        f = self.feats[self.feat_offsets[i]:self.feat_offsets[i + 1]]
        l = self.labels[self.label_offsets[i]:self.label_offsets[i + 1]]
        return np.asarray(f), np.asarray(l)


def make_buckets(lengths, num_buckets=8, min_len=16):
    """Bucket edges (frame counts) at the quantiles of `lengths`, rounded
    up to multiples of 16; the last covers the longest."""
    lengths = np.asarray(lengths)
    qs = np.quantile(lengths, np.linspace(0, 1, num_buckets + 1)[1:])
    edges = sorted(set(int(np.ceil(q / 16.0)) * 16 for q in qs))
    if edges and edges[-1] < lengths.max():
        edges[-1] = int(np.ceil(lengths.max() / 16.0)) * 16
    return [max(e, min_len) for e in edges]


@dataclass
class Batch:
    """Host-side batch, every array padded to its bucket's shape."""

    feats: np.ndarray          # (B, T, F) float32
    feat_lengths: np.ndarray   # (B,) int32
    labels: np.ndarray         # (B, U) int32
    label_lengths: np.ndarray  # (B,) int32
    weight: np.ndarray         # (B,) float32, 0 for padding repeats
    uids: list | None = None

    def asdict(self):
        return dict(feats=self.feats, feat_lengths=self.feat_lengths,
                    labels=self.labels, label_lengths=self.label_lengths,
                    weight=self.weight)


class BucketedLoader:
    """Bucketed batching with a fixed shape set.

    Every batch size is a multiple of lcm(multiple_of, host_count) and
    constant per bucket. With host_count > 1 every host makes the same
    global batches and keeps its contiguous slice of rows (host_index);
    the weights mark padding rows of the global batch. drop_infeasible
    leaves out utterances with frames // feasibility_divisor <= labels
    (CTC needs more output frames than labels; the divisor is the
    encoder's subsampling)."""

    def __init__(self, dataset, frame_budget=40000, num_buckets=8,
                 multiple_of=1, shuffle=True, seed=0, max_label_len=None,
                 drop_infeasible=True, host_index=0, host_count=1,
                 feasibility_divisor=4):
        self.ds = dataset
        self.host_index = int(host_index)
        self.host_count = max(int(host_count), 1)
        multiple_of = int(np.lcm(multiple_of, self.host_count))
        self.multiple_of = multiple_of
        self.shuffle = shuffle
        self.seed = seed
        n = len(dataset)
        self.flens = np.asarray([dataset.frame_length(i) for i in range(n)])
        self.llens = np.asarray([dataset.label_length(i) for i in range(n)])
        keep = np.ones(n, bool)
        if drop_infeasible:
            keep &= (self.flens // feasibility_divisor) > self.llens
        self.indices = np.nonzero(keep)[0]
        if len(self.indices) == 0:
            raise ValueError(
                f"no usable utterances: dataset has {n}, all filtered "
                "(CTC feasibility requires frames//4 > label_length)")
        self.buckets = make_buckets(self.flens[self.indices], num_buckets)
        self.batch_sizes = []
        self.label_caps = []
        for edge in self.buckets:
            bs = max(frame_budget // edge, 1)
            bs = max((bs // multiple_of) * multiple_of, multiple_of)
            self.batch_sizes.append(bs)
            in_bucket = self.indices[self.flens[self.indices] <= edge]
            cap = int(self.llens[in_bucket].max()) if len(in_bucket) else 1
            if max_label_len:
                cap = min(cap, max_label_len)
            self.label_caps.append(max(cap, 1))

    def bucket_of(self, length):
        for b, edge in enumerate(self.buckets):
            if length <= edge:
                return b
        return len(self.buckets) - 1

    def __iter__(self):
        return self.epoch(0)

    def epoch(self, epoch_idx):
        """The batches of epoch `epoch_idx`, in order, as a generator."""
        order = self.indices.copy()
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        pools = [[] for _ in self.buckets]
        for i in order:
            b = self.bucket_of(self.flens[i])
            pools[b].append(i)
            if len(pools[b]) == self.batch_sizes[b]:
                yield self._collate(pools[b], b)
                pools[b] = []
        for b, pool in enumerate(pools):
            if pool:
                yield self._collate(pool, b)

    def num_batches(self):
        pools = [0] * len(self.buckets)
        for i in self.indices:
            pools[self.bucket_of(self.flens[i])] += 1
        return sum((n + bs - 1) // bs
                   for n, bs in zip(pools, self.batch_sizes))

    def _collate(self, idxs, b):
        B, T, U = self.batch_sizes[b], self.buckets[b], self.label_caps[b]
        real = len(idxs)
        B_loc = B // self.host_count
        j0 = self.host_index * B_loc
        feats = np.zeros((B_loc, T, self.ds.feat_dim), np.float32)
        labels = np.zeros((B_loc, U), np.int32)
        flen = np.zeros((B_loc,), np.int32)
        llen = np.zeros((B_loc,), np.int32)
        weight = np.zeros((B_loc,), np.float32)
        local_uids = []
        for k in range(B_loc):
            j = j0 + k
            i = idxs[j % real]  # a short batch repeats its utterances
            f, l = self.ds[i]
            t = min(f.shape[0], T)
            u = min(len(l), U)
            feats[k, :t] = f[:t]
            labels[k, :u] = l[:u]
            flen[k] = t
            llen[k] = u
            weight[k] = 1.0 if j < real else 0.0
            if j < real:
                local_uids.append(self.ds.uids[i]
                                  if hasattr(self.ds, "uids") else str(i))
        return Batch(feats, flen, labels, llen, weight, uids=local_uids)
