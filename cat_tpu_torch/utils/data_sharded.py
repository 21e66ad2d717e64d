"""Sharded streaming speech data for large corpora (counterpart of
`cat_tpu/utils/data_sharded.py`).

A shard is an .npz archive: `feats` (all frames, float32), `offsets`,
`labels` (int32), `label_offsets` and `uids`, the JAX package's layout, so
either package reads the other's shards. An epoch streams host split
(shards[host_index::host_count]) -> shard shuffle -> shuffle buffer ->
fixed frame buckets, with the random draws of the JAX package call for
call (`np.random.default_rng(seed + epoch)`), so both packages give the
same items and batches in the same order. A background thread reads and
collates ahead of the training step, on the host only (numpy, no CUDA
call); an exception there is handed to the consumer and raised from its
loop, not taken for the end of the epoch.
"""
from __future__ import annotations

import glob
import os
import queue
import re
import threading

import numpy as np

from cat_tpu_torch.utils.data import Batch


def write_shards(out_dir, utterances, tokenizer=None, shard_size=500,
                 prefix="shard"):
    """utterances: iterable of (uid, feats (T, F) float32, transcript str or
    ids). Writes {prefix}-NNNNNN.npz files; returns the shard count."""
    os.makedirs(out_dir, exist_ok=True)
    buf, shard_idx = [], 0

    def flush():
        nonlocal buf, shard_idx
        if not buf:
            return
        feats = np.concatenate([u[1] for u in buf]).astype(np.float32)
        offsets = np.cumsum([0] + [u[1].shape[0] for u in buf])
        labels_flat, label_offsets = [], [0]
        for u in buf:
            ids = (tokenizer.encode(u[2]) if isinstance(u[2], str)
                   else list(u[2]))
            labels_flat.extend(ids)
            label_offsets.append(label_offsets[-1] + len(ids))
        np.savez(os.path.join(out_dir, f"{prefix}-{shard_idx:06d}.npz"),
                 feats=feats, offsets=offsets,
                 labels=np.asarray(labels_flat, np.int32),
                 label_offsets=np.asarray(label_offsets, np.int64),
                 uids=np.asarray([u[0] for u in buf]))
        buf = []
        shard_idx += 1

    for utt in utterances:
        buf.append(utt)
        if len(buf) >= shard_size:
            flush()
    flush()
    return shard_idx


def expand_shards(pattern):
    """The shard paths of a brace pattern ('shard-{000000..000009}.npz')
    or, sorted, of a glob."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [pattern[:m.start()] + str(i).zfill(width)
                + pattern[m.end():] for i in range(int(lo), int(hi) + 1)]
    return sorted(glob.glob(pattern))


def shard_pattern(path):
    """A shard directory as its `shard-*.npz` glob; a pattern as it is."""
    path = str(path)
    return os.path.join(path, "shard-*.npz") if os.path.isdir(path) else path


class ShardedSpeechDataset:
    """Iterator-style dataset over npz shards; `epoch(i)` yields (uid,
    feats (T, F), labels (U,)). Host split: shards[host_index::host_count]."""

    def __init__(self, pattern, host_index=0, host_count=1,
                 shuffle_shards=True, shuffle_buffer=256, seed=0):
        self.shards = expand_shards(pattern)
        if not self.shards:
            raise FileNotFoundError(pattern)
        self.host_index = host_index
        self.host_count = host_count
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed

    def epoch(self, epoch_idx):
        rng = np.random.default_rng(self.seed + epoch_idx)
        shards = list(self.shards[self.host_index::self.host_count])
        if self.shuffle_shards:
            rng.shuffle(shards)
        buf = []
        for path in shards:
            with np.load(path, allow_pickle=False) as z:
                feats, offs = z["feats"], z["offsets"]
                labels, loffs = z["labels"], z["label_offsets"]
                uids = z["uids"]
            for i in range(len(offs) - 1):
                buf.append((str(uids[i]), feats[offs[i]:offs[i + 1]],
                            labels[loffs[i]:loffs[i + 1]]))
                if len(buf) >= self.shuffle_buffer:
                    yield buf.pop(int(rng.integers(0, len(buf))))
        rng.shuffle(buf)
        yield from buf


class _Raised:
    """An exception of the producer thread, on its way to the consumer."""

    def __init__(self, exc):
        self.exc = exc


_END = object()


class StreamingBucketLoader:
    """Fixed-shape bucket batching over a sharded stream, with prefetch.

    The buckets are fixed frame edges (default 400/800/1200/1700), a
    bucket's batch size max(frame_budget // edge, 1) rounded down to a
    multiple of `multiple_of`, its label cap max(8, edge // 8) unless
    `label_caps` is given. Items longer than the largest bucket are
    dropped, and with `drop_infeasible` those with frames // 4 <= labels;
    labels past their bucket's cap are cut, as in the JAX package, and
    counted. A short batch is filled by cycling its real items with
    weight 0. `stats` counts the last epoch's items: "items" read,
    "too_long" and "infeasible" dropped, "labels_cut"."""

    def __init__(self, dataset, frame_budget=40000,
                 buckets=(400, 800, 1200, 1700), label_caps=None,
                 multiple_of=1, feat_dim=80, prefetch=4,
                 drop_infeasible=True):
        self.ds = dataset
        self.buckets = list(buckets)
        self.label_caps = label_caps or [max(8, b // 8)
                                         for b in self.buckets]
        self.batch_sizes = []
        for edge in self.buckets:
            bs = max(frame_budget // edge, 1)
            bs = max((bs // multiple_of) * multiple_of, multiple_of)
            self.batch_sizes.append(bs)
        self.feat_dim = feat_dim
        self.prefetch = prefetch
        self.drop_infeasible = drop_infeasible
        self.stats = {}

    def _bucket_of(self, length):
        for b, edge in enumerate(self.buckets):
            if length <= edge:
                return b
        return None  # too long: dropped

    def _collate(self, items, b, stats):
        B, T = self.batch_sizes[b], self.buckets[b]
        U, F = self.label_caps[b], self.feat_dim
        feats = np.zeros((B, T, F), np.float32)
        labels = np.zeros((B, U), np.int32)
        flen = np.zeros((B,), np.int32)
        llen = np.zeros((B,), np.int32)
        weight = np.zeros((B,), np.float32)
        real = len(items)
        uids = []
        for j in range(B):
            uid, f, l = items[j % real]
            t = min(f.shape[0], T)
            u = min(len(l), U)
            feats[j, :t] = f[:t]
            labels[j, :u] = l[:u]
            flen[j], llen[j] = t, u
            if j < real:
                weight[j] = 1.0
                uids.append(uid)
                stats["labels_cut"] += int(len(l) > U)
        return Batch(feats, flen, labels, llen, weight, uids=uids)

    def batches(self, epoch_idx):
        """The batches of epoch `epoch_idx`, read and collated in the
        calling thread; `stats` counts as they go."""
        stats = self.stats = dict.fromkeys(
            ("items", "too_long", "infeasible", "labels_cut"), 0)
        pools = [[] for _ in self.buckets]
        for item in self.ds.epoch(epoch_idx):
            stats["items"] += 1
            _, f, l = item
            if self.drop_infeasible and f.shape[0] // 4 <= len(l):
                stats["infeasible"] += 1
                continue
            b = self._bucket_of(f.shape[0])
            if b is None:
                stats["too_long"] += 1
                continue
            pools[b].append(item)
            if len(pools[b]) == self.batch_sizes[b]:
                yield self._collate(pools[b], b, stats)
                pools[b] = []
        for b, pool in enumerate(pools):
            if pool:
                yield self._collate(pool, b, stats)

    def _producer(self, epoch_idx, q, stop):
        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            for batch in self.batches(epoch_idx):
                if not put(batch):
                    return
        except Exception as exc:  # handed to the consumer, raised there
            put(_Raised(exc))
            return
        put(_END)

    def epoch(self, epoch_idx):
        """The batches of epoch `epoch_idx`, collated `prefetch` ahead in a
        thread. The thread stops when the consumer stops iterating."""
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        th = threading.Thread(target=self._producer,
                              args=(epoch_idx, q, stop), daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, _Raised):
                    raise item.exc
                yield item
        finally:
            stop.set()
            th.join()

    def __iter__(self):
        return self.epoch(0)
