"""Packed speech datasets, packed LM corpora and bucketed batching
(counterpart of `pack_speech_data`, `SpeechDataset`, `pack_corpus`,
`CorpusDataset`, `make_buckets`, `Batch` and `BucketedLoader` in
`cat_tpu/utils/data.py`).

A split directory holds `meta.npz` (frame and label offsets, the flat
labels, the feature width), `feats.bin` (one flat float32 memmap of all
frames) and `uids.txt`; both packages write and read the same format.
`BucketedLoader` groups utterances into a fixed set of (frames, labels,
batch size) shapes and pads a short batch by repeating its utterances
with weight 0. The epoch order comes from `np.random.default_rng(seed +
epoch)`, as in the JAX package, so both packages make the same batches.
The batches are numpy arrays on the host; the `Manager` puts them on the
model's device. An LM corpus is one `corpus.npz` (the flat token ids and
their offsets), the JAX package's file. A seq2seq split (P2G) is one
`seq2seq.npz` (sources, targets and the optional n-best candidates with
their scores, flat with offsets) and `uids.txt`, also the JAX package's
files; `Seq2SeqLoader` makes the JAX package's batches.
`WeightedConcatDataset` is not ported (ROADMAP.md §A.8).
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


def pack_corpus(out_dir, id_sequences):
    """Write the token id sequences to out_dir/corpus.npz: `tokens` (int32,
    flat) and `offsets` (int64, one more than sequences)."""
    os.makedirs(out_dir, exist_ok=True)
    offsets = [0]
    flat = []
    for ids in id_sequences:
        flat.extend(ids)
        offsets.append(offsets[-1] + len(ids))
    np.savez(os.path.join(out_dir, "corpus.npz"),
             tokens=np.asarray(flat, np.int32),
             offsets=np.asarray(offsets, np.int64))
    return out_dir


class CorpusDataset:
    """A packed LM corpus: item i is sequence i's token ids."""

    def __init__(self, path):
        with np.load(os.path.join(path, "corpus.npz")) as z:
            self.tokens = z["tokens"]
            self.offsets = z["offsets"]

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, i):
        return np.asarray(self.tokens[self.offsets[i]:self.offsets[i + 1]])

    def token_length(self, i):
        return int(self.offsets[i + 1] - self.offsets[i])


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


def pack_seq2seq(out_dir, pairs):
    """Pack paired token sequences (a P2G split) into `out_dir`.

    pairs: iterable of (uid, src_ids, tgt_ids) or (uid, src_ids, tgt_ids,
    nbest), nbest = [(score, cand_ids), ...], the candidate sets of TKM
    training and marginalised decoding."""
    os.makedirs(out_dir, exist_ok=True)
    src_off, tgt_off = [0], [0]
    src_flat, tgt_flat = [], []
    uids = []
    cand_utt_off, cand_off = [0], [0]
    cand_flat, cand_scores = [], []
    has_nbest = False
    for item in pairs:
        uid, src, tgt = item[0], item[1], item[2]
        nbest = item[3] if len(item) > 3 else None
        src_flat.extend(int(x) for x in src)
        tgt_flat.extend(int(x) for x in tgt)
        src_off.append(len(src_flat))
        tgt_off.append(len(tgt_flat))
        uids.append(uid)
        if nbest:
            has_nbest = True
            for score, cand in nbest:
                cand_flat.extend(int(x) for x in cand)
                cand_off.append(len(cand_flat))
                cand_scores.append(float(score))
        cand_utt_off.append(len(cand_off) - 1)
    np.savez(os.path.join(out_dir, "seq2seq.npz"),
             src=np.asarray(src_flat, np.int32),
             src_offsets=np.asarray(src_off, np.int64),
             tgt=np.asarray(tgt_flat, np.int32),
             tgt_offsets=np.asarray(tgt_off, np.int64),
             cand=np.asarray(cand_flat, np.int32),
             cand_offsets=np.asarray(cand_off, np.int64),
             cand_utt_offsets=np.asarray(cand_utt_off, np.int64),
             cand_scores=np.asarray(cand_scores, np.float32),
             has_nbest=np.bool_(has_nbest))
    with open(os.path.join(out_dir, "uids.txt"), "w") as f:
        f.write("\n".join(uids))
    return out_dir


class Seq2SeqDataset:
    """A packed seq2seq split: item i is (src ids, tgt ids); `nbest(i)`
    its candidates [(score, ids)]."""

    feat_dim = 0  # token inputs

    def __init__(self, path):
        with np.load(os.path.join(path, "seq2seq.npz")) as z:
            self.src, self.src_offsets = z["src"], z["src_offsets"]
            self.tgt, self.tgt_offsets = z["tgt"], z["tgt_offsets"]
            self.cand, self.cand_offsets = z["cand"], z["cand_offsets"]
            self.cand_utt_offsets = z["cand_utt_offsets"]
            self.cand_scores = z["cand_scores"]
            self.has_nbest = bool(z["has_nbest"])
        with open(os.path.join(path, "uids.txt")) as f:
            self.uids = f.read().splitlines()

    def __len__(self):
        return len(self.src_offsets) - 1

    def frame_length(self, i):  # the bucketing key: the source's length
        return int(self.src_offsets[i + 1] - self.src_offsets[i])

    def label_length(self, i):
        return int(self.tgt_offsets[i + 1] - self.tgt_offsets[i])

    def __getitem__(self, i):
        return (np.asarray(self.src[self.src_offsets[i]:self.src_offsets[i + 1]]),
                np.asarray(self.tgt[self.tgt_offsets[i]:self.tgt_offsets[i + 1]]))

    def nbest(self, i):
        return [(float(self.cand_scores[k]),
                 np.asarray(self.cand[self.cand_offsets[k]:
                                      self.cand_offsets[k + 1]]))
                for k in range(int(self.cand_utt_offsets[i]),
                               int(self.cand_utt_offsets[i + 1]))]


@dataclass
class Seq2SeqBatch:
    """Host-side seq2seq batch padded to its bucket's shape, with the
    candidate sets when the split has them."""

    src: np.ndarray          # (B, S) int32
    src_lens: np.ndarray     # (B,) int32
    tgt: np.ndarray          # (B, U) int32
    tgt_lens: np.ndarray     # (B,) int32
    weight: np.ndarray       # (B,) float32, 0 for padding repeats
    uids: list | None = None
    cands: np.ndarray | None = None        # (B, K, Tp) int32
    cand_lens: np.ndarray | None = None    # (B, K) int32
    cand_scores: np.ndarray | None = None  # (B, K) float32

    def asdict(self):
        d = dict(src=self.src, src_lens=self.src_lens, tgt=self.tgt,
                 tgt_lens=self.tgt_lens, weight=self.weight)
        if self.cands is not None:
            d.update(cands=self.cands, cand_lens=self.cand_lens,
                     cand_scores=self.cand_scores)
        return d


class Seq2SeqLoader:
    """Bucketed batching of a `Seq2SeqDataset` by source length, with a
    fixed shape set as `BucketedLoader`'s: batch sizes a multiple of
    `multiple_of`, a short batch padded by repeating its pairs with
    weight 0, the epoch order from `default_rng(seed + epoch)`. With
    candidates, K = num_cands (else the most an utterance has) slots of
    the longest candidate's length: a missing candidate has length 1 and
    score -1e30, an utterance without candidates gets [(0.0, src)]."""

    def __init__(self, dataset, frame_budget=4096, num_buckets=4,
                 multiple_of=1, shuffle=True, seed=0, num_cands=None):
        self.ds = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.multiple_of = multiple_of
        n = len(dataset)
        self.slens = np.asarray([dataset.frame_length(i) for i in range(n)])
        self.tlens = np.asarray([dataset.label_length(i) for i in range(n)])
        self.indices = np.nonzero((self.slens > 0) & (self.tlens > 0))[0]
        if len(self.indices) == 0:
            raise ValueError("no usable pairs (empty src or tgt)")
        self.buckets = make_buckets(self.slens[self.indices], num_buckets,
                                    min_len=8)
        self.batch_sizes, self.tgt_caps = [], []
        for edge in self.buckets:
            bs = max(frame_budget // edge, 1)
            self.batch_sizes.append(max(bs // multiple_of * multiple_of,
                                        multiple_of))
            in_b = self.indices[self.slens[self.indices] <= edge]
            cap = int(self.tlens[in_b].max()) if len(in_b) else 1
            self.tgt_caps.append(max(cap, 1))
        self.K = 0
        if dataset.has_nbest:
            ks = [len(dataset.nbest(int(i))) for i in self.indices]
            self.K = num_cands or max(max(ks), 1)
            offs = dataset.cand_offsets
            self.cand_cap = (int(max((offs[1:] - offs[:-1]).max(), 1))
                             if len(offs) > 1 else 1)

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
            b = self.bucket_of(self.slens[i])
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
            pools[self.bucket_of(self.slens[i])] += 1
        return sum((n + bs - 1) // bs
                   for n, bs in zip(pools, self.batch_sizes))

    def _collate(self, idxs, b):
        B, S, U = self.batch_sizes[b], self.buckets[b], self.tgt_caps[b]
        real = len(idxs)
        src = np.zeros((B, S), np.int32)
        tgt = np.zeros((B, U), np.int32)
        sl = np.zeros((B,), np.int32)
        tl = np.zeros((B,), np.int32)
        w = np.zeros((B,), np.float32)
        uids = []
        cands = cl = cs = None
        if self.K:
            cands = np.zeros((B, self.K, self.cand_cap), np.int32)
            cl = np.ones((B, self.K), np.int32)
            cs = np.full((B, self.K), -1e30, np.float32)
        for j in range(B):
            i = int(idxs[j % real])  # a short batch repeats its pairs
            s, t = self.ds[i]
            src[j, :min(len(s), S)] = s[:S]
            tgt[j, :min(len(t), U)] = t[:U]
            sl[j] = min(len(s), S)
            tl[j] = min(len(t), U)
            w[j] = 1.0 if j < real else 0.0
            if j < real:
                uids.append(self.ds.uids[i])
            if self.K:
                nb = self.ds.nbest(i) or [(0.0, s)]
                for q, (score, c) in enumerate(nb[:self.K]):
                    c = np.asarray(c)[:self.cand_cap]
                    cands[j, q, :len(c)] = c
                    cl[j, q] = max(len(c), 1)
                    cs[j, q] = score
        return Seq2SeqBatch(src, sl, tgt, tl, w, uids=uids, cands=cands,
                            cand_lens=cl, cand_scores=cs)
