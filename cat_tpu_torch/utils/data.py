"""Packed speech datasets: the reader of `cat_tpu/utils/data.py`'s format.

A split directory holds `meta.npz` (frame and label offsets, the flat
labels, the feature width), `feats.bin` (one flat float32 memmap of all
frames) and `uids.txt`, as `cat_tpu.utils.data.pack_speech_data` writes
them. Bucketed batching is a later slice of the port.
"""
from __future__ import annotations

import os

import numpy as np


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
