"""Offline data preparation: a manifest -> fbank + CMVN (+ speed
perturbation) -> the packed format or npz shards (counterpart of
`cat_tpu/utils/data_prep.py`).

Manifest layout (what every egs/<dataset>/local/prepare.py writes):
    wav.scp    uid <wav path>
    text       uid <transcript>
    segments   uid recid start_sec end_sec     (optional, kaldi-style)

Usage:
    python -m cat_tpu_torch.utils.data_prep <datadir> <out> \\
        --tokenizer exp/tokenizer.tknz [--format packed|shards] \\
        [--shard-size 500] [--num-mel-bins 80] [--speed-perturb 0.9 1.1] \\
        [--device cuda|cpu]

The features are `ops/fbank.py`'s, computed on the card unless
`--device cpu` is given; the output is the packed format of
`utils/data.py`, or with `--format shards` the npz shards of streaming
training (`utils/data_sharded.py`, `--shard-size` utterances a shard),
both read by either package. Speed-perturbed copies get the uid prefix
`sp{factor}-` and are meant for training sets only. The raw multichannel
waves of ME2E prep (`--channels`, ROADMAP.md §A.8) are not ported yet
and raise.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cat_tpu_torch.ops import fbank
from cat_tpu_torch.utils.audio import read_wav


def check_device(device=None) -> torch.device:
    """torch.device(device), "cuda" by default; raises when CUDA is asked
    for and missing."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device 'cpu' to run "
                           "on the CPU")
    return device


def read_manifest(datadir):
    """wav.scp + text (+ optional segments) -> list of (uid, wav_path,
    transcript, start_sec, end_sec); start and end are None without a
    segments file."""
    def read_kv(path):
        out = {}
        with open(path) as f:
            for line in f:
                parts = line.strip().split(None, 1)
                if len(parts) == 2:
                    out[parts[0]] = parts[1]
        return out

    scp = read_kv(os.path.join(datadir, "wav.scp"))
    text = read_kv(os.path.join(datadir, "text"))
    seg_path = os.path.join(datadir, "segments")
    entries = []
    if os.path.exists(seg_path):
        with open(seg_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                uid, rec, s, e = parts
                if uid in text and rec in scp:
                    entries.append((uid, scp[rec], text[uid],
                                    float(s), float(e)))
    else:
        for uid, path in scp.items():
            if uid in text:
                entries.append((uid, path, text[uid], None, None))
    return entries


def wav_features(wav, sr, num_mel_bins=80, device="cpu"):
    """(L,) f32 samples -> (T, F) f32 numpy log-mel features with CMVN,
    computed on `device`: 25 ms windows every 10 ms, a 512-point FFT."""
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32))[None]
    feats = fbank.log_fbank(x.to(device), num_bins=num_mel_bins,
                            sample_rate=sr, frame_length=int(sr * 0.025),
                            frame_shift=int(sr * 0.010), fft_size=512)
    return fbank.cmvn(feats)[0].cpu().numpy()


def features_iter(entries, num_mel_bins=80, speed_perturb=(),
                  device="cpu"):
    """Yields (uid, feats (T, F) f32, transcript). Speed-perturbed copies
    are resampled (`ops/fbank.py` `speed_perturb_resample`) and their uids
    prefixed `sp{f}-`."""
    factors = [None] + [f for f in speed_perturb if abs(f - 1.0) > 1e-6]
    for uid, path, trans, start, end in entries:
        wav, sr = read_wav(path)
        if start is not None:
            wav = wav[int(start * sr):int(end * sr)]
        if wav.shape[0] < 16:
            continue
        for f in factors:
            w, u = wav, uid
            if f is not None:
                w = np.ascontiguousarray(
                    fbank.speed_perturb_resample(w, f), np.float32)
                u = f"sp{f}-{uid}"
            yield u, wav_features(w, sr, num_mel_bins, device), trans


def check_format(fmt="packed", channels=0):
    """Raise for the outputs not ported yet."""
    if fmt not in ("packed", "shards"):
        raise ValueError(f"unknown format {fmt!r}")
    if channels > 0:
        raise NotImplementedError("raw multichannel prep (--channels, the "
                                  "ME2E front end) is not ported to "
                                  "cat_tpu_torch yet; see ROADMAP.md §A.8")


def prepare(datadir, out, tokenizer, fmt="packed", num_mel_bins=80,
            speed_perturb=(), shard_size=500, channels=0, device=None):
    """Write `out` as packed data or npz shards; returns the number of
    shards (1 for packed data)."""
    check_format(fmt, channels)
    device = check_device(device)
    entries = read_manifest(datadir)
    if not entries:
        raise FileNotFoundError(f"no utterances under {datadir}")
    it = features_iter(entries, num_mel_bins, speed_perturb, device)
    if fmt == "shards":
        from cat_tpu_torch.utils.data_sharded import write_shards

        n = write_shards(out, it, tokenizer, shard_size=shard_size)
        print(f"{out}: {n} shards")
        return n
    from cat_tpu_torch.utils.data import pack_speech_data

    pack_speech_data(out, it, tokenizer)
    print(f"{out}: packed")
    return 1


def main(argv=None):
    p = argparse.ArgumentParser(
        "cat_tpu_torch.utils.data_prep",
        description="manifest dir (wav.scp/text[/segments]) -> fbank+CMVN "
                    "-> packed data or npz shards")
    p.add_argument("datadir")
    p.add_argument("out")
    p.add_argument("--tokenizer", required=True,
                   help="saved .tknz (pipeline stage 1)")
    p.add_argument("--format", choices=("packed", "shards"),
                   default="packed")
    p.add_argument("--num-mel-bins", type=int, default=80)
    p.add_argument("--speed-perturb", type=float, nargs="*", default=[],
                   help="e.g. 0.9 1.1 (train sets only)")
    p.add_argument("--shard-size", type=int, default=500,
                   help="utterances a shard (--format shards)")
    p.add_argument("--channels", type=int, default=0,
                   help=">0: raw multichannel waves (not ported)")
    p.add_argument("--device", default="cuda",
                   help="device of the fbank (default cuda)")
    a = p.parse_args(argv)
    check_format(a.format, a.channels)
    from cat_tpu_torch.utils import tokenizer as tknz

    prepare(a.datadir, a.out, tknz.load(a.tokenizer), fmt=a.format,
            num_mel_bins=a.num_mel_bins,
            speed_perturb=tuple(a.speed_perturb), shard_size=a.shard_size,
            channels=a.channels, device=a.device)


if __name__ == "__main__":
    main()
