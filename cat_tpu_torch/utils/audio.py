"""WAV audio IO with the standard library's `wave` module (counterpart of
`cat_tpu/utils/audio.py`; no soundfile or torchaudio)."""
from __future__ import annotations

import wave

import numpy as np


def read_wav(path, mono=True):
    """Read an 8-, 16- or 32-bit PCM WAV -> (samples f32 in [-1, 1],
    sample_rate).

    mono=True averages the channels of a multichannel file; mono=False
    returns (L, C) for a multichannel file and (L,) for a mono one."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch)
        if mono:
            data = data.mean(axis=1)
    return data, sr


def write_wav(path, samples, sample_rate=16000):
    """Write 16-bit PCM WAV. samples: (L,) mono or (L, C) multichannel,
    clipped to [-1, 1]."""
    samples = np.clip(np.asarray(samples), -1.0, 1.0)
    ch = 1 if samples.ndim == 1 else samples.shape[1]
    pcm = (samples * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(pcm).tobytes())
