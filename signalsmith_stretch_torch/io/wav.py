"""Audio file I/O: 16-bit PCM WAV (stdlib) and the oracle's raw-float format.

A copy of signalsmith_stretch_tpu/io/wav.py without its native codec: WAV
is 16-bit PCM like the reference CLI, written with the same clipping and
float32 quantisation (so the same samples give the same file); raw is the
lossless planar float32 format shared with oracle/wav.h, a header
`[u32 channels][u32 rate][u64 frames]` and then each channel's float32
samples.
"""
from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns ([channels, samples] float32 in [-1, 1), sample_rate)."""
    with wave.open(path, "rb") as w:
        ch = w.getnchannels()
        rate = w.getframerate()
        width = w.getsampwidth()
        frames = w.getnframes()
        data = w.readframes(frames)
    if width != 2:
        raise ValueError(f"only 16-bit PCM WAV supported, got {8*width}-bit")
    pcm = np.frombuffer(data, "<i2").reshape(frames, ch)
    return (pcm.T.astype(np.float32) / 32768.0), rate


def quantize(audio: np.ndarray) -> np.ndarray:
    """[channels, samples] float32 -> int16 samples as write_wav stores
    them: clipped to [-1, 1], scaled by 32767 (>= 0) or 32768 (< 0) in
    float32, rounded half away from zero by truncation."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return np.where(audio >= 0, audio * 32767.0 + 0.5,
                    audio * 32768.0 - 0.5).astype(np.int16)


def write_wav(path: str, audio: np.ndarray, sample_rate: int):
    """audio [channels, samples] float32; clipped and quantized like
    oracle/wav.h."""
    pcm = quantize(audio)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())


def read_raw(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        ch, rate, n = struct.unpack("<IIQ", f.read(16))
        data = np.frombuffer(f.read(), dtype="<f4").reshape(ch, n)
    return data.copy(), rate


def write_raw(path: str, audio: np.ndarray, sample_rate: int):
    audio = np.asarray(audio, np.float32)
    ch, n = audio.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQ", ch, sample_rate, n))
        for c in range(ch):
            f.write(audio[c].astype("<f4").tobytes())
