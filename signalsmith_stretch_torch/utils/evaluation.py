"""Corpus evaluation helpers: deterministic test clips and the structural
comparisons (band energies, envelopes), numpy only.

A copy of signalsmith_stretch_tpu/utils/evaluation.py (the port imports
nothing of the JAX package); every function returns the same bits as the
original.  Gates follow docs/PARITY.md's taxonomy: structural band-energy /
envelope comparisons are stable under the phase recursion's chaos,
sample-level gates must be chaos-relative and cut clear of the
RNG-divergent flush tail.
"""
from __future__ import annotations

import numpy as np

# Pinned per-kind seeds: Python's salted hash() made clip content differ
# per process, so "the suite is green" was unfalsifiable run to run.
KIND_SEEDS = {"harmonic": 101, "sweep": 202, "noise": 303, "transients": 404,
              "chords": 505, "vibrato": 606, "voice": 707,
              "silence_edges": 808}
KINDS = list(KIND_SEEDS)
# the original 4 kinds, for callers wanting the round-2 quick corpus
KINDS_BASIC = ["harmonic", "sweep", "noise", "transients"]


def synth_clip(kind: str, rate: int, seconds: float,
               seed: int | None = None) -> np.ndarray:
    """Deterministic mono test clip [1, n] float32 of the given character.

    The richer kinds approximate what the reference's real-music system
    corpus (cmd/CMakeLists.txt:12-18, network-fetched) exercises and the
    basic four don't: dense polyphonic peak structure (chords), moving
    partials (vibrato), speech-like formant tracks over a pitch contour
    (voice), and hard silence boundaries (silence_edges)."""
    rng = np.random.default_rng(KIND_SEEDS[kind] if seed is None else seed)
    t = np.arange(int(rate * seconds)) / rate
    if kind == "harmonic":
        sig = sum((0.5 / (i + 1)) * np.sin(2 * np.pi * 130 * (i + 1) * t + i)
                  for i in range(6))
    elif kind == "sweep":
        sig = 0.5 * np.sin(2 * np.pi * (100 * t + 400 * t * t))
    elif kind == "noise":
        sig = 0.3 * rng.standard_normal(t.shape)
    elif kind == "transients":
        sig = np.zeros_like(t)
        sig[::1600] = 1.0
        k = np.exp(-np.arange(200) / 30.0)
        sig = np.convolve(sig, k)[:t.size] * 0.5
    elif kind == "chords":
        # two alternating triads, 4 harmonics each: dense polyphonic peaks
        roots = np.where((t % 1.0) < 0.5, 196.0, 220.0)       # G3 / A3
        sig = np.zeros_like(t)
        for ratio in (1.0, 1.25992105, 1.49830708):           # root/maj3/5th
            for h in range(1, 5):
                sig += (0.22 / h) * np.sin(
                    2 * np.pi * np.cumsum(roots * ratio * h) / rate)
    elif kind == "vibrato":
        # 5.5 Hz vibrato (+-3%) on a 4-harmonic 220 Hz tone + slow tremolo
        f0 = 220.0 * (1.0 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / rate
        sig = sum((0.4 / h) * np.sin(h * phase) for h in range(1, 5))
        sig *= 1.0 + 0.2 * np.sin(2 * np.pi * 1.3 * t)
    elif kind == "voice":
        # speech-like: glottal-ish pulse train on a pitch contour, shaped by
        # two formant resonators gliding between vowel targets (a -> i)
        f0 = 120.0 * 2 ** (0.3 * np.sin(2 * np.pi * 0.8 * t))
        phase = np.cumsum(f0) / rate
        pulses = ((phase % 1.0) < 0.08).astype(np.float64)
        x = pulses - np.mean(pulses)

        def resonate(x, fc, bw):
            # 2-pole resonator with a per-sample gliding centre frequency
            r = np.exp(-np.pi * bw / rate)
            b1 = 2 * r * np.cos(2 * np.pi * fc / rate)      # [n]
            b2 = -r * r
            y = np.zeros_like(x)
            for i in range(2, x.size):   # slow but deterministic host code
                y[i] = x[i] + b1[i] * y[i - 1] + b2 * y[i - 2]
            return y

        glide = 1 - t / t[-1]
        sig = 0.4 * resonate(x, 700 * glide + 300 * (1 - glide), 110.0) \
            + 0.25 * resonate(x, 1100 * glide + 2200 * (1 - glide), 140.0)
        sig = 0.5 * sig / (np.abs(sig).max() + 1e-9)
    elif kind == "silence_edges":
        # tone bursts separated by hard zeros: silence-boundary behaviour
        env = (((t % 0.5) < 0.27) & (t > 0.1)).astype(np.float64)
        sig = env * 0.5 * np.sin(2 * np.pi * 330 * t)
        return sig[None, :].astype(np.float32)   # no dither: keep true zeros
    else:
        raise ValueError(kind)
    sig = sig + 0.01 * rng.standard_normal(t.shape)
    return sig[None, :].astype(np.float32)


def band_energies(x: np.ndarray, rate: int, n_fft: int = 1024) -> np.ndarray:
    """[ch, n] -> log10 energy per third-octave-ish band, time-averaged."""
    n = (x.shape[1] // n_fft) * n_fft
    frames = x[0, :n].reshape(-1, n_fft) * np.hanning(n_fft)
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    freqs = np.fft.rfftfreq(n_fft, 1.0 / rate)
    edges = 50 * (2 ** (np.arange(0, 20) / 3.0))
    edges = edges[edges < rate / 2]
    e = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (freqs >= lo) & (freqs < hi)
        if m.any():
            e.append(spec[:, m].sum(axis=1).mean())
    return np.log10(np.asarray(e) + 1e-12)


def envelope_db(out: np.ndarray, ref: np.ndarray, rate: int,
                window_s: float = 0.05) -> float:
    """Mean |broadband RMS envelope deviation| in dB over window_s windows."""
    w = int(window_s * rate)
    n = (min(out.shape[1], ref.shape[1]) // w) * w
    env_m = np.sqrt((out[0, :n].reshape(-1, w) ** 2).mean(1) + 1e-12)
    env_r = np.sqrt((ref[0, :n].reshape(-1, w) ** 2).mean(1) + 1e-12)
    return float(20 * np.abs(np.log10(env_m / env_r)).mean())
