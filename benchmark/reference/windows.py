"""A frozen copy of signalsmith_stretch_torch/windows.py (the benchmark's
plain reference).

Kaiser analysis/synthesis window, bit-matched to the oracle STFT.

Replicates oracle/signalsmith-linear/stft.h `makeWindow()`: series-expansion
Bessel I0 in float64, window evaluated in float64 and stored in float32, then
rescaled so the average weighted-overlap-add weight is one.
"""
from __future__ import annotations

import numpy as np


def bessel_i0(x: np.ndarray) -> np.ndarray:
    """Series I0 matching the oracle's 64-term expansion (float64)."""
    x = np.asarray(x, np.float64)
    total = np.ones_like(x)
    term = np.ones_like(x)
    half = x * 0.5
    for k in range(1, 64):
        term = term * (half / k) * (half / k)
        total = total + term
        if np.all(term < total * 1e-18):
            break
    return total


def kaiser_window(block_samples: int, interval_samples: int) -> np.ndarray:
    """Analysis == synthesis window (float32), scaled so sum(w^2) ==
    interval; beta = pi*sqrt(B^2/4 - 1) with B = block/interval (>= 2)."""
    N = block_samples
    B = float(block_samples) / float(interval_samples if interval_samples else 1)
    B = max(B, 2.0)
    beta = np.pi * np.sqrt(B * B * 0.25 - 1)
    i0beta = bessel_i0(np.float64(beta))
    n = np.arange(N, dtype=np.float64)
    r = (2.0 * (n + 0.5) - N) / N
    w64 = bessel_i0(beta * np.sqrt(np.maximum(0.0, 1 - r * r))) / i0beta
    w32 = w64.astype(np.float32)
    # the oracle accumulates sum(w*w) in float64 on the double window values
    sum_sq = float(np.sum(w64 * w64))
    scale = np.sqrt(float(interval_samples) / sum_sq)
    return (w32.astype(np.float64) * scale).astype(np.float32)
