"""Modified-real-DFT STFT: the analysis DFT (kernel D) and torch.fft.

The shared clean-room STFT spec (oracle/signalsmith-linear/stft.h):
half-bin-offset "modified" real FFT over a power-of-two frame, Kaiser windows
and WOLA weight normalisation.  Frames are batched tensors
([..., block] -> [..., bands]); the ring behaviour lives in the schedule and
engine layers as static arithmetic.

  analysis:   S_b = sum_n  w[n] x[n] e^{-2πi n (b+0.5)/N},  b < N/2
  synthesis:  y[n] = 2/N * Re[ sum_b S_b e^{+2πi n (b+0.5)/N} ] * w[n]

On the card the analysis runs kernel D (ops/dft.py, csrc/dft.cu), one
half-length complex FFT per frame with the window, the pair packing and the
half-bin twist fused in; its plain version, `analyze_plain`, is torch.fft
(cuFFT on the card).  `synthesize` is torch.fft on every device: the plain
version of kernel K (ops/idft.py), which the offline render runs on the
card, and the stream's synthesis of its one block at a time.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .config import StretchConfig
from .tables import on_device
from .windows import kaiser_window


@dataclasses.dataclass(frozen=True)
class StftBasis:
    """Host constants for one config."""

    window: np.ndarray        # [block] float32
    twist: np.ndarray         # [fft] complex64, e^{-i pi n / N}
    fft_samples: int
    block_samples: int
    bands: int

    @classmethod
    @functools.lru_cache(maxsize=None)
    def _cached(cls, block_samples: int, interval_samples: int) -> "StftBasis":
        fft = 1
        while fft < block_samples:
            fft <<= 1
        window = kaiser_window(block_samples, interval_samples)
        n = np.arange(fft, dtype=np.float64)
        angle = -np.pi * n / fft
        twist = (np.cos(angle).astype(np.float32)
                 + 1j * np.sin(angle).astype(np.float32)).astype(np.complex64)
        return cls(window=window, twist=twist, fft_samples=fft,
                   block_samples=block_samples, bands=fft // 2)

    @classmethod
    def for_config(cls, cfg: StretchConfig) -> "StftBasis":
        return cls._cached(cfg.block_samples, cfg.interval_samples)


def analyze_plain(frames: torch.Tensor, basis: StftBasis) -> torch.Tensor:
    """Plain version of the analysis: window, pad, twist, torch.fft.fft
    (cuFFT on the card), keep the lower half."""
    dev = frames.device
    y = frames * on_device(basis.window, dev)
    y = F.pad(y, (0, basis.fft_samples - basis.block_samples))
    z = y * on_device(basis.twist, dev)
    return torch.fft.fft(z, dim=-1)[..., :basis.bands]


def twist_planes(twist: np.ndarray):
    """The twist's real and imaginary planes, float32."""
    return twist.real.astype(np.float32), twist.imag.astype(np.float32)


def synthesize(spectra: torch.Tensor, basis: StftBasis) -> torch.Tensor:
    """Inverse modified FFT + synthesis window: [..., bands] complex64 ->
    [..., block] f32, y[n] = 2*Re(ifft(pad(S))[n] * conj(twist[n])) * w[n]."""
    tw_r, tw_i = on_device(basis.twist, spectra.device, twist_planes)
    full = F.pad(spectra, (0, basis.fft_samples - basis.bands))
    u = torch.fft.ifft(full, dim=-1)
    y = 2.0 * (u.real * tw_r + u.imag * tw_i)
    y = y[..., :basis.block_samples]
    return y * on_device(basis.window, spectra.device)


def band_freqs(basis: StftBasis) -> np.ndarray:
    """Normalised centre frequency of each band, float32 [bands]."""
    b = np.arange(basis.bands, dtype=np.float32)
    return ((b + np.float32(0.5)) / np.float32(basis.fft_samples)).astype(np.float32)


def wola_weight(basis: StftBasis, ring_len: int, block_positions: np.ndarray,
                weight_floor: float = 0.1) -> np.ndarray:
    """Accumulated WOLA weight ring for a static block placement: float32
    accumulation in block order, as the oracle's `weight[idx] +=
    window[n]*window[n]` loop, floored by reset(0.1) before use as a divisor."""
    w2 = (basis.window * basis.window).astype(np.float32)
    weight = np.zeros(ring_len, np.float32)
    for pos in block_positions:
        weight[pos:pos + basis.block_samples] += w2[:max(0, min(basis.block_samples, ring_len - pos))]
    return np.maximum(weight, np.float32(weight_floor))
