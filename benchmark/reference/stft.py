"""Modified-real-DFT STFT in plain PyTorch (torch.fft both ways).

A frozen copy of the plain path of signalsmith_stretch_torch/stft.py:
half-bin-offset modified real FFT over a power-of-two frame, Kaiser windows
and WOLA weights (oracle/signalsmith-linear/stft.h).

  analysis:   S_b = sum_n  w[n] x[n] e^{-2πi n (b+0.5)/N},  b < N/2
  synthesis:  y[n] = 2/N * Re[ sum_b S_b e^{+2πi n (b+0.5)/N} ] * w[n]
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import StretchConfig
from .windows import kaiser_window


@dataclasses.dataclass(frozen=True)
class StftBasis:
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


def analyze(frames: torch.Tensor, basis: StftBasis) -> torch.Tensor:
    """frames [..., block] f32 -> [..., bands] complex64: window, pad,
    twist, torch.fft.fft, keep the lower half."""
    dev = frames.device
    y = frames * torch.as_tensor(basis.window, device=dev)
    y = F.pad(y, (0, basis.fft_samples - basis.block_samples))
    z = y * torch.as_tensor(basis.twist, device=dev)
    return torch.fft.fft(z, dim=-1)[..., :basis.bands]


def synthesize(spectra: torch.Tensor, basis: StftBasis) -> torch.Tensor:
    """[..., bands] complex64 -> [..., block] f32,
    y[n] = 2*Re(ifft(pad(S))[n] * conj(twist[n])) * w[n]."""
    dev = spectra.device
    tw = basis.twist
    tw_r = torch.as_tensor(np.array(tw.real, np.float32), device=dev)
    tw_i = torch.as_tensor(np.array(tw.imag, np.float32), device=dev)
    window = torch.as_tensor(np.asarray(basis.window, np.float32), device=dev)
    full = F.pad(spectra, (0, basis.fft_samples - basis.bands))
    u = torch.fft.ifft(full, dim=-1)
    y = 2.0 * (u.real * tw_r + u.imag * tw_i)
    return y[..., :basis.block_samples] * window


def wola_weight(basis: StftBasis, ring_len: int, block_positions: np.ndarray,
                weight_floor: float = 0.1) -> np.ndarray:
    """Accumulated WOLA weights for a static block placement, float32 in
    block order, floored at reset(0.1)."""
    w2 = (basis.window * basis.window).astype(np.float32)
    weight = np.zeros(ring_len, np.float32)
    for pos in block_positions:
        n = max(0, min(basis.block_samples, ring_len - pos))
        weight[pos:pos + basis.block_samples] += w2[:n]
    return np.maximum(weight, np.float32(weight_floor))
