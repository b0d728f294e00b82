"""Modified-real-DFT STFT: the analysis DFT (kernel D) and torch.fft.

The shared clean-room STFT spec (oracle/signalsmith-linear/stft.h):
half-bin-offset "modified" real FFT over a power-of-two frame, Kaiser windows
and WOLA weight normalisation.  Frames are batched tensors
([..., block] -> [..., bands]); the ring behaviour lives in the schedule and
engine layers as static arithmetic.

  analysis:   S_b = sum_n  w[n] x[n] e^{-2πi n (b+0.5)/N},  b < N/2
  synthesis:  y[n] = 2/N * Re[ sum_b S_b e^{+2πi n (b+0.5)/N} ] * w[n]

On the card the analysis runs the two-stage DFT kernel (ops/dft.py,
csrc/dft.cu) built from `_dft_mats`; its plain version, `analyze_plain`, is
torch.fft (cuFFT on the card).  The synthesis is torch.fft on every device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .config import StretchConfig
from .ops import dft
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


@functools.lru_cache(maxsize=None)
def _dft_mats(fft_samples: int):
    """Constants for the two-stage Cooley-Tukey DFT of the modified
    transform.  n = n1*N2 + n2, b = k1 + N1*k2 with k2 < N2/2 (upper half of
    the spectrum is the conjugate mirror and never materialized).

    The modified transform's pre-twist e^{-i pi n / N} is separable
    (t1[n1] * t2[n2]); it is folded into the stage-1 matrix (t1) and the
    twiddle (t2), so the forward stage 1 consumes the REAL windowed signal
    directly.  Only the forward constants, the ones kernel D reads: the
    synthesis stays on torch.fft."""
    N = fft_samples
    log2 = N.bit_length() - 1
    N1 = 1 << (log2 // 2)
    N2 = N // N1
    k1 = np.arange(N1)
    n1 = np.arange(N1)
    n2 = np.arange(N2)
    k2 = np.arange(N2 // 2)
    t1 = np.exp(-1j * np.pi * n1 * N2 / N)                      # [N1]
    t2 = np.exp(-1j * np.pi * n2 / N)                           # [N2]
    dft1 = np.exp(-2j * np.pi * np.outer(k1, n1) / N1) * t1     # [K1, N1]
    tw = np.exp(-2j * np.pi * np.outer(k1, n2) / N) * t2        # [K1, N2]
    dft2 = np.exp(-2j * np.pi * np.outer(n2, k2) / N2)          # [N2, K2]
    c64 = lambda m: m.astype(np.complex64)
    return N1, N2, c64(dft1), c64(tw), c64(dft2)


def analyze(frames: torch.Tensor, basis: StftBasis,
            plain: bool = False) -> torch.Tensor:
    """Windowed modified-DFT analysis: frames [..., block] f32 ->
    [..., bands] complex64.  Kernel D on a CUDA tensor (plain=False), else
    `analyze_plain`."""
    if plain:
        return analyze_plain(frames, basis)
    return dft.analyze(frames, basis)


def analyze_plain(frames: torch.Tensor, basis: StftBasis) -> torch.Tensor:
    """Plain version of the analysis: window, pad, twist, torch.fft.fft
    (cuFFT on the card), keep the lower half."""
    dev = frames.device
    y = frames * torch.as_tensor(basis.window, device=dev)
    y = F.pad(y, (0, basis.fft_samples - basis.block_samples))
    z = y * torch.as_tensor(basis.twist, device=dev)
    return torch.fft.fft(z, dim=-1)[..., :basis.bands]


def synthesize(spectra: torch.Tensor, basis: StftBasis) -> torch.Tensor:
    """Inverse modified FFT + synthesis window: [..., bands] complex64 ->
    [..., block] f32, y[n] = 2*Re(ifft(pad(S))[n] * conj(twist[n])) * w[n]."""
    dev = spectra.device
    twist = torch.as_tensor(basis.twist, device=dev)
    full = F.pad(spectra, (0, basis.fft_samples - basis.bands))
    u = torch.fft.ifft(full, dim=-1)
    y = 2.0 * (u.real * twist.real + u.imag * twist.imag)
    y = y[..., :basis.block_samples]
    return y * torch.as_tensor(basis.window, device=dev)


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
