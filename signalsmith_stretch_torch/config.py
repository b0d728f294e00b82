"""Engine configuration and geometry (host-side, numpy only).

Mirrors the configuration surface of the reference engine
(signalsmith-stretch.h:63-104): presets map a sample rate to block/interval
sizes, and all derived geometry (FFT size, bands, latencies) follows the
clean-room STFT spec of oracle/signalsmith-linear/stft.h.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class StretchConfig:
    """Static engine geometry.

    channels/block/interval follow `configure` (signalsmith-stretch.h:71-94);
    split_computation adds one interval of output latency (:46, 102-104).
    """

    channels: int
    block_samples: int
    interval_samples: int
    split_computation: bool = False

    # presets (signalsmith-stretch.h:63-68): double arithmetic truncated to
    # int exactly as the C++ implicit conversion does
    @classmethod
    def preset_default(cls, channels: int, sample_rate: float,
                       split_computation: bool = False) -> "StretchConfig":
        return cls(channels, int(sample_rate * 0.12), int(sample_rate * 0.03),
                   split_computation)

    @classmethod
    def preset_cheaper(cls, channels: int, sample_rate: float,
                       split_computation: bool = True) -> "StretchConfig":
        return cls(channels, int(sample_rate * 0.1), int(sample_rate * 0.04),
                   split_computation)

    @property
    def fft_samples(self) -> int:
        return _next_pow2(self.block_samples)

    @property
    def bands(self) -> int:
        return self.fft_samples // 2

    @property
    def input_latency(self) -> int:
        return self.block_samples // 2

    @property
    def output_latency(self) -> int:
        return (self.block_samples - self.block_samples // 2
                + (self.interval_samples if self.split_computation else 0))

    @property
    def seek_length(self) -> int:
        # signalsmith-stretch.h:166-168
        return self.block_samples + self.interval_samples

    def output_seek_length(self, playback_rate: float) -> int:
        # signalsmith-stretch.h:205-207: double arithmetic truncated to int,
        # as the C++ int cast
        return int(self.input_latency
                   + float(playback_rate) * self.output_latency)

    @property
    def smoothing_bins(self) -> float:
        # float32 `Sample(stft.fftSamples())/stft.defaultInterval()` (:636)
        return float(np.float32(self.fft_samples)
                     / np.float32(self.interval_samples))

    @property
    def long_vertical_step(self) -> int:
        # std::round of the float32 smoothing_bins (:637)
        return int(math.floor(self.smoothing_bins + 0.5))


# Spectral constants (signalsmith-stretch.h:508-509)
NOISE_FLOOR = 1e-15
MAX_CLEAN_STRETCH = 2.0


def device_for(device, who: str):
    """The device an entry point runs on, as a torch.device: "cuda" (every
    entry point's default) needs a card and raises without one; the CPU
    runs only when asked for, with the plain versions of the kernels."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available; pass "
                           "device='cpu' to render on the CPU")
    return dev
