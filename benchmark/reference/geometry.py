"""Engine geometry: the reference's presets and derived sizes, numpy only.

A frozen copy of the parts of signalsmith_stretch_torch/config.py that the
benchmark's configurations use (the benchmark's plain reference imports
nothing of the port).  Presets follow signalsmith-stretch.h:63-104.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

NOISE_FLOOR = 1e-15
MAX_CLEAN_STRETCH = 2.0


@dataclasses.dataclass(frozen=True)
class StretchConfig:
    channels: int
    block_samples: int
    interval_samples: int
    split_computation: bool = False

    @classmethod
    def preset_default(cls, channels: int, sample_rate: float,
                       split_computation: bool = False) -> "StretchConfig":
        return cls(channels, int(sample_rate * 0.12), int(sample_rate * 0.03),
                   split_computation)

    @property
    def fft_samples(self) -> int:
        p = 1
        while p < self.block_samples:
            p <<= 1
        return p

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
        return self.block_samples + self.interval_samples

    def output_seek_length(self, playback_rate: float) -> int:
        return int(self.input_latency
                   + float(playback_rate) * self.output_latency)

    @property
    def smoothing_bins(self) -> float:
        return float(np.float32(self.fft_samples)
                     / np.float32(self.interval_samples))

    @property
    def long_vertical_step(self) -> int:
        return int(math.floor(self.smoothing_bins + 0.5))
