"""User-facing API mirroring the reference `SignalsmithStretch` surface.

The port of signalsmith_stretch_tpu/api.py.  Control methods match
signalsmith-stretch.h one-for-one:
  preset_default/preset_cheaper/configure        (:63-104)
  set_transpose_factor/set_transpose_semitones   (:107-117)
  set_freq_map                                   (:119-122)
  set_formant_factor/semitones/base              (:124-135)
  block_samples/interval_samples/latencies/seek  (:42-47, 96-104, 166-207)
  exact                                          (:467-491)
  seek/process/flush/reset/output_seek           (:139-464)

`exact` and the streaming methods run on the card (device="cuda", the
default) or, when asked for, on the CPU with the plain versions of the
kernels.  Plans are built once per (config, input length, output length);
streams (streaming.py) once per (config, flags), their controls refreshed
on each call, as in the JAX package.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import engine, streaming
from .config import StretchConfig, device_for
from .spectral import Controls, SpectralFlags

f32 = np.float32

class SignalsmithStretch:
    def __init__(self, seed: int = 0, random_engine: Optional[Callable] = None,
                 device="cuda"):
        """`seed` mirrors the reference's seed ctor (signalsmith-stretch.h:
        39) and seeds the randomised binTimeFactors above 2x; `random_engine`
        its `RandomEngine` template parameter (:34-39, 610-616): a callable
        (key, shape, minval, maxval) -> float32 tensor of uniform draws,
        key being prng.key(seed).  None: the JAX package's seeded threefry
        draws (kernel I on the card, ops/draws; prng.uniform on the CPU).
        `device`: "cuda" (the default) or "cpu"."""
        self.device = device_for(device, "SignalsmithStretch")
        self._seed = int(seed)
        self._random_engine = random_engine
        self._cfg: Optional[StretchConfig] = None
        self._freq_multiplier = f32(1)
        self._freq_tonality_limit = f32(0.5)
        self._formant_multiplier = f32(1)
        self._formant_compensation = False
        self._formant_base_freq = f32(0)
        self._custom_map: Optional[Callable] = None
        self._plan_cache = {}
        self._stream_cache = {}
        self.last_diagnostics = {}

    # ---- configuration ----------------------------------------------------
    def preset_default(self, channels: int, sample_rate: float,
                       split_computation: bool = False):
        self._cfg = StretchConfig.preset_default(channels, sample_rate,
                                                 split_computation)

    def preset_cheaper(self, channels: int, sample_rate: float,
                       split_computation: bool = True):
        self._cfg = StretchConfig.preset_cheaper(channels, sample_rate,
                                                 split_computation)

    def configure(self, channels: int, block_samples: int,
                  interval_samples: int, split_computation: bool = False):
        self._cfg = StretchConfig(channels, int(block_samples),
                                  int(interval_samples), split_computation)

    @property
    def config(self) -> StretchConfig:
        if self._cfg is None:
            raise RuntimeError("call preset_default/preset_cheaper/configure "
                               "first")
        return self._cfg

    def block_samples(self) -> int:
        return self.config.block_samples

    def interval_samples(self) -> int:
        return self.config.interval_samples

    def split_computation(self) -> bool:
        return self.config.split_computation

    def input_latency(self) -> int:
        return self.config.input_latency

    def output_latency(self) -> int:
        return self.config.output_latency

    def seek_length(self) -> int:
        return self.config.seek_length

    def output_seek_length(self, playback_rate: float) -> int:
        return self.config.output_seek_length(f32(playback_rate))

    # ---- pitch / formant controls -----------------------------------------
    def set_transpose_factor(self, multiplier: float,
                             tonality_limit: float = 0):
        self._freq_multiplier = f32(multiplier)
        if tonality_limit > 0:
            self._freq_tonality_limit = f32(
                f32(tonality_limit) / f32(math.sqrt(f32(multiplier))))
        else:
            self._freq_tonality_limit = f32(1)
        self._custom_map = None

    def set_transpose_semitones(self, semitones: float,
                                tonality_limit: float = 0):
        self.set_transpose_factor(f32(2.0 ** (f32(semitones) / f32(12))),
                                  tonality_limit)

    def set_freq_map(self, input_to_output: Callable):
        """A custom monotonic frequency map (reference :119-122), in place
        of the multiplier and its tonality limit until the next
        set_transpose_factor/set_transpose_semitones.  `input_to_output`
        takes a float32 torch tensor of normalised frequencies (cycles a
        sample) on the render's device and returns the mapped frequencies,
        elementwise: a contiguous float32 tensor of the same shape on the
        same device (anything else raises; nothing is cast or copied).  It runs between the two
        launches of the peaks kernel, and on the band centres for the
        formant targets under pitch compensation."""
        self._custom_map = input_to_output

    def set_formant_factor(self, multiplier: float,
                           compensate_pitch: bool = False):
        self._formant_multiplier = f32(multiplier)
        self._formant_compensation = bool(compensate_pitch)

    def set_formant_semitones(self, semitones: float,
                              compensate_pitch: bool = False):
        self.set_formant_factor(f32(2.0 ** (f32(semitones) / f32(12))),
                                compensate_pitch)

    def set_formant_base(self, base_freq: float = 0):
        self._formant_base_freq = f32(base_freq)

    # ---- streaming (signalsmith-stretch.h:139-464) -------------------------
    def _stream(self) -> streaming.StreamingStretch:
        """The stream of the current (config, flags), built on first use;
        its controls are the current setters' values."""
        flags = self._flags()
        key = (self.config, flags)
        eng = self._stream_cache.get(key)
        if eng is None:
            eng = streaming.StreamingStretch(self.config, self._controls(),
                                             flags, seed=self._seed,
                                             device=self.device)
            self._stream_cache[key] = eng
        else:
            eng.controls = self._controls()
        return eng

    def reset(self):
        if (self._cfg, self._flags()) in self._stream_cache:
            self._stream().reset(self._seed)

    def process(self, audio_in, output_samples: int) -> np.ndarray:
        """Streaming process(): state carries across calls (reference
        :209).  audio_in [channels, samples] -> [channels, output_samples]
        float32 numpy."""
        return self._stream().process(audio_in, int(output_samples))

    def seek(self, audio_in, playback_rate: float):
        self._stream().seek(audio_in, playback_rate)

    def output_seek(self, audio_in):
        self._stream().output_seek(audio_in)

    def flush(self, output_samples: int,
              playback_rate: float = 0.0) -> np.ndarray:
        return self._stream().flush(int(output_samples), playback_rate)

    # ---- controls and flags -----------------------------------------------
    def _controls(self) -> Controls:
        return Controls(self._freq_multiplier, self._freq_tonality_limit,
                        self._formant_multiplier,
                        f32(f32(1) / self._formant_multiplier),
                        self._formant_base_freq)

    def _flags(self) -> SpectralFlags:
        mapped = (self._custom_map is not None
                  or float(self._freq_multiplier) != 1.0)
        return SpectralFlags(
            mapped=mapped,
            process_formants=(float(self._formant_multiplier) != 1.0
                              or (self._formant_compensation and mapped)),
            formant_compensation=self._formant_compensation,
            formant_auto=float(self._formant_base_freq) <= 0,
            random_engine=self._random_engine, custom_map=self._custom_map)

    # ---- offline rendering -------------------------------------------------
    def plan(self, in_samples: int, output_samples: int) -> engine.ExactPlan:
        """The static plan of one (config, input length, output length),
        built once and kept."""
        key = (self.config, int(in_samples), int(output_samples))
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = engine.build_exact_plan(*key)
            self._plan_cache[key] = plan
        return plan

    def exact(self, audio, output_samples: int,
              automation: Optional[dict] = None) -> Tuple[np.ndarray, bool]:
        """Whole-buffer render (reference exact(), :467-491).

        audio: [channels, input_samples] array.  Returns (output, ok), the
        output a float32 numpy array; ok is False (and the output zero) when
        the input is shorter than outputSeekLength, matching the reference.

        `automation` varies controls over the render: a dict with any of
        `semitones`, `transpose_factor`, `tonality_limit`,
        `formant_semitones`, `formant_base` mapping to a scalar, an array of
        one value per block (block_output_times), or a callable f(t)
        evaluated at each block's output time (in seconds with
        `sample_rate=` given, else in samples).

        SST_SILENCE=0 in the environment turns the silence bypass off, as
        in the JAX package.  A clip of exact zeros renders zeros without
        the spectral pipeline (the JAX package's all-zero shortcut)."""
        cfg = self.config
        x = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if x.dim() != 2 or x.shape[0] != cfg.channels:
            raise ValueError(f"audio must be [channels={cfg.channels}, "
                             f"samples]")
        plan = self.plan(x.shape[1], output_samples)
        zeros = np.zeros((cfg.channels, int(output_samples)), np.float32)
        self.last_diagnostics = {"interp_violations": 0}
        if not plan.sched.valid:
            return zeros, False
        # total energy == 0, not the noise floor: a clip of exact zeros
        # renders exact zeros on every path (JAX engine.py:451-487)
        if float((x * x).sum()) == 0:
            return zeros, True
        if automation:
            controls, flags = self._automated(plan, automation)
        else:
            controls, flags = self._controls(), self._flags()
        out = engine.render_exact(
            x[None], plan, controls, flags, seeds=[self._seed],
            silence=os.environ.get("SST_SILENCE", "1") != "0")
        return out[0].cpu().numpy(), True

    def block_output_times(self, plan: engine.ExactPlan) -> np.ndarray:
        """Output-sample index of each processing block of a plan."""
        return np.asarray(plan.arrays["out_pos"], np.int64)

    def _automated(self, plan: engine.ExactPlan, automation: dict):
        """Per-block Controls and their flags from an automation dict (JAX
        api.py:_automated, with the same float32 and float64 steps)."""
        n_b = len(plan.arrays["out_pos"])
        sr = automation.get("sample_rate", None)
        times = plan.arrays["out_pos"].astype(np.float64)
        if sr:
            times = times / float(sr)

        def series(value, default):
            if value is None:
                return np.full(n_b, default, f32)
            if callable(value):
                return np.asarray([value(t) for t in times], f32)
            arr = np.asarray(value, f32)
            if arr.ndim == 0:
                return np.full(n_b, arr, f32)
            if arr.shape != (n_b,):
                raise ValueError(f"automation arrays must have length {n_b} "
                                 f"(one value per block), got {arr.shape}")
            return arr

        if "transpose_factor" in automation:
            mult = series(automation["transpose_factor"],
                          self._freq_multiplier)
        else:
            semis = series(automation.get("semitones"),
                           f32(12 * math.log2(float(self._freq_multiplier))))
            # set_transpose_semitones' factor: exp2 of f32(s)/f32(12)
            mult = np.exp2((semis.astype(f32) / f32(12)).astype(np.float64)
                           ).astype(f32)
        if "tonality_limit" in automation:
            tonality = series(automation["tonality_limit"], 0)
            limit = np.where(
                tonality > 0,
                (tonality.astype(f32)
                 / np.sqrt(mult.astype(np.float64)).astype(f32)).astype(f32),
                f32(1))
        else:
            limit = np.full(n_b, self._freq_tonality_limit, f32)
        fsemis = series(automation.get("formant_semitones"),
                        f32(12 * math.log2(float(self._formant_multiplier))))
        fm = np.exp2((fsemis.astype(f32) / f32(12)).astype(np.float64)
                     ).astype(f32)
        fbase = series(automation.get("formant_base"), self._formant_base_freq)

        mapped = bool((mult != 1).any()) or self._custom_map is not None
        flags = SpectralFlags(
            mapped=mapped,
            process_formants=bool((fm != 1).any()) or (
                self._formant_compensation and mapped),
            formant_compensation=self._formant_compensation,
            formant_auto=bool((fbase <= 0).any()),
            random_engine=self._random_engine, custom_map=self._custom_map)
        controls = Controls(mult, limit.astype(f32), fm,
                            (f32(1) / fm).astype(f32), fbase)
        return controls, flags
