"""The stretch pipeline as an nn.Module: [batch, ch, in] -> [batch, ch, out]."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import engine
from ..config import StretchConfig, device_for
from ..spectral import Controls, SpectralFlags
from ..utils.profiling import span

f32 = np.float32


class StretchModel(nn.Module):
    """One render shape (config, controls, input and output lengths) with
    its static plan.  It has no learned weights: its state is the plan
    (see convert.py).  The device defaults to "cuda"; the CPU runs only
    when asked for (device="cpu"), with the plain versions of the kernels."""

    def __init__(self, cfg: StretchConfig, controls: Controls,
                 flags: SpectralFlags, in_samples: int, out_samples: int,
                 plan: engine.ExactPlan = None, device="cuda"):
        super().__init__()
        self.device = device_for(device, "StretchModel")
        self.cfg, self.controls, self.flags = cfg, controls, flags
        self.in_samples, self.out_samples = in_samples, out_samples
        self.plan = plan or engine.build_exact_plan(cfg, in_samples,
                                                    out_samples)

    @classmethod
    def build(cls, channels: int, sample_rate: float, in_samples: int,
              out_samples: int, semitones: float = 0.0,
              tonality_hz: float = 0.0, formant_semitones: float = 0.0,
              formant_compensation: bool = False,
              formant_base_hz: float = 0.0, cheaper: bool = False,
              split: bool = False, device="cuda") -> "StretchModel":
        """The reference's setters as the JAX package's builder computes
        them: a formant base of 0 Hz (the default) estimates the pitch per
        block."""
        make = (StretchConfig.preset_cheaper if cheaper
                else StretchConfig.preset_default)
        cfg = make(channels, sample_rate, split)
        mult = f32(2.0 ** (f32(semitones) / f32(12)))
        limit = (f32(f32(tonality_hz / sample_rate) / f32(math.sqrt(mult)))
                 if tonality_hz > 0 else f32(1))
        fm = f32(2.0 ** (f32(formant_semitones) / f32(12)))
        controls = Controls(mult, limit, fm, f32(f32(1) / fm),
                            f32(formant_base_hz / sample_rate))
        flags = SpectralFlags(
            mapped=float(mult) != 1.0,
            process_formants=(float(fm) != 1.0 or (formant_compensation
                                                   and float(mult) != 1.0)),
            formant_compensation=formant_compensation,
            formant_auto=formant_base_hz <= 0)
        return cls(cfg, controls, flags, in_samples, out_samples,
                   device=device)

    def forward(self, audio, seed: int = 0,
                plain: bool = False) -> torch.Tensor:
        """One clip [ch, in] -> [ch, out]; seed seeds the randomised regime
        above 2x."""
        return self.batched(torch.as_tensor(audio)[None], [seed], plain)[0]

    def batched(self, audio, seeds=None, plain: bool = False) -> torch.Tensor:
        """[batch, ch, in] -> [batch, ch, out].  seeds: one integer a clip
        for the randomised regime above 2x, by default 0, 1, ..., batch - 1
        (the JAX package's `batched`).  plain=True runs the plain PyTorch
        versions of the kernels (for comparisons on the card)."""
        with span("sst.render.copy_in"):
            audio = torch.as_tensor(audio, dtype=torch.float32,
                                    device=self.device)
        if audio.shape[1:] != (self.cfg.channels, self.in_samples):
            raise ValueError(f"expected [batch, {self.cfg.channels}, "
                             f"{self.in_samples}] audio, got "
                             f"{tuple(audio.shape)}")
        if seeds is not None:
            seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
        return engine.render_exact(audio, self.plan, self.controls,
                                   self.flags, plain, seeds)
