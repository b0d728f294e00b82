"""The stretch pipeline as an nn.Module: [batch, ch, in] -> [batch, ch, out]."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import engine, ops, tables
from ..config import StretchConfig, device_for
from ..spectral import Controls, SpectralFlags
from ..utils.profiling import span

f32 = np.float32

# whole clips a pinned staging block of the copy in holds: 4 clips of 10 s
# stereo float32 at 48 kHz (15.4 MB) staged 32 clips fastest on an H100
# against 1, 2, 8, 16 and 32 (PERF.md, the entry layer)
STAGE_CLIPS = 4


def clip_chunks(batch: int, per: int):
    """The copy in's chunks of whole clips, [(start, stop), ...] in order:
    they cover range(batch) exactly, each at most `per` clips."""
    return [(a, min(a + per, batch)) for a in range(0, batch, per)]


def copy_in(host: torch.Tensor, device) -> torch.Tensor:
    """A host tensor [batch, ...] of any dtype and strides -> float32 on
    `device`.  On the card, a pinned input goes straight to one DMA;
    any other is staged through two pinned blocks a chunk of whole clips
    at a time (clip_chunks): the CPU's copy_ converts the chunk into a
    block in one pass while the previous chunk's non-blocking DMA runs,
    and a block is refilled only once its last DMA's event has completed.
    On the CPU the same walk runs through pageable blocks."""
    out = torch.empty(host.shape, dtype=torch.float32, device=device)
    cuda = out.device.type == "cuda"
    if cuda and host.is_pinned():
        return out.copy_(host, non_blocking=True)
    n = host.shape[0]
    blocks, sent = [], [None, None]
    for k, (a, b) in enumerate(clip_chunks(n, STAGE_CLIPS)):
        j = k % 2
        if j == len(blocks):
            blocks.append(torch.empty((min(STAGE_CLIPS, n),) + host.shape[1:],
                                      dtype=torch.float32, pin_memory=cuda))
        elif sent[j] is not None:
            sent[j].synchronize()
        stage = blocks[j][:b - a]
        stage.copy_(host[a:b])
        out[a:b].copy_(stage, non_blocking=cuda)
        if cuda:
            sent[j] = torch.cuda.Event()
            sent[j].record(torch.cuda.current_stream(out.device))
    return out


def copy_out(out: torch.Tensor) -> torch.Tensor:
    """A render on the card -> the same values in a new pinned host tensor
    of its own (the caching host allocator hands a block back only once
    its owner is freed and its copy has completed), final on return."""
    with span("sst.render.copy_out"):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
    return host


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
        # a table first made inside a render would take a block of the
        # caching allocator that a later render's scratch needs
        tables.prepare(self.plan, controls, flags, self.device)

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
        above 2x.  The result lives where `batched` puts it: on a model on
        the card, host input (numpy, a CPU tensor) gives a pinned CPU
        tensor and a CUDA tensor gives a CUDA tensor."""
        return self.batched(torch.as_tensor(audio)[None], [seed], plain)[0]

    def batched(self, audio, seeds=None, plain: bool = False) -> torch.Tensor:
        """[batch, ch, in] -> [batch, ch, out].  seeds: one integer a clip
        for the randomised regime above 2x, by default 0, 1, ..., batch - 1
        (the JAX package's `batched`).  plain=True runs the plain PyTorch
        versions of the kernels (ops.plain(), for comparisons on the card).

        The output follows the input's place.  On a model on the card,
        host input (numpy, or a CPU tensor) is staged to the card through
        pinned memory (copy_in) and its render comes back as a CPU tensor
        in pinned memory, its own storage, final when this returns: its
        `.cpu()` copies nothing and `.numpy()` is a view.  A CUDA tensor's
        render stays on the card.  A model on the CPU returns a CPU
        tensor."""
        shape = tuple(np.shape(audio))
        if shape[1:] != (self.cfg.channels, self.in_samples):
            raise ValueError(f"expected [batch, {self.cfg.channels}, "
                             f"{self.in_samples}] audio, got {shape}")
        host_path = self.device.type == "cuda" and not (
            isinstance(audio, torch.Tensor) and audio.device.type != "cpu")
        with span("sst.render.copy_in"):
            if host_path:
                audio = copy_in(torch.as_tensor(audio), self.device)
            else:
                audio = torch.as_tensor(audio, dtype=torch.float32,
                                        device=self.device)
        if seeds is not None:
            seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
        with ops.plain(plain):
            out = engine.render_exact(audio, self.plan, self.controls,
                                      self.flags, seeds)
        return copy_out(out) if host_path else out
