"""Offline rendering engine: exact() as a few batched tensor stages.

The reference's exact() (signalsmith-stretch.h:467-491) chains outputSeek ->
process -> flush over shared ring state.  Here the chain is: static schedule
(schedule.py, host) -> timeline and frame windows -> batched modified-DFT
analysis (kernel D) -> the planned spectral pipeline (planner + diagonal
sweep) -> batched inverse modified DFT (kernel K) -> overlap-add and
WOLA-normalised assembly with the pre-roll cancellation (outputSeek
:198-203), the reversed-tail subtraction (flush :444-454) and the silence
bypass (:240-278), closed-form per output sample (kernel L).
Every stage carries the clip batch as its leading dimension.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import planner, spectral, stft, wavefront
from . import schedule as sched_mod
from .config import MAX_CLEAN_STRETCH, StretchConfig
from .ops import dft, idft, ola
from .tables import on_device
from .utils.profiling import span

f32 = np.float32
plans_built = 0       # build_exact_plan calls (utils/profiling's guard)


@dataclasses.dataclass(frozen=True)
class ExactPlan:
    """Everything static needed to render one (config, in_len, out_len) shape."""
    cfg: StretchConfig
    sched: sched_mod.ExactSchedule
    basis: stft.StftBasis
    consts: spectral.SpectralConsts
    weight: np.ndarray          # [ring_len] float32, floored WOLA weights
    frame_idx: np.ndarray       # [nBlocks, block] timeline indices
    re_rows: np.ndarray         # indices of blocks needing re-analysis
    re_frame_idx: np.ndarray    # [nRe, block] timeline indices for those
    arrays: dict                # per-block arrays and their plan_tables
    silence: "SilencePlan" = None


@dataclasses.dataclass(frozen=True)
class SilencePlan:
    """Static data for the silence bypass (signalsmith-stretch.h:240-278).

    In exact() the counter starts at 0 (reset, :56), so the pre-roll process
    always runs normally; the main process bypasses iff its whole input
    segment and the pre-roll segment are below the noise floor and the
    pre-roll already pushed the counter past 2*block (surplus >= 2*block);
    the flush zero-input process bypasses iff the main segment was silent and
    the counter crosses 2*block by then.  Bypassed stages write passthrough
    or zeros, never touch the ring and do not advance the output read head,
    so the bypass tails re-read a restricted-block ring at an un-advanced
    head.  Only the two energy tests depend on the audio.
    """
    possible: bool                      # any bypass statically reachable
    main_possible: bool                 # surplus >= 2*block
    flush_possible_pre: bool            # surplus + main_in >= 2*block
    flush_possible_alone: bool          # main_in >= 2*block
    pass_idx: np.ndarray                # [main_out] int32 into audio, or None
    pre_spans: tuple                    # ((k, a, b, off), ...) block slices
    pre_weight: np.ndarray              # [2*T] float32 restricted WOLA weight
    pm_spans: tuple                     # the same for pre-roll + main blocks
    pm_weight: np.ndarray


def _tail_window(basis: stft.StftBasis, out_pos: np.ndarray, ring_len: int,
                 w0: int, width: int):
    """Static contributions of the given blocks to ring[w0:w0+width]:
    spans (block row k, ring start a, ring end b, block-local offset) and the
    restricted floored WOLA weight over the window."""
    block = basis.block_samples
    spans = []
    for k, p in enumerate(out_pos):
        p = int(p)
        a, b = max(w0, p), min(w0 + width, p + block)
        if a < b:
            spans.append((k, a, b, a - p))
    weight = stft.wola_weight(basis, ring_len, out_pos)[w0:w0 + width]
    return tuple(spans), weight


def build_silence_plan(sch: sched_mod.ExactSchedule, basis: stft.StftBasis,
                       arrays: dict) -> SilencePlan:
    block = sch.cfg.block_samples
    main_possible = sch.surplus >= 2 * block and sch.main_out > 0
    flush_pre = sch.surplus + sch.main_in >= 2 * block
    flush_alone = sch.main_in >= 2 * block
    possible = (main_possible or
                ((flush_pre or flush_alone) and sch.flush_block_out > 0))
    if not possible:
        return SilencePlan(False, False, False, False, None, (),
                           np.zeros(0, np.float32), (), np.zeros(0, np.float32))
    L, T = sch.preroll_len, sch.tail_len
    # bypass passthrough: outputs[i] = inputs[seekLength + i % mainIn] (:253-256)
    if sch.main_in > 0:
        pass_idx = (sch.seek_length
                    + np.arange(sch.main_out, dtype=np.int64) % sch.main_in
                    ).astype(np.int32)
    else:
        pass_idx = None
    out_pos = arrays["out_pos"]
    n_pre, n_pm = sch.n_preroll_blocks, sch.n_preroll_blocks + sch.n_main_blocks
    pre_spans, pre_weight = _tail_window(basis, out_pos[:n_pre], sch.ring_len,
                                         L, 2 * T)
    pm_spans, pm_weight = _tail_window(basis, out_pos[:n_pm], sch.ring_len,
                                       L + sch.main_out, 2 * T)
    return SilencePlan(True, main_possible, flush_pre, flush_alone, pass_idx,
                       pre_spans, pre_weight, pm_spans, pm_weight)


def plan_tables(arrays: dict, cfg: StretchConfig) -> dict:
    """The schedule's arrays and the tables a render reads, derived from
    them once a plan: the frame starts (the main frames', then the
    re-analysed ones', int64); each block's input block (src_input, -1
    before the first new block) as a gather index and mask, the same for
    prevInput's base; the clamped time factors tf and ltf (float32)."""
    new, reanalyse = arrays["new_spectrum"], arrays["reanalyse"]
    ends, block = arrays["analysis_end"], cfg.block_samples
    idx = np.arange(len(new))
    src_input = np.maximum.accumulate(np.where(new, idx, -1))
    m_prev = np.concatenate([[-1], src_input[:-1]])  # last new block < k
    fresh = new & ~reanalyse
    tf = np.maximum(arrays["time_factor"], f32(1.0 / MAX_CLEAN_STRETCH))
    starts = [ends - block, ends[reanalyse] - cfg.interval_samples - block]
    return {**arrays, "frame_starts": np.concatenate(starts).astype(np.int64),
            "input_idx": np.maximum(src_input, 0),
            "input_valid": src_input >= 0,
            "base_idx": np.where(fresh, np.maximum(m_prev, 0),
                                 np.maximum(src_input, 0)),
            "base_keep": np.where(fresh, m_prev >= 0,
                                  src_input >= 0) | reanalyse,
            "tf": tf, "ltf": (f32(cfg.long_vertical_step) * tf).astype(f32)}


def build_exact_plan(cfg: StretchConfig, in_samples: int,
                     out_samples: int) -> ExactPlan:
    global plans_built
    plans_built += 1
    sch = sched_mod.build_exact_schedule(cfg, in_samples, out_samples)
    basis = stft.StftBasis.for_config(cfg)
    consts = spectral.SpectralConsts.for_config(cfg)
    if not sch.valid:
        return ExactPlan(cfg, sch, basis, consts, np.zeros(1, np.float32),
                         np.zeros((0, 0), np.int32), np.zeros(0, np.int32),
                         np.zeros((0, 0), np.int32), {})
    arrays = plan_tables(sched_mod.block_arrays(sch), cfg)
    block = cfg.block_samples
    ends = arrays["analysis_end"]
    base = np.arange(block, dtype=np.int32)
    frame_idx = (ends[:, None] - block + base[None, :]).astype(np.int32)
    # analysis of the previous frame, one interval back (:335-341)
    re_rows = np.where(arrays["reanalyse"])[0].astype(np.int32)
    re_frame_idx = (ends[re_rows, None] - cfg.interval_samples - block
                    + base[None, :]).astype(np.int32)
    # frames may reach before the timeline start (conceptual zero history)
    weight = stft.wola_weight(basis, sch.ring_len, arrays["out_pos"])
    return ExactPlan(cfg, sch, basis, consts, weight, frame_idx, re_rows,
                     re_frame_idx, arrays,
                     silence=build_silence_plan(sch, basis, arrays))


def _build_timeline(audio: torch.Tensor, plan: ExactPlan) -> torch.Tensor:
    """audio [batch, ch, in_samples] -> virtual input timeline
    [batch, ch, timeline_len]."""
    parts = []
    for seg in plan.sched.segments:
        if seg.kind == "zeros":
            parts.append(audio.new_zeros(audio.shape[:2] + (seg.length,)))
        else:
            parts.append(audio[..., seg.src_offset:seg.src_offset + seg.length])
    return torch.cat(parts, -1)


def window_index(starts: np.ndarray) -> np.ndarray:
    """The frame starts as indices into gather_frames' padded windows."""
    return starts.astype(np.int64) + max(0, -int(starts.min()))


def gather_frames(timeline: torch.Tensor, starts: np.ndarray,
                  block: int) -> torch.Tensor:
    """Frame windows: timeline [batch, ch, T] -> [batch, nF, ch, block].

    One strided view of every window (`unfold`) indexed at the static frame
    starts; starts may be negative for the first frames (zero history)."""
    T = timeline.shape[-1]
    front = max(0, -int(starts.min()))
    back = max(0, int(starts.max()) + block - T)
    windows = F.pad(timeline, (front, back)).unfold(-1, block, 1)
    idx = on_device(starts, timeline.device, window_index)
    return windows[:, :, idx].transpose(1, 2)


def analyze_stage(audio: torch.Tensor, plan: ExactPlan):
    """Timeline + frames + modified-DFT analysis (kernel D on the card).
    Returns (spectra, prev_spectra), both [batch, nB, ch, B] complex64;
    prev_spectra holds the re-analysis one interval back for the blocks in
    plan.re_rows, else 0."""
    timeline = _build_timeline(audio, plan)
    nB = plan.frame_idx.shape[0]
    # one window gather + one batched DFT for main and re-analysis frames
    both = dft.analyze(gather_frames(timeline, plan.arrays["frame_starts"],
                                     plan.cfg.block_samples), plan.basis)
    if not len(plan.re_rows):
        return both, torch.zeros_like(both)
    spectra = both[:, :nB]
    if len(plan.re_rows) == nB:     # fixed-rate renders re-analyse every block
        return spectra, both[:, nB:]
    prev = torch.zeros_like(spectra)
    prev[:, on_device(plan.re_rows, audio.device)] = both[:, nB:]
    return spectra, prev


def synthesis_stage(out_specs: torch.Tensor, plan: ExactPlan,
                    audio: torch.Tensor = None) -> torch.Tensor:
    """Inverse modified DFT + overlap-add + WOLA-normalised assembly:
    out_specs [batch, ch, nB, B] complex64 -> [batch, ch, out_samples]
    (kernels K and L on the card; their plain versions, stft.synthesize and
    ops/ola.assemble_plain, on a CPU tensor or inside ops.plain()).  With
    `audio` given, the silence bypass (:240-278) selects, per clip, between
    the normal assembly and passthrough/zeros with restricted-ring tails;
    without it the bypass is off."""
    return ola.assemble(idft.synthesize(out_specs, plan.basis), plan,
                        audio=audio)


def render_exact(audio: torch.Tensor, plan: ExactPlan,
                 controls: spectral.Controls, flags: spectral.SpectralFlags,
                 seeds=None, silence: bool = True) -> torch.Tensor:
    """audio [batch, ch, in_samples] float32 -> [batch, ch, out_samples].
    The kernels run on a CUDA tensor, their plain versions on a CPU one or
    inside ops.plain().  seeds: one integer a clip for the randomised
    regime above 2x (default 0, 1, ...,
    as the JAX package's batched render).  silence=False turns the silence
    bypass off (the JAX package's SST_SILENCE=0): every clip takes the
    normal path, which leaves a loud clip's render as it was."""
    if not plan.sched.valid:
        return audio.new_zeros(audio.shape[:2] + (plan.sched.out_samples,))
    with span("sst.render"):
        with span("sst.render.analysis"):
            spectra, prev_spectra = analyze_stage(audio, plan)
        with span("sst.render.plan"):
            inputs = planner.plan_spectral(spectra, prev_spectra, plan.arrays,
                                           controls, flags, plan.consts,
                                           seeds=seeds)
        with span("sst.render.sweep"):
            out_specs = wavefront.sweep(inputs,
                                        plan.consts.long_vertical_step)
        with span("sst.render.synthesis"):
            return synthesis_stage(out_specs, plan,
                                   audio=audio if silence else None)
