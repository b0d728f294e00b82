"""Carry a render's static state, and a stream's state, across as plain
numpy arrays.

The system has no learned weights: its state is the static plan (schedule,
frame indices, WOLA weight, silence plan, STFT basis, spectral constants)
plus the controls (scalars, or per-block arrays under automation) and
flags.  `plan_to_arrays` flattens it into a dict of
numpy arrays and scalars, reading attributes only, so it accepts the plan of
either package; `plan_from_arrays` and `controls_from_arrays` rebuild the
port's objects from such a dict.

A stream's state (streaming.StreamState) goes across in the layout of the
JAX package's `StreamingStretch.state_dict()`: `stream_state_to_arrays`
and `stream_state_from_arrays`, so that a stream started in either
package goes on in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from . import schedule as sched_mod
from .config import StretchConfig
from .engine import ExactPlan, SilencePlan, plan_tables
from .spectral import (Controls, SpectralCarry, SpectralConsts,
                       SpectralFlags)
from .stft import StftBasis
from .streaming import StreamState

_CFG = ("channels", "block_samples", "interval_samples", "split_computation")
_SCHED = ("in_samples", "out_samples", "valid", "timeline_len", "ring_len",
          "preroll_len", "main_out", "flush_block_out", "tail_len",
          "playback_rate", "seek_length", "surplus", "seek_samples", "main_in",
          "n_preroll_blocks", "n_main_blocks")
_BASIS = ("window", "twist", "fft_samples", "block_samples", "bands")
_CONSTS = ("bands", "channels", "fft_samples", "interval",
           "long_vertical_step", "smoothing_bins", "slew", "rotor",
           "band_freq")
_PLAN = ("weight", "frame_idx", "re_rows", "re_frame_idx")
_SILENCE = ("possible", "main_possible", "flush_possible_pre",
            "flush_possible_alone", "pre_weight", "pm_weight")
_ARRAYS = ("analysis_end", "out_pos", "new_spectrum", "reanalyse",
           "time_factor")
_SEGMENT_KINDS = ("zeros", "input")
_CONTROLS = Controls._fields
_FLAGS = ("mapped", "process_formants", "formant_compensation",
          "formant_auto")


def _spans(spans) -> np.ndarray:
    return np.asarray(spans, np.int64).reshape(-1, 4)


def plan_to_arrays(plan, controls=None, flags=None) -> dict:
    """Flatten a plan (and optionally its controls and flags) to numpy."""
    d = {}
    for k in _CFG:
        d["cfg." + k] = np.asarray(getattr(plan.cfg, k))
    for k in _SCHED:
        d["sched." + k] = np.asarray(getattr(plan.sched, k))
    d["sched.segments"] = np.asarray(
        [(_SEGMENT_KINDS.index(s.kind), s.length, s.src_offset)
         for s in plan.sched.segments], np.int64).reshape(-1, 3)
    for k in _BASIS:
        d["basis." + k] = np.asarray(getattr(plan.basis, k))
    for k in _CONSTS:
        d["consts." + k] = np.asarray(getattr(plan.consts, k))
    for k in _PLAN:
        d[k] = np.asarray(getattr(plan, k))
    for k in _ARRAYS:
        if k in plan.arrays:
            d["arrays." + k] = np.asarray(plan.arrays[k])
    sil = plan.silence
    if sil is not None:
        for k in _SILENCE:
            d["silence." + k] = np.asarray(getattr(sil, k))
        if sil.pass_idx is not None:
            d["silence.pass_idx"] = np.asarray(sil.pass_idx)
        d["silence.pre_spans"] = _spans(sil.pre_spans)
        d["silence.pm_spans"] = _spans(sil.pm_spans)
    if controls is not None:
        # scalars, or [nB] arrays of per-block values (automation)
        for k in _CONTROLS:
            d["controls." + k] = np.asarray(getattr(controls, k), np.float32)
    if flags is not None:
        if getattr(flags, "custom_map", None) is not None:
            # a callable is no array: dropping it would render another map
            raise ValueError("plan_to_arrays: a custom frequency map cannot "
                             "be carried as arrays; set it on the flags "
                             "that controls_from_arrays returns")
        for k in _FLAGS:
            d["flags." + k] = np.asarray(bool(getattr(flags, k)))
    return d


def _scalar(v):
    return v.item() if isinstance(v, np.ndarray) and v.ndim == 0 else v


def plan_from_arrays(d: dict) -> ExactPlan:
    """Rebuild the port's ExactPlan from a plan_to_arrays dict."""
    cfg = StretchConfig(*[_scalar(d["cfg." + k]) for k in _CFG])
    sch = sched_mod.ExactSchedule(cfg=cfg, **{
        k: _scalar(d["sched." + k]) for k in _SCHED})
    sch.playback_rate = np.float32(sch.playback_rate)
    sch.segments = [sched_mod.TimelineSegment(_SEGMENT_KINDS[kind], int(n),
                                              int(src))
                    for kind, n, src in d["sched.segments"]]
    arrays = {k: d["arrays." + k] for k in _ARRAYS if "arrays." + k in d}
    if arrays:
        sch.blocks = [sched_mod.BlockRecord(int(e), int(p), bool(n), bool(r),
                                            np.float32(tf))
                      for e, p, n, r, tf in zip(*[arrays[k] for k in _ARRAYS])]
        arrays = plan_tables(arrays, cfg)
    basis = StftBasis(*[_scalar(d["basis." + k]) for k in _BASIS])
    consts = SpectralConsts(*[_scalar(d["consts." + k]) for k in _CONSTS])
    silence = None
    if "silence.possible" in d:
        s = {k: _scalar(d["silence." + k]) for k in _SILENCE}
        silence = SilencePlan(
            s["possible"], s["main_possible"], s["flush_possible_pre"],
            s["flush_possible_alone"], d.get("silence.pass_idx"),
            tuple(tuple(int(v) for v in row) for row in d["silence.pre_spans"]),
            s["pre_weight"],
            tuple(tuple(int(v) for v in row) for row in d["silence.pm_spans"]),
            s["pm_weight"])
    return ExactPlan(cfg, sch, basis, consts,
                     *[d[k] for k in _PLAN], arrays, silence=silence)


def _control(v):
    v = np.asarray(v, np.float32)
    return np.float32(v) if v.ndim == 0 else v.copy()


def controls_from_arrays(d: dict):
    """(Controls, SpectralFlags) from a plan_to_arrays dict: scalar or
    per-block controls; the flags without a random engine (a callable is
    not state: the port draws with its own prng unless one is given)."""
    return (Controls(*[_control(d["controls." + k]) for k in _CONTROLS]),
            SpectralFlags(*[bool(d["flags." + k]) for k in _FLAGS]))


# ---------------------------------------------------------------------------
# A stream's state
# ---------------------------------------------------------------------------
_STREAM_SCALARS = (("samples_since_last", np.int32),
                   ("prev_input_offset", np.int32), ("did_seek", np.bool_),
                   ("seek_time_factor", np.float32),
                   ("silence_counter", np.int32),
                   ("silence_first", np.bool_))


def stream_state_to_arrays(state) -> dict:
    """A port StreamState as the JAX package's state_dict lays it out: the
    buffers as float32 arrays, the scalars as 0-d arrays of their JAX
    dtypes, and "carry" a dict of the SpectralCarry fields (the key as
    uint32[2]).  A JAX stream loads it with its carry as a SpectralCarry:
    `d["carry"] = SpectralCarry(**d["carry"])`."""
    c = state.carry
    carry = {f: getattr(c, f).detach().cpu().numpy()
             for f in ("input", "prev_input", "output", "pred_energy")}
    for f in ("freq_est_weighted", "freq_est_weight"):
        carry[f] = np.asarray(getattr(c, f).detach().cpu().numpy()[0],
                              np.float32)
    carry["rng"] = np.asarray(c.rng, np.uint32)
    d = {"carry": carry}
    for f in ("in_hist", "out_tail", "weight_tail"):
        d[f] = getattr(state, f).detach().cpu().numpy()
    for f, dtype in _STREAM_SCALARS:
        d[f] = np.asarray(getattr(state, f), dtype)
    return d


def stream_state_from_arrays(d: dict, device="cpu"):
    """A port StreamState on `device` from a state_dict of either package
    (its "carry" a dict or a SpectralCarry of arrays)."""
    c = d["carry"]
    c = c._asdict() if hasattr(c, "_asdict") else dict(c)

    def tensor(v, shape=None):
        a = np.array(v, copy=True)
        return torch.as_tensor(a if shape is None else a.reshape(shape),
                               device=device)

    carry = SpectralCarry(
        *[tensor(c[f]) for f in ("input", "prev_input", "output",
                                 "pred_energy")],
        tensor(np.asarray(c["freq_est_weighted"], np.float32), 1),
        tensor(np.asarray(c["freq_est_weight"], np.float32), 1),
        tuple(int(w) for w in np.asarray(c["rng"]).ravel()))
    scalars = {f: dtype(np.asarray(d[f])).item() for f, dtype in
               _STREAM_SCALARS}
    scalars["seek_time_factor"] = np.float32(d["seek_time_factor"])
    return StreamState(carry=carry, **{f: tensor(d[f]) for f in (
        "in_hist", "out_tail", "weight_tail")}, **scalars)
