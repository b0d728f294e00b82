"""Streaming scheduler: the AudioWorklet wrapper's API over the port's
streaming engine (the port of signalsmith_stretch_tpu/scheduler.py).

Mirrors the reference's JS layer (web/web-wrapper.js, SURVEY.md §2.3): a node
bound to a sample rate and channel count that owns

  - a piecewise-linear time map of scheduled segments
    {active, input, output, rate, semitones, tonalityHz, formantSemitones,
     formantCompensation, formantBaseHz, loopStart, loopEnd}
    (web-wrapper.js:18-30),
  - an appendable audio-buffer store (addBuffers/dropBuffers, :109-144),
  - per-render-quantum processing in three modes (:247-322):
      inactive        -> zeros (engine still runs)
      live input      -> seek-primed process(n, n)
      buffer playback -> fill bufferLength of history from the store, then
                         seek(bufferLength, rate) + process(0, n) each quantum
                         (the constant re-seek that makes the history window
                         rate-independent),
  - input-time feedback (setUpdateInterval/inputTime, :392-399).

The engines (streaming.StreamingStretch, one per flag tuple) run on the
node's `device`: "cuda" by default, the CPU when asked for; plain=True runs
the plain versions of the kernels.  `process_quanta` renders a run of
quanta that share a segment through StreamingStretch.process_many(_live):
one copy in and one out for the run, bit-equal to quantum by quantum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from .config import StretchConfig, device_for
from .spectral import Controls, SpectralFlags
from .streaming import StreamingStretch
from .utils.profiling import span

f32 = np.float32


@dataclasses.dataclass
class Segment:
    """One schedule() entry (web/release/README.md:15-29)."""
    active: bool = True
    input: float = 0.0            # input time (seconds) at `output`
    output: float = 0.0           # output time (seconds) this segment starts
    rate: float = 1.0
    semitones: float = 0.0
    tonality_hz: float = 8000.0
    formant_semitones: float = 0.0
    formant_compensation: bool = False
    formant_base_hz: float = 0.0
    loop_start: float = -1.0      # seconds; < 0 disables looping
    loop_end: float = -1.0

    def input_at(self, t: float) -> float:
        x = self.input + (t - self.output) * self.rate
        if self.loop_end > self.loop_start >= 0 and x > self.loop_start:
            span = self.loop_end - self.loop_start
            x = self.loop_start + (x - self.loop_start) % span
        return x


class StretchNode:
    """SignalsmithStretch(audioContext, options) analogue (web-wrapper.js:338)."""

    def __init__(self, sample_rate: int, channels: int = 2,
                 quantum: int = 128, preset: str = "default",
                 split_computation: bool = False, seed: int = 0,
                 device="cuda", plain: bool = False):
        self.device = device_for(device, "StretchNode")
        self.plain = plain
        self.sample_rate = int(sample_rate)
        self.channels = channels
        self.quantum = quantum
        self._seed = seed
        self._segments: List[Segment] = []
        self._buffers: Optional[np.ndarray] = None   # [ch, n] store
        self._out_time = 0.0                         # seconds of output rendered
        self._input_time = 0.0
        self._update_interval = 0.0
        self._update_cb: Optional[Callable] = None
        self._since_update = 0.0
        self.configure(preset=preset, split_computation=split_computation)

    # ---- configure({blockMs, intervalMs, splitComputation, preset}) -------
    def configure(self, block_ms: Optional[float] = None,
                  interval_ms: Optional[float] = None,
                  split_computation: Optional[bool] = None,
                  preset: Optional[str] = None):
        split = bool(split_computation) if split_computation is not None else False
        if block_ms is not None and interval_ms is not None:
            cfg = StretchConfig(self.channels,
                                int(self.sample_rate * block_ms / 1000),
                                int(self.sample_rate * interval_ms / 1000),
                                split)
        elif preset == "cheaper":
            cfg = StretchConfig.preset_cheaper(self.channels, self.sample_rate,
                                               split)
        else:
            cfg = StretchConfig.preset_default(self.channels, self.sample_rate,
                                               split)
        self.cfg = cfg
        self._engine_cache: Dict = {}
        self._current: Optional[StreamingStretch] = None

    # ---- buffers (web-wrapper.js:109-144) ---------------------------------
    def add_buffers(self, audio: np.ndarray):
        """Append [ch, n] samples to the playback store."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 2 or audio.shape[0] != self.channels:
            raise ValueError(f"buffers must be [{self.channels}, n]")
        if self._buffers is None:
            self._buffers = audio.copy()
        else:
            self._buffers = np.concatenate([self._buffers, audio], axis=1)

    def drop_buffers(self):
        self._buffers = None

    @property
    def buffer_seconds(self) -> float:
        return 0.0 if self._buffers is None else (
            self._buffers.shape[1] / self.sample_rate)

    # ---- schedule/start/stop ----------------------------------------------
    def schedule(self, active: bool = True, **kwargs) -> Segment:
        seg = Segment(active=active,
                      output=kwargs.pop("output", self._out_time), **kwargs)
        # segments are kept sorted by output time; later entries win
        self._segments = [s for s in self._segments if s.output < seg.output]
        self._segments.append(seg)
        return seg

    def start(self, input: float = 0.0, rate: float = 1.0, **kwargs):
        return self.schedule(active=True, input=input, rate=rate, **kwargs)

    def stop(self):
        return self.schedule(active=False, rate=0.0)

    # ---- latency/time feedback --------------------------------------------
    def latency(self) -> dict:
        return {"input": self.cfg.input_latency / self.sample_rate,
                "output": self.cfg.output_latency / self.sample_rate}

    @property
    def input_time(self) -> float:
        return self._input_time

    def set_update_interval(self, seconds: float, callback: Callable):
        self._update_interval = seconds
        self._update_cb = callback

    # ---- engine plumbing ---------------------------------------------------
    def _engine_for(self, seg: Segment) -> StreamingStretch:
        sr = self.sample_rate
        mult = f32(2.0 ** (f32(seg.semitones) / f32(12)))
        limit = (f32(f32(seg.tonality_hz / sr) / f32(math.sqrt(mult)))
                 if seg.tonality_hz > 0 else f32(1))
        fm = f32(2.0 ** (f32(seg.formant_semitones) / f32(12)))
        flags = SpectralFlags(
            mapped=float(mult) != 1.0,
            process_formants=(float(fm) != 1.0
                              or (seg.formant_compensation
                                  and float(mult) != 1.0)),
            formant_compensation=seg.formant_compensation,
            formant_auto=seg.formant_base_hz <= 0)
        key = (flags.mapped, flags.process_formants,
               flags.formant_compensation, flags.formant_auto)
        controls = Controls(
            freq_multiplier=mult, freq_tonality_limit=limit,
            formant_multiplier=fm, inv_formant_multiplier=f32(1) / fm,
            formant_base_freq=f32(seg.formant_base_hz / sr))
        eng = self._engine_cache.get(key)
        if eng is None:
            eng = StreamingStretch(self.cfg, controls, flags, seed=self._seed,
                                   device=self.device, plain=self.plain)
            self._engine_cache[key] = eng
        else:
            eng.controls = controls
        return eng

    def _segment_at(self, t: float) -> Optional[Segment]:
        seg = None
        for s in self._segments:
            if s.output <= t:
                seg = s
        return seg

    def _read_store(self, start: int, length: int) -> np.ndarray:
        out = np.zeros((self.channels, length), np.float32)
        if self._buffers is None:
            return out
        n = self._buffers.shape[1]
        a = max(0, start)
        b = min(n, start + length)
        if b > a:
            out[:, a - start:b - start] = self._buffers[:, a:b]
        return out

    # ---- the render quantum (web-wrapper.js:215-330) ----------------------
    def process_quantum(self, live_input: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        n = self.quantum
        sr = self.sample_rate
        with span("sst.node.quantum"):
            with span("sst.node.history"):
                t = self._out_time + self.cfg.output_latency / sr
                seg = self._segment_at(t)
                active = seg is not None and seg.active
                if active:
                    eng = self._engine_for(seg)
                if active and live_input is None:
                    # buffer playback: fill history, constant re-seek
                    # (:267-322)
                    buf_len = self.cfg.input_latency + self.cfg.output_latency
                    in_t = seg.input_at(t)
                    end = int(round(in_t * sr))
                    hist = self._read_store(end - buf_len, buf_len)

            if not active:
                out = np.zeros((self.channels, n), np.float32)
            elif live_input is not None:
                live_input = np.asarray(live_input, np.float32)
                out = eng.process(live_input[:, :n], n)
                self._input_time = self._out_time
            else:
                self._input_time = in_t
                eng.seek(hist, seg.rate)
                out = eng.process(np.zeros((self.channels, 0), np.float32),
                                  n)
            self._advance(n)
            return out

    def _advance(self, n: int):
        dt = n / self.sample_rate
        self._out_time += dt
        self._since_update += dt
        if (self._update_cb is not None and self._update_interval > 0
                and self._since_update >= self._update_interval):
            self._since_update = 0.0
            self._update_cb(self._input_time)

    # ---- batched quanta (one copy in and one out per run) -------------------
    def process_quanta(self, n_quanta: int,
                       live_input: Optional[np.ndarray] = None) -> np.ndarray:
        """Render `n_quanta` quanta, batching contiguous runs that share one
        segment (same engine, same controls) into one call of
        StreamingStretch.process_many / process_many_live.

        Bit-equal to n_quanta process_quantum() calls: the history windows,
        re-seeks and state threading are the same; a run copies its inputs
        to the device once and its outputs back once, and its quanta never
        wait for the card in between."""
        n = self.quantum
        sr = self.sample_rate
        outs = []
        q = 0
        while q < n_quanta:
            t = self._out_time + self.cfg.output_latency / sr
            seg = self._segment_at(t)
            # run length: quanta until the next segment boundary
            run = n_quanta - q
            for s in self._segments:
                if s.output > t:
                    run = min(run, max(1, int(math.ceil(
                        (s.output - t) * sr / n))))
                    break
            if seg is None or not seg.active:
                outs.append(np.zeros((self.channels, run * n), np.float32))
                for _ in range(run):
                    self._advance(n)
            elif live_input is not None:
                s0 = q * n
                li = np.asarray(live_input[:, s0:s0 + run * n], np.float32)
                if li.shape[1] < run * n:
                    li = np.pad(li, ((0, 0), (0, run * n - li.shape[1])))
                eng = self._engine_for(seg)
                chunk = eng.process_many_live(
                    li.reshape(self.channels, run, n).transpose(1, 0, 2), n)
                outs.append(chunk.transpose(1, 0, 2).reshape(
                    self.channels, run * n))
                for _ in range(run):
                    self._input_time = self._out_time
                    self._advance(n)
            else:
                eng = self._engine_for(seg)
                buf_len = self.cfg.input_latency + self.cfg.output_latency
                hists = np.empty((run, self.channels, buf_len), np.float32)
                for i in range(run):
                    in_t = seg.input_at(t + i * n / sr)
                    end = int(round(in_t * sr))
                    hists[i] = self._read_store(end - buf_len, buf_len)
                chunk = eng.process_many(
                    hists, np.full(run, seg.rate, np.float32), n)
                outs.append(chunk.transpose(1, 0, 2).reshape(
                    self.channels, run * n))
                for i in range(run):
                    self._input_time = seg.input_at(
                        self._out_time + self.cfg.output_latency / sr)
                    self._advance(n)
            q += run
        return np.concatenate(outs, axis=1)

    def render(self, seconds: float,
               live_input: Optional[np.ndarray] = None,
               batched: bool = False) -> np.ndarray:
        """Drive whole quanta for `seconds` of output.  With batched=True,
        contiguous same-segment runs render in one process_many call each."""
        n_quanta = int(round(seconds * self.sample_rate / self.quantum))
        if batched:
            return self.process_quanta(n_quanta, live_input)
        outs = []
        for q in range(n_quanta):
            li = None
            if live_input is not None:
                s = q * self.quantum
                li = live_input[:, s:s + self.quantum]
                if li.shape[1] < self.quantum:
                    li = np.pad(li, ((0, 0), (0, self.quantum - li.shape[1])))
            outs.append(self.process_quantum(li))
        return np.concatenate(outs, axis=1)
