"""Streaming engine: process/seek/outputSeek/flush with carried state.

The port of signalsmith_stretch_tpu/streaming.py, the reference's streaming
surface (signalsmith-stretch.h:139-464).  A call's block schedule is
decided on the host: the schedule's scalars (samples since the last block,
the previous input offset, the seek latch, the silence counter) and the
PRNG key are host values, so the loop runs exactly the call's blocks (the
JAX package's masked scan over the most blocks a call can have exists only
because `jit` needs static shapes).  Each block analyses its two frames
in one call of the analysis DFT (kernel D) and runs `spectral.
process_block` (kernels C, G, E, F, A and H), whose spectral carry stays
on the stream's device with the WOLA buffer; a call copies its output to
the host once, at its end, and nothing in the loop waits for the card.

Buffers are linear per call, as in the JAX package:
  input   - the last block+interval+1 samples of history plus this call's
            input form a timeline; the blocks' frames are slices of it.
  output  - the WOLA tail (block + 2*interval samples ahead of the read
            head) is carried; each call overlap-adds into [tail | zeros]
            and returns the first n_out normalised samples.

Inputs and outputs are float32 numpy arrays [channels, samples].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import spectral, stft
from .config import NOISE_FLOOR, StretchConfig

f32 = np.float32
_BIG = 1 << 30
_NOT_PORTED = ("{} is not ported yet (ROADMAP.md §1, streaming: "
               "process_many(_live) and the checkpoint utilities)")


class StreamState(NamedTuple):
    """A stream's state (JAX streaming.StreamState): the spectral carry and
    the buffers on the stream's device, the schedule's scalars on the
    host."""
    carry: spectral.SpectralCarry
    in_hist: torch.Tensor       # [ch, block+H+1] float32 input history
    out_tail: torch.Tensor      # [ch, block+2H] float32 WOLA signal tail
    weight_tail: torch.Tensor   # [block+2H] float32 WOLA weight tail
    samples_since_last: int
    prev_input_offset: int
    did_seek: bool
    seek_time_factor: np.float32
    silence_counter: int
    silence_first: bool


def initial_state(cfg: StretchConfig, consts: spectral.SpectralConsts,
                  seed: int = 0, device="cpu") -> StreamState:
    """A fresh stream (JAX streaming.initial_state)."""
    ch, block, H = cfg.channels, cfg.block_samples, cfg.interval_samples

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return StreamState(
        carry=spectral.SpectralCarry.initial(consts, seed, device),
        in_hist=zeros(ch, block + H + 1), out_tail=zeros(ch, block + 2 * H),
        weight_tail=zeros(block + 2 * H), samples_since_last=_BIG,
        prev_input_offset=-1, did_seek=False, seek_time_factor=f32(1),
        silence_counter=0, silence_first=True)


def _energy(audio: np.ndarray) -> np.float32:
    """The silence test's total energy (:231-238), float32 on the host.
    Its summation order is numpy's, not XLA's: the two agree on which side
    of the noise floor (1e-15) an input falls unless its energy is within
    a few ulps of it (the tests' inputs are far from it on either side)."""
    return np.sum(audio * audio, dtype=f32)


class StreamingStretch:
    """Streaming facade bound to one configuration and control setting (JAX
    streaming.StreamingStretch).  `device`: "cuda" (the kernels) or "cpu";
    plain=True runs the plain versions of the kernels on the device."""

    def __init__(self, cfg: StretchConfig, controls: spectral.Controls,
                 flags: spectral.SpectralFlags, seed: int = 0,
                 device="cuda", plain: bool = False):
        self.cfg = cfg
        self.controls = controls
        self.flags = flags
        self.device = torch.device(device)
        self.plain = plain
        self.basis = stft.StftBasis.for_config(cfg)
        self.consts = spectral.SpectralConsts.for_config(cfg)
        self.state = initial_state(cfg, self.consts, seed, self.device)
        w = self.basis.window
        self._w2 = torch.as_tensor((w * w).astype(f32), device=self.device)
        self.blocks = 0           # blocks processed (the spectral steps)

    def reset(self, seed: int = 0):
        self.state = initial_state(self.cfg, self.consts, seed, self.device)

    def _input(self, audio_in) -> np.ndarray:
        a = np.asarray(audio_in, f32)
        if a.ndim != 2 or a.shape[0] != self.cfg.channels:
            raise ValueError("audio_in must be [channels, samples]")
        return a

    # ---- process (:209-419) -----------------------------------------------
    def process(self, audio_in, n_out: int) -> np.ndarray:
        audio = self._input(audio_in)
        n_out = int(n_out)
        cfg, st = self.cfg, self.state
        ch, block, H = cfg.channels, cfg.block_samples, cfg.interval_samples
        n_in = audio.shape[1]
        hist_base = block + H + 1
        x = torch.as_tensor(audio, device=self.device)
        timeline = torch.cat([st.in_hist, x], 1)
        new_hist = timeline[:, timeline.shape[1] - hist_base:]
        is_silent = bool(_energy(audio) < f32(NOISE_FLOOR))

        out = None           # the bypass's (numpy), else the normal path's
        if is_silent:
            if st.silence_counter >= 2 * block:
                # the silence bypass (:240-278): the input passes through
                carry, ssl = st.carry, st.samples_since_last
                if st.silence_first:          # the first silent block clears
                    z = torch.zeros_like(carry.input)
                    carry = carry._replace(input=z, prev_input=z, output=z)
                    ssl = _BIG
                if n_in > 0:
                    out = audio[:, np.arange(n_out) % n_in]
                else:
                    out = np.zeros((ch, n_out), f32)
                st = st._replace(carry=carry, samples_since_last=ssl,
                                 silence_first=False)
            else:
                st = st._replace(silence_counter=st.silence_counter + n_in)
        if out is None:
            st, out = self._normal(st, timeline, n_in, n_out, is_silent)
            out = out.cpu().numpy()          # the call's one copy out
        self.state = st._replace(in_hist=new_hist)
        return out

    def _normal(self, st: StreamState, timeline, n_in: int, n_out: int,
                is_silent: bool):
        """The normal path (:280-419): the call's blocks, in order; the
        output [ch, n_out] stays on the device."""
        cfg = self.cfg
        ch, block, H = cfg.channels, cfg.block_samples, cfg.interval_samples
        dev = self.device
        if not is_silent:
            st = st._replace(silence_counter=0, silence_first=True)
        tail_len = block + 2 * H
        split_shift = H if cfg.split_computation else 0
        buf = torch.cat([st.out_tail, torch.zeros(
            (ch, n_out + block + H), dtype=torch.float32, device=dev)], 1)
        wbuf = torch.cat([st.weight_tail, torch.zeros(
            n_out + block + H, dtype=torch.float32, device=dev)])

        ssl0 = min(st.samples_since_last, _BIG)
        o0 = 0 if ssl0 >= H else H - ssl0
        n_blocks = (n_out - o0 + H - 1) // H if o0 < n_out else 0
        hist_base = block + H + 1
        carry, prev_offset = st.carry, st.prev_input_offset
        did_seek = st.did_seek
        for k in range(n_blocks):
            o_k = o0 + k * H
            # the reference's float32 block arithmetic (:281-325)
            pos_f = f32(f32(o_k) * f32(n_in)) / f32(max(n_out, 1))
            input_offset = int(np.floor(f32(pos_f + f32(0.5))))
            interval = input_offset - prev_offset
            new_spectrum = did_seek or interval > 0
            reanalyse = new_spectrum and (did_seek or abs(interval - H) > 1)
            time_factor = (st.seek_time_factor if did_seek else
                           f32(f32(H) / max(f32(1), f32(interval))))
            head = hist_base + input_offset
            # the block's frame and the one an interval before, analysed in
            # one call (kernel D)
            frames = torch.cat([timeline[:, head - block:head],
                                timeline[:, head - H - block:head - H]])
            specs = stft.analyze(frames, self.basis, self.plain)
            xs = spectral.BlockInputs(specs[:ch], specs[ch:], new_spectrum,
                                      reanalyse, time_factor)
            carry, out_spec = spectral.process_block(
                carry, xs, self.controls, self.flags, self.consts,
                self.plain)
            self.blocks += 1
            pos = o_k + split_shift
            buf[:, pos:pos + block] += stft.synthesize(out_spec, self.basis)
            wbuf[pos:pos + block] += self._w2
            prev_offset, did_seek = input_offset, False

        ssl = (n_out - (o0 + (n_blocks - 1) * H) if n_blocks > 0
               else min(ssl0 + n_out, _BIG))
        out = buf[:, :n_out] / torch.clamp(wbuf[:n_out], min=0.1)
        st = st._replace(carry=carry, out_tail=buf[:, n_out:n_out + tail_len],
                         weight_tail=wbuf[n_out:n_out + tail_len],
                         samples_since_last=ssl,
                         prev_input_offset=prev_offset - n_in,
                         did_seek=did_seek)
        return st, out

    # ---- seek (:139-165) --------------------------------------------------
    def seek(self, audio_in, playback_rate: float):
        """Prime the input history, latch the seek time factor."""
        audio = self._input(audio_in)
        cfg, st = self.cfg, self.state
        block, H = cfg.block_samples, cfg.interval_samples
        n_in = audio.shape[1]
        buf_len = block + H
        if n_in >= buf_len:
            window = audio[:, n_in - buf_len:]
        else:
            window = np.concatenate(
                [np.zeros((cfg.channels, buf_len - n_in), f32), audio], 1)
        hist = torch.cat([st.in_hist[:, -1:],
                          torch.as_tensor(window, device=self.device)], 1)
        live = bool(_energy(audio) >= f32(NOISE_FLOOR))
        rate = f32(playback_rate)
        stf = f32(f32(1) / rate) if rate * f32(H) > 1 else f32(H)
        self.state = st._replace(
            in_hist=hist, did_seek=True, seek_time_factor=stf,
            silence_counter=0 if live else st.silence_counter,
            silence_first=True if live else st.silence_first)

    def seek_length(self) -> int:
        return self.cfg.seek_length

    # ---- outputSeek (:172-207) --------------------------------------------
    def output_seek(self, audio_in):
        audio = self._input(audio_in)
        input_length = audio.shape[1]
        self.reset()
        out_lat = self.cfg.output_latency
        surplus = max(int(input_length) - self.cfg.input_latency, 0)
        playback_rate = f32(f32(surplus) / f32(out_lat))
        seek_samples = input_length - surplus
        self.seek(audio[:, :seek_samples], playback_rate)
        preroll = self.process(audio[:, seek_samples:], out_lat)
        # negate and reverse the pre-roll into the output tail (:198-203)
        pre = torch.as_tensor(np.ascontiguousarray(preroll[:, ::-1]),
                              device=self.device)
        tail = self.state.out_tail.clone()
        tail[:, :out_lat] += -pre
        self.state = self.state._replace(out_tail=tail)

    def output_seek_length(self, playback_rate: float) -> int:
        return self.cfg.output_seek_length(playback_rate)

    # ---- flush (:426-464) --------------------------------------------------
    def flush(self, n_out: int, playback_rate: float = 0.0) -> np.ndarray:
        H, ch = self.cfg.interval_samples, self.cfg.channels
        n_out = int(n_out)
        out_block = max(0, n_out - H)
        parts = []
        if out_block > 0:
            zeros_in = int(f32(f32(out_block) * f32(playback_rate)))
            parts.append(self.process(np.zeros((ch, zeros_in), f32),
                                      out_block))
        tail = n_out - out_block
        st = self.state
        w = torch.clamp(st.weight_tail, min=0.1)
        a = st.out_tail[:, :tail] / w[:tail]
        b = st.out_tail[:, tail:2 * tail] / w[tail:2 * tail]
        parts.append((a - b.flip(1)).cpu().numpy())
        # the full reset of rings and phase state (:456-463), keeping
        # Band.input
        carry = st.carry
        self.state = st._replace(
            out_tail=torch.zeros_like(st.out_tail),
            weight_tail=torch.zeros_like(st.weight_tail),
            in_hist=torch.zeros_like(st.in_hist),
            carry=carry._replace(prev_input=torch.zeros_like(carry.input),
                                 output=torch.zeros_like(carry.output)))
        return np.concatenate(parts, axis=1)

    # ---- not ported yet ---------------------------------------------------
    def process_many(self, histories, rates, n_out: int):
        raise NotImplementedError(_NOT_PORTED.format("process_many"))

    def process_many_live(self, inputs, n_out: int):
        raise NotImplementedError(_NOT_PORTED.format("process_many_live"))

    # ---- state checkpointing ----------------------------------------------
    def state_dict(self) -> dict:
        """The state as numpy arrays, in the layout of the JAX package's
        state_dict (convert.stream_state_to_arrays)."""
        from . import convert
        return convert.stream_state_to_arrays(self.state)

    def load_state_dict(self, d: dict):
        """Continue from a state_dict of either package."""
        from . import convert
        self.state = convert.stream_state_from_arrays(d, self.device)
