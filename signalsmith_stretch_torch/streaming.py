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

from . import ops, spectral, stft
from .config import NOISE_FLOOR, StretchConfig, device_for
from .ops import dft
from .tables import on_device
from .utils.profiling import span

f32 = np.float32
_BIG = 1 << 30


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


_WINDOW = 32         # XLA's CPU tree reduction window


def _fma_squares(a: np.ndarray) -> np.float32:
    """acc = fma(v, v, acc) over a's values in order, from 0, each step
    rounded once: the product is exact in float64, the sum rounded to odd
    (prng.fma_f32's method) and then to float32."""
    acc = 0.0
    for v in a.ravel().tolist():
        p = v * v
        s = p + acc
        bp = s - acc
        err = (p - bp) + (acc - (s - bp))
        if err != 0 and not np.float64(s).view(np.int64) & 1:
            s = float(np.nextafter(s, np.inf if err > 0 else -np.inf))
        acc = float(f32(s))
    return f32(acc)


def _energy(audio: np.ndarray) -> np.float32:
    """The silence test's total energy (:231-238), float32, summed on the
    host in the order JAX's compiled `jnp.sum(audio * audio)` sums it on
    the CPU, so that an input within a few ulps of the noise floor (1e-15)
    falls on JAX's side of it (tests/test_torch_streaming.py, test_silence_
    decisions_at_floor_match_jax).  XLA's tree reduction rewriter splits a
    reduction with a dimension over 32 into windows: each dimension over 32
    padded to a multiple of 32 (half the padding before), windows of 32
    along it and of the whole of each shorter dimension, each window summed
    from 0 in row-major order (but for one column of padding, at the end,
    the last column after the rest), the window sums reduced the same way
    until no dimension is over 32, then summed in order.  Without a
    dimension over 32
    the squares are fused into the sum: a chain of fused multiply-adds.
    Matched bit for bit up to 32 channels, at any length; with more, XLA
    sums some 32 x 32 windows in another order."""
    a = np.asarray(audio, f32)
    if max(a.shape) <= _WINDOW:
        return _fma_squares(a)
    x = a * a
    while max(x.shape) > _WINDOW:
        pads = []
        for n in x.shape:
            p = 0 if n <= _WINDOW else -(-n // _WINDOW) * _WINDOW - n
            pads.append((p // 2, p - p // 2))
        x = np.pad(x, pads)
        r, c = x.shape
        w0, w1 = min(r, _WINDOW), min(c, _WINDOW)
        w = x.reshape(r // w0, w0, c // w1, w1).transpose(0, 2, 1, 3)
        if pads[1] == (0, 1):
            # one column of padding, at the end: the compiled loop adds
            # each window's last column after the rows' first 31
            w = np.concatenate([w[..., :-1].reshape(r // w0, c // w1, -1),
                                w[..., -1]], -1)
        # a float32 cumulative sum adds in order, one rounding a step
        x = np.cumsum(w.reshape(r // w0, c // w1, w0 * w1), -1,
                      dtype=f32)[..., -1]
    return np.cumsum(x.ravel(), dtype=f32)[-1]


class StreamingStretch:
    """Streaming facade bound to one configuration and control setting (JAX
    streaming.StreamingStretch).  `device`: "cuda" (the kernels) or "cpu";
    plain=True runs the plain versions of the kernels on the device
    (ops.plain())."""

    def __init__(self, cfg: StretchConfig, controls: spectral.Controls,
                 flags: spectral.SpectralFlags, seed: int = 0,
                 device="cuda", plain: bool = False):
        self.cfg = cfg
        self.controls = controls
        self.flags = flags
        self.device = device_for(device, "StreamingStretch")
        self.plain = plain
        self.basis = stft.StftBasis.for_config(cfg)
        self.consts = spectral.SpectralConsts.for_config(cfg)
        self.state = initial_state(cfg, self.consts, seed, self.device)
        # the tables every block reads, made here: a copy inside the block
        # loop would wait for the card
        on_device(self.consts.rotor, self.device)
        dft.consts(self.basis, self.device)
        on_device(self.basis.twist, self.device, stft.twist_planes)
        w = on_device(self.basis.window, self.device)
        self._w2 = w * w
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
        x = torch.as_tensor(audio, device=self.device)
        out = self._process(audio, x, int(n_out))
        with span("sst.stream.output"):      # the host waits for the card
            return out.cpu().numpy()

    def _process(self, audio: np.ndarray, x: torch.Tensor,
                 n_out: int) -> torch.Tensor:
        """One process() call on the host copy of its input (for the
        silence test) and the device copy (for the timeline); the output
        [ch, n_out] stays on the device."""
        with span("sst.stream.process"):
            cfg, st = self.cfg, self.state
            ch, block, H = (cfg.channels, cfg.block_samples,
                            cfg.interval_samples)
            n_in = audio.shape[1]
            hist_base = block + H + 1
            timeline = torch.cat([st.in_hist, x], 1)
            new_hist = timeline[:, timeline.shape[1] - hist_base:]
            is_silent = bool(_energy(audio) < f32(NOISE_FLOOR))

            out = None           # the bypass's, else the normal path's
            if is_silent:
                if st.silence_counter >= 2 * block:
                    # the silence bypass (:240-278): the input passes through
                    with span("sst.stream.bypass"):
                        carry, ssl = st.carry, st.samples_since_last
                        if st.silence_first:   # the first silent block clears
                            z = torch.zeros_like(carry.input)
                            carry = carry._replace(input=z, prev_input=z,
                                                   output=z)
                            ssl = _BIG
                        if n_in > 0:
                            idx = torch.arange(n_out, device=self.device)
                            out = x[:, idx % n_in]
                        else:
                            out = x.new_zeros((ch, n_out))
                        st = st._replace(carry=carry, samples_since_last=ssl,
                                         silence_first=False)
                else:
                    st = st._replace(
                        silence_counter=st.silence_counter + n_in)
            if out is None:
                with ops.plain(self.plain):
                    st, out = self._normal(st, timeline, n_in, n_out,
                                           is_silent)
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
            with span("sst.stream.block"):
                o_k = o0 + k * H
                # the reference's float32 block arithmetic (:281-325)
                pos_f = f32(f32(o_k) * f32(n_in)) / f32(max(n_out, 1))
                input_offset = int(np.floor(f32(pos_f + f32(0.5))))
                interval = input_offset - prev_offset
                new_spectrum = did_seek or interval > 0
                reanalyse = new_spectrum and (did_seek
                                              or abs(interval - H) > 1)
                time_factor = (st.seek_time_factor if did_seek else
                               f32(f32(H) / max(f32(1), f32(interval))))
                head = hist_base + input_offset
                with span("sst.stream.block.analysis"):
                    # the block's frame and the one an interval before,
                    # analysed in one call (kernel D)
                    frames = torch.cat([
                        timeline[:, head - block:head],
                        timeline[:, head - H - block:head - H]])
                    specs = dft.analyze(frames, self.basis)
                    xs = spectral.BlockInputs(specs[:ch], specs[ch:],
                                              new_spectrum, reanalyse,
                                              time_factor)
                with span("sst.stream.block.spectral"):
                    carry, out_spec = spectral.process_block(
                        carry, xs, self.controls, self.flags, self.consts)
                self.blocks += 1
                with span("sst.stream.block.synthesis"):
                    pos = o_k + split_shift
                    buf[:, pos:pos + block] += stft.synthesize(out_spec,
                                                               self.basis)
                    wbuf[pos:pos + block] += self._w2
                prev_offset, did_seek = input_offset, False

        ssl = (n_out - (o0 + (n_blocks - 1) * H) if n_blocks > 0
               else min(ssl0 + n_out, _BIG))
        with span("sst.stream.output"):
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
        self._seek(self._input(audio_in), None, playback_rate)

    def _seek(self, audio: np.ndarray, x, playback_rate):
        """seek() on the host copy of its input (the energy) and the device
        copy (the history), made here where x is None."""
        with span("sst.stream.seek"):
            if x is None:
                x = torch.as_tensor(audio, device=self.device)
            cfg, st = self.cfg, self.state
            block, H = cfg.block_samples, cfg.interval_samples
            n_in = audio.shape[1]
            buf_len = block + H
            if n_in >= buf_len:
                window = x[:, n_in - buf_len:]
            else:
                window = torch.cat([
                    x.new_zeros((cfg.channels, buf_len - n_in)), x], 1)
            hist = torch.cat([st.in_hist[:, -1:], window], 1)
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

    # ---- batched quanta ----------------------------------------------------
    def _many(self, arrays, what: str) -> tuple:
        a = np.asarray(arrays, f32)
        if a.ndim != 3 or a.shape[1] != self.cfg.channels:
            raise ValueError(f"{what} must be [M, channels, samples]")
        return a, torch.as_tensor(a, device=self.device)

    def _stack_out(self, outs, m: int, n_out: int) -> np.ndarray:
        if not outs:
            return np.zeros((m, self.cfg.channels, n_out), f32)
        return torch.stack(outs).cpu().numpy()

    def process_many(self, histories, rates, n_out: int) -> np.ndarray:
        """M quanta of the worklet's constant re-seek loop
        (web-wrapper.js:267-322): the same as M calls of (seek(histories[i],
        rates[i]); process(zeros [ch, 0], n_out)), bit for bit.

        histories [M, ch, hist_len], rates [M] (or one rate) -> [M, ch,
        n_out].  The histories go to the device in one copy and the outputs
        come back in one; the quanta run in a host loop that never waits
        for the card (the silence test reads the host copy)."""
        hists, dev = self._many(histories, "histories")
        m, n_out = hists.shape[0], int(n_out)
        rates = np.broadcast_to(np.asarray(rates, f32), (m,))
        empty = np.zeros((self.cfg.channels, 0), f32)
        none = dev.new_zeros((self.cfg.channels, 0))
        outs = []
        for i in range(m):
            self._seek(hists[i], dev[i], rates[i])
            outs.append(self._process(empty, none, n_out))
        return self._stack_out(outs, m, n_out)

    def process_many_live(self, inputs, n_out: int) -> np.ndarray:
        """M live-input quanta (web-wrapper.js:255-266): the same as M calls
        of process(inputs[i], n_out), bit for bit; inputs [M, ch, n] ->
        [M, ch, n_out], one copy in and one out."""
        xs, dev = self._many(inputs, "inputs")
        m, n_out = xs.shape[0], int(n_out)
        outs = [self._process(xs[i], dev[i], n_out) for i in range(m)]
        return self._stack_out(outs, m, n_out)

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
