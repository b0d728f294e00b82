"""The streaming engine in plain PyTorch and NumPy: seek() and process()
over a carried state (signalsmith-stretch.h:139-419).

A frozen copy of the plain path of signalsmith_stretch_torch/streaming.py
for the benchmark's configurations; functions over an immutable state, so
that a caller can step it from any state it is given.  The silence test
sums the energy in float64 (the port sums in XLA's float32 order, which
differs only within a few ulps of the 1e-15 floor).  It imports nothing of
the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import spectral, stft
from .geometry import NOISE_FLOOR, StretchConfig

f32 = np.float32
BIG = 1 << 30


class StreamState(NamedTuple):
    carry: spectral.Carry
    in_hist: torch.Tensor       # [ch, block+H+1] input history
    out_tail: torch.Tensor      # [ch, block+2H] WOLA signal tail
    weight_tail: torch.Tensor   # [block+2H] WOLA weight tail
    samples_since_last: int
    prev_input_offset: int
    did_seek: bool
    seek_time_factor: np.float32
    silence_counter: int
    silence_first: bool


def initial_state(cfg: StretchConfig, device="cpu") -> StreamState:
    ch, block, H = cfg.channels, cfg.block_samples, cfg.interval_samples
    shape = (ch, cfg.bands)
    z = torch.zeros(shape, dtype=torch.complex64, device=device)
    zf = torch.zeros(shape, dtype=torch.float32, device=device)

    def zeros(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    return StreamState(spectral.Carry(z, z, z, zf),
                       zeros(ch, block + H + 1), zeros(ch, block + 2 * H),
                       zeros(block + 2 * H), BIG, -1, False, f32(1), 0, True)


def _silent(audio: np.ndarray) -> bool:
    a = np.asarray(audio, np.float64)
    return bool(float((a * a).sum()) < NOISE_FLOOR)


def seek(st: StreamState, cfg: StretchConfig, audio: np.ndarray,
         playback_rate: float) -> StreamState:
    """Prime the input history, latch the seek time factor (:139-165)."""
    block, H = cfg.block_samples, cfg.interval_samples
    x = torch.as_tensor(np.asarray(audio, f32), device=st.in_hist.device)
    n_in = x.shape[1]
    buf_len = block + H
    if n_in >= buf_len:
        window = x[:, n_in - buf_len:]
    else:
        window = torch.cat([x.new_zeros((cfg.channels, buf_len - n_in)), x],
                           1)
    hist = torch.cat([st.in_hist[:, -1:], window], 1)
    live = not _silent(audio)
    rate = f32(playback_rate)
    stf = f32(f32(1) / rate) if rate * f32(H) > 1 else f32(H)
    return st._replace(
        in_hist=hist, did_seek=True, seek_time_factor=stf,
        silence_counter=0 if live else st.silence_counter,
        silence_first=True if live else st.silence_first)


def process(st: StreamState, cfg: StretchConfig, audio: np.ndarray,
            n_out: int, controls: spectral.Controls,
            consts: spectral.SpectralConsts, q=spectral.identity):
    """One process() call (:209-419) -> (state', output [ch, n_out])."""
    ch, block, H = cfg.channels, cfg.block_samples, cfg.interval_samples
    dev = st.in_hist.device
    audio = np.asarray(audio, f32)
    x = torch.as_tensor(audio, device=dev)
    n_in = audio.shape[1]
    hist_base = block + H + 1
    timeline = torch.cat([st.in_hist, x], 1)
    new_hist = timeline[:, timeline.shape[1] - hist_base:]
    is_silent = _silent(audio)
    out = None
    if is_silent:
        if st.silence_counter >= 2 * block:
            # the silence bypass (:240-278): the input passes through
            carry, ssl = st.carry, st.samples_since_last
            if st.silence_first:
                z = torch.zeros_like(carry.input)
                carry = carry._replace(input=z, prev_input=z, output=z)
                ssl = BIG
            if n_in > 0:
                out = x[:, torch.arange(n_out, device=dev) % n_in]
            else:
                out = x.new_zeros((ch, n_out))
            st = st._replace(carry=carry, samples_since_last=ssl,
                             silence_first=False)
        else:
            st = st._replace(silence_counter=st.silence_counter + n_in)
    if out is None:
        st, out = _normal(st, cfg, timeline, n_in, n_out, is_silent,
                          controls, consts, q)
    return st._replace(in_hist=new_hist), out


def _normal(st: StreamState, cfg: StretchConfig, timeline, n_in: int,
            n_out: int, is_silent: bool, controls, consts, q):
    """The normal path (:280-419): the call's blocks in order."""
    ch, block, H = cfg.channels, cfg.block_samples, cfg.interval_samples
    dev = timeline.device
    basis = stft.StftBasis.for_config(cfg)
    w2 = torch.as_tensor((basis.window * basis.window).astype(f32),
                         device=dev)
    if not is_silent:
        st = st._replace(silence_counter=0, silence_first=True)
    tail_len = block + 2 * H
    split_shift = H if cfg.split_computation else 0
    buf = torch.cat([st.out_tail, torch.zeros(
        (ch, n_out + block + H), dtype=torch.float32, device=dev)], 1)
    wbuf = torch.cat([st.weight_tail, torch.zeros(
        n_out + block + H, dtype=torch.float32, device=dev)])
    ssl0 = min(st.samples_since_last, BIG)
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
        frames = torch.cat([timeline[:, head - block:head],
                            timeline[:, head - H - block:head - H]])
        specs = stft.analyze(q(frames), basis)
        carry, out_spec = spectral.process_block(
            carry, specs[:ch], specs[ch:], new_spectrum, reanalyse,
            time_factor, controls, consts, q)
        pos = o_k + split_shift
        buf[:, pos:pos + block] += stft.synthesize(out_spec, basis)
        wbuf[pos:pos + block] += w2
        prev_offset, did_seek = input_offset, False
    ssl = (n_out - (o0 + (n_blocks - 1) * H) if n_blocks > 0
           else min(ssl0 + n_out, BIG))
    out = buf[:, :n_out] / torch.clamp(wbuf[:n_out], min=0.1)
    st = st._replace(carry=carry, out_tail=buf[:, n_out:n_out + tail_len],
                     weight_tail=wbuf[n_out:n_out + tail_len],
                     samples_since_last=ssl,
                     prev_input_offset=prev_offset - n_in, did_seek=did_seek)
    return st, q(out)
