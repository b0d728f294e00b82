"""The spectral processor's per-(block, bin) parts in plain PyTorch and
NumPy: constants, the built-in frequency map, the slew smoothing, peaks and
the output map, the fractional-bin lookups, and one streaming block.

A frozen copy of the plain versions in signalsmith_stretch_torch
(spectral.py, ops/scan_ops.py, ops/peaks.py, ops/interp.py,
ops/block_sweep.py) for the benchmark's configurations: the built-in map
with its tonality limit or no map, no formants, stretches up to 2x.  All
arithmetic is float32, as the reference's `Sample=float`
(signalsmith-stretch.h:633-917).  It imports nothing of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import MAX_CLEAN_STRETCH, NOISE_FLOOR, StretchConfig

f32 = np.float32
SMOOTHING = (True, False, True, False)   # down, up, down, up (:816-848)


def identity(x):
    return x


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x stored in bfloat16 and read back: the control's precision."""
    if x.is_complex():
        return torch.complex(round_bf16(x.real), round_bf16(x.imag))
    if x.dtype != torch.float32:
        return x
    return x.to(torch.bfloat16).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class SpectralConsts:
    bands: int
    channels: int
    fft_samples: int
    interval: int
    long_vertical_step: int
    slew: float
    rotor: np.ndarray             # [bands] complex64

    @classmethod
    def for_config(cls, cfg: StretchConfig) -> "SpectralConsts":
        B, N, H = cfg.bands, cfg.fft_samples, cfg.interval_samples
        band_freq = ((np.arange(B, dtype=f32) + f32(0.5)) / f32(N)).astype(f32)
        # the incremental rotor as the reference builds it (:647-655)
        angle0 = f32(f32(band_freq[0]) * f32(H) * f32(2 * math.pi))
        freq_step = f32(band_freq[1] - band_freq[0])
        angle_step = f32(f32(freq_step) * f32(H) * f32(2 * math.pi))
        rot = np.complex64(complex(f32(np.cos(np.float64(angle0))),
                                   f32(np.sin(np.float64(angle0)))))
        rot_step = np.complex64(complex(f32(np.cos(np.float64(angle_step))),
                                        f32(np.sin(np.float64(angle_step)))))
        rotor = np.empty(B, np.complex64)
        for b in range(B):
            rotor[b] = rot
            re = f32(f32(rot.real * rot_step.real)
                     - f32(rot.imag * rot_step.imag))
            im = f32(f32(rot.real * rot_step.imag)
                     + f32(rot.imag * rot_step.real))
            rot = np.complex64(complex(re, im))
        smoothing_bins = float(f32(N) / f32(H))
        slew = float(f32(1) / f32(f32(1) + f32(smoothing_bins) * f32(0.5)))
        return cls(bands=B, channels=cfg.channels, fft_samples=N, interval=H,
                   long_vertical_step=cfg.long_vertical_step, slew=slew,
                   rotor=rotor)


class Controls(NamedTuple):
    """The frequency map's values, float32 scalars."""
    freq_multiplier: np.float32
    freq_tonality_limit: np.float32

    @classmethod
    def of(cls, sample_rate: float, semitones: float, tonality_hz: float):
        """setTransposeSemitones with its tonality limit (:107-122), as the
        port's builders compute it."""
        mult = f32(2.0 ** (f32(semitones) / f32(12)))
        limit = (f32(f32(tonality_hz / sample_rate) / f32(math.sqrt(mult)))
                 if tonality_hz > 0 else f32(1))
        return cls(mult, limit)

    @property
    def mapped(self) -> bool:
        return float(self.freq_multiplier) != 1.0


def map_freq(freq: torch.Tensor, controls: Controls) -> torch.Tensor:
    """The multiplier with its tonality limit (:850-856)."""
    limit = f32(controls.freq_tonality_limit)
    mult = f32(controls.freq_multiplier)
    above_off = f32((mult - f32(1)) * limit)
    return torch.where(freq > float(limit), freq + float(above_off),
                       freq * float(mult))


# ---------------------------------------------------------------------------
# the slew smoothing (:816-848): passes of a one-pole filter over bins
# ---------------------------------------------------------------------------
def iir_chain(x: torch.Tensor, slew: float, directions):
    """The passes in order, each over the previous pass's output from its
    last value (0 before the first)."""
    y = x
    v = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    B = x.shape[-1]
    for backward in directions:
        out = torch.empty_like(y)
        for b in (range(B - 1, -1, -1) if backward else range(B)):
            v = v + (y[..., b] - v) * slew
            out[..., b] = v
        y = out
    return y


# ---------------------------------------------------------------------------
# peaks and the output map (:859-917), batched over rows
# ---------------------------------------------------------------------------
def _segment_sums(index: torch.Tensor, values: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Sum values into n slots, each slot's values added in index order
    (bin-ascending, the reference's `+=`): serial index_put_ on a CPU
    copy."""
    dev = values.device
    index, values = index.cpu(), values.cpu()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = torch.zeros(n, dtype=values.dtype)
        out.index_put_((index,), values, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was)
    return out.to(dev)


def peaks_and_map(energy: torch.Tensor, smoothed: torch.Tensor,
                  controls: Controls, consts: SpectralConsts):
    """energy, smoothed [R, B] f32 -> (input_bin, freq_grad) [R, B]."""
    R, B = energy.shape
    dev = energy.device
    N = float(consts.fft_samples)
    nseg = B // 2 + 2
    above = energy > smoothed
    start = above & ~F.pad(above[:, :-1], (1, 0), value=False)
    run_id = torch.cumsum(start.to(torch.int64), 1) - 1
    seg = torch.where(above, run_id, nseg - 1)
    b_idx = torch.arange(B, dtype=torch.float32, device=dev)
    flat = (torch.arange(R, device=dev)[:, None] * nseg + seg).reshape(-1)
    band_sum = _segment_sums(flat, (b_idx * energy).reshape(-1),
                             R * nseg).reshape(R, nseg)
    energy_sum = _segment_sums(flat, energy.reshape(-1),
                               R * nseg).reshape(R, nseg)
    n_peaks = start.sum(1)
    valid = torch.arange(nseg, device=dev)[None, :] < n_peaks[:, None]
    avg_band = band_sum / torch.where(energy_sum == 0,
                                      torch.ones_like(energy_sum), energy_sum)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    peak_in = torch.where(valid, avg_band, zero)
    avg_freq = torch.where(valid, (avg_band + 0.5) / N, zero)
    mapped = map_freq(avg_freq, controls)

    # the output map (updateOutputMap)
    peak_out_raw = mapped * N - 0.5
    peak_out = torch.where(valid, peak_out_raw,
                           torch.full_like(peak_out_raw, math.inf))
    cells = torch.where(valid, torch.ceil(peak_out).clamp(0, B).to(torch.int64),
                        torch.full((R, nseg), B, device=dev))
    hist = torch.zeros(R, B + 1, dtype=torch.int64, device=dev)
    hist.scatter_add_(1, cells, torch.ones_like(cells))
    k = torch.cumsum(hist[:, :B], 1)
    last = (n_peaks - 1).clamp(min=0)[:, None]
    first_in, first_out = peak_in[:, :1], peak_out[:, :1]
    last_in = torch.gather(peak_in, 1, last)
    last_out = torch.where(torch.gather(valid, 1, last),
                           torch.gather(peak_out, 1, last),
                           torch.zeros_like(last_in))
    prev_i = (k - 1).clamp(0, nseg - 1)
    next_i = k.clamp(0, nseg - 1)
    prev_o = torch.gather(peak_out, 1, prev_i)
    prev_in = torch.gather(peak_in, 1, prev_i)
    next_o = torch.gather(peak_out, 1, next_i)
    next_in = torch.gather(peak_in, 1, next_i)
    range_scale = 1 / (next_o - prev_o)
    out_offset = prev_in - prev_o
    out_scale = next_in - next_o - prev_in + prev_o
    grad_scale = out_scale * range_scale
    r = (b_idx - prev_o) * range_scale
    h = r * r * (3 - 2 * r)
    pair_bin = b_idx + out_offset + h * out_scale
    pair_grad = 1 + (6 * r * (1 - r)) * grad_scale
    top_start = last_out.to(torch.int32).clamp(min=0)
    is_top = torch.arange(B, device=dev)[None, :] >= top_start
    is_bottom = (k == 0) & ~is_top
    one = torch.ones((), dtype=torch.float32, device=dev)
    input_bin = torch.where(is_top, b_idx + (last_in - last_out),
                            torch.where(is_bottom,
                                        b_idx + (first_in - first_out),
                                        pair_bin))
    freq_grad = torch.where(is_top | is_bottom, one, pair_grad)
    no_peaks = (n_peaks == 0)[:, None]
    input_bin = torch.where(no_peaks, b_idx.expand(R, B), input_bin)
    freq_grad = torch.where(no_peaks, one, freq_grad)
    return input_bin, freq_grad


# ---------------------------------------------------------------------------
# fractional-bin lookups
# ---------------------------------------------------------------------------
def interp(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """rows [..., W0] (real or complex), pos [..., B] -> the lerp at pos,
    zero outside [0, W0); lo, hi - lo, * frac and + round one by one."""
    if rows.is_complex():
        return torch.complex(interp(rows.real, pos), interp(rows.imag, pos))
    W0 = rows.shape[-1]
    pos = pos.expand(rows.shape[:-1] + pos.shape[-1:])
    low = torch.floor(pos)
    frac = pos - low
    vlo = (low >= 0) & (low < W0)
    vhi = (low >= -1) & (low < W0 - 1)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    li = torch.where(vlo, low, 0).to(torch.int64)
    hi_i = torch.where(vhi, low + 1, 0).to(torch.int64)
    lo = torch.where(vlo, torch.gather(rows, -1, li), zero)
    hi = torch.where(vhi, torch.gather(rows, -1, hi_i), zero)
    return lo + (hi - lo) * frac


def interp_shift(rows: torch.Tensor, shift: np.ndarray) -> torch.Tensor:
    """rows [..., nB, B] at positions float32(b) - shift[k] (shift >= 0.5,
    one a block row), as a lerp of two taps chosen on the host."""
    B = rows.shape[-1]
    shift = np.asarray(shift, f32)
    b = np.arange(B, dtype=f32)
    p = (b[None, :] - shift[:, None]).astype(f32)
    li = np.floor(p)
    frac = torch.as_tensor((p - li).astype(f32), device=rows.device)
    s_lo = np.arange(B, dtype=np.int64)[None, :] - li.astype(np.int64)
    if (s_lo < 1).any():
        raise ValueError("interp_shift expects shifts >= 0.5")

    def view(s):
        return F.pad(rows[..., :max(B - s, 0)], (min(s, B), 0))

    svals = [int(s) for s in np.unique(s_lo)]
    v_lo, v_hi = view(svals[0]), view(svals[0] - 1)
    for s in svals[1:]:
        m = torch.as_tensor(s_lo == s, device=rows.device)
        v_lo = torch.where(m, view(s), v_lo)
        v_hi = torch.where(m, view(s - 1), v_hi)
    return v_lo + (v_hi - v_lo) * frac


def cdivr(a, den):
    """complex / real, component-wise."""
    return torch.complex(a.real / den, a.imag / den)


def sel(mc, items):
    """items[mc] elementwise (mc an int tensor of channel indices)."""
    out = torch.zeros_like(items[0])
    for c, it in enumerate(items):
        out = torch.where(mc == c, it, out)
    return out


def shift_up(x, n):
    """x[..., b] -> x[..., b+n] (zeros beyond the end)."""
    return F.pad(x[..., n:], (0, n))


def where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


# ---------------------------------------------------------------------------
# one streaming block's bin sweep (:722-803): NumPy on the host
# ---------------------------------------------------------------------------
def _fma(a, b, c):
    """a * b + c on float32 arrays, rounded once (float64 product, the sum
    rounded to odd, then to float32)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = s.view(np.int64) & 1
    s = np.where((err != 0) & (odd == 0),
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _fma1(a, b, c) -> np.float32:
    """_fma on float32 scalars."""
    p, c = float(a) * float(b), float(c)
    s = p + c
    r = f32(s)
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    if err != 0.0 and float(r) != s:
        nb = np.nextafter(r, f32(np.inf) if s > float(r) else f32(-np.inf))
        if (float(r) + float(nb)) * 0.5 == s and (err > 0) == (nb > r):
            r = nb
    return r


def _cmul(xr, xi, yr, yi):
    return _fma(xr, yr, -(xi * yi)), _fma(xi, yr, xr * yi)


def _cmul1(xr, xi, yr, yi):
    return _fma1(xr, yr, -(xi * yi)), _fma1(xi, yr, xr * yi)


def _make_output(pe, fr, fi, phr, phi):
    pn = _fma(phr, phr, phi * phi)
    weak = pn <= f32(NOISE_FLOOR)
    fn = _fma(fr, fr, fi * fi)
    p2r = np.where(weak, fr, phr)
    p2i = np.where(weak, fi, phi)
    pn2 = np.where(weak, fn + f32(NOISE_FLOOR), pn)
    s = np.sqrt((pe / pn2).astype(np.float64)).astype(np.float32)
    return _cmul(p2r, p2i, s, np.zeros_like(s))


def _make_output1(pe, fr, fi, phr, phi):
    pn = _fma1(phr, phr, phi * phi)
    fn = _fma1(fr, fr, fi * fi)
    if pn <= f32(NOISE_FLOOR):
        phr, phi, pn = fr, fi, fn + f32(NOISE_FLOOR)
    s = f32(math.sqrt(float(pe / pn)))
    return _cmul1(phr, phi, s, f32(0))


def _planes(z: torch.Tensor):
    z = z.detach().cpu().numpy()
    return (np.ascontiguousarray(z.real, np.float32),
            np.ascontiguousarray(z.imag, np.float32))


def block_sweep(st, lt, pu, pe_max, pi_max, max_ch, ct, pe, pi,
                longv: int) -> torch.Tensor:
    """A loop over bins carrying the loudest channel's outputs; every other
    channel locked to it after (makeOutput).  [B] / [ch, B] inputs ->
    [ch, B] complex64 on pe's device."""
    ch, B = pe.shape
    str_, sti = _planes(st)
    ltr, lti = _planes(lt)
    pur, pui = _planes(pu)
    pmr, pmi = _planes(pi_max)
    ctr, cti = _planes(ct)
    pir, pii = _planes(pi)
    pem = pe_max.detach().cpu().numpy().astype(np.float32)
    pen = pe.detach().cpu().numpy().astype(np.float32)
    mc = max_ch.detach().cpu().numpy().astype(np.int64)
    main_r = np.zeros(B, np.float32)
    main_i = np.zeros(B, np.float32)
    zero = f32(0)

    def out(c, k):
        if mc[k] == c:
            return main_r[k], main_i[k]
        tr, ti = _cmul1(main_r[k], main_i[k], ctr[c, k], cti[c, k])
        return _make_output1(pen[c, k], pir[c, k], pii[c, k], tr, ti)

    with np.errstate(all="ignore"):
        for b in range(B):
            m = mc[b]
            v1r = v1i = v2r = v2i = zero
            if b > 0:
                dr, di = out(m, b - 1)
                v1r, v1i = _cmul1(dr, di, str_[b], sti[b])
            if b >= longv:
                dr, di = out(m, b - longv)
                v2r, v2i = _cmul1(dr, di, ltr[b], lti[b])
            phr = (pur[b] + v1r) + v2r
            phi = (pui[b] + v1i) + v2i
            main_r[b], main_i[b] = _make_output1(pem[b], pmr[b], pmi[b], phr,
                                                 phi)
        tr, ti = _cmul(main_r[None], main_i[None], ctr, cti)
        kr, ki = _make_output(pen, pir, pii, tr, ti)
    lead = np.arange(ch)[:, None] == mc[None]
    out_r = np.where(lead, main_r[None], kr)
    out_i = np.where(lead, main_i[None], ki)
    return torch.complex(torch.from_numpy(out_r),
                         torch.from_numpy(out_i)).to(pe.device)


class Carry(NamedTuple):
    """What a stream carries from block to block (Band.input, prevInput,
    output, Prediction.energy)."""
    input: torch.Tensor        # [ch, B] complex64
    prev_input: torch.Tensor   # [ch, B] complex64
    output: torch.Tensor       # [ch, B] complex64
    pred_energy: torch.Tensor  # [ch, B] float32


def process_block(carry: Carry, spectrum, prev_spectrum, new: bool,
                  reanalyse: bool, time_factor, controls: Controls,
                  consts: SpectralConsts, q=identity):
    """One spectral block (:633-813) -> (carry', output [ch, B]).  q rounds
    the block's inputs and outputs to the precision it is computed in."""
    ch, B = consts.channels, consts.bands
    longv = consts.long_vertical_step
    dev = carry.output.device
    rotor = torch.as_tensor(consts.rotor, device=dev)
    b_i = torch.arange(B, device=dev)
    b_f = b_i.to(torch.float32)
    inp = q(spectrum) if new else carry.input
    prev_in = q(prev_spectrum) if reanalyse else carry.prev_input
    output = carry.output
    if new:
        output = output * rotor
        prev_in = prev_in * rotor
    in_energy = inp.real * inp.real + inp.imag * inp.imag      # [ch, B]

    tf = max(f32(time_factor), f32(1 / MAX_CLEAN_STRETCH))
    if tf > f32(MAX_CLEAN_STRETCH):
        raise ValueError("the reference covers stretches up to 2x")
    ltf = f32(f32(longv) * tf)
    mapped = controls.mapped
    if mapped:
        energy = in_energy[0]
        for c in range(1, ch):
            energy = energy + in_energy[c]
        energy = energy[None]
        sm = iir_chain(energy, consts.slew, SMOOTHING)
        input_bin, freq_grad = peaks_and_map(energy, sm, controls, consts)
        input_bin, freq_grad = input_bin[0], freq_grad[0]
        vote_pos = [input_bin - float(tf), input_bin - float(ltf)]
        pred_input = interp(inp, input_bin)
        prev_interp = interp(prev_in, input_bin)
        pred_energy = interp(in_energy, input_bin) * torch.clamp(freq_grad,
                                                                 min=0)
    else:
        vote_pos = [b_f - float(tf), b_f - float(ltf)]
        pred_energy, pred_input, prev_interp = in_energy, inp, prev_in
    votes = [interp(inp, p) for p in vote_pos]                 # [ch, B] each
    phase = output * (pred_input * torch.conj(prev_interp))
    out_prelim = cdivr(phase, torch.maximum(carry.pred_energy, pred_energy)
                       + NOISE_FLOOR)

    mc = torch.argmax(pred_energy, 0)

    def pick(rows):
        return torch.gather(rows, 0, mc[None])[0]

    up1 = (b_i + 1).clamp(max=B - 1)
    upl = (b_i + longv).clamp(max=B - 1)
    pe_max, pi_max = pick(pred_energy), pick(pred_input)
    short_down, long_down = pick(votes[0]), pick(votes[1])
    up_short = pick(torch.roll(votes[0], -1, 1))
    up_long = pick(torch.roll(votes[1], -longv, 1))
    short_twist = pi_max * torch.conj(short_down)
    long_twist = pi_max * torch.conj(long_down)
    up_twist = pick(pred_input[:, up1]) * torch.conj(up_short)
    up_long_twist = pick(pred_input[:, upl]) * torch.conj(up_long)
    czero = torch.zeros((), dtype=torch.complex64, device=dev)
    phase_up = (torch.where(b_i < B - 1,
                            pick(out_prelim[:, up1]) * torch.conj(up_twist),
                            czero)
                + torch.where(b_i < B - longv,
                              pick(out_prelim[:, upl])
                              * torch.conj(up_long_twist), czero))
    ch_twist = pred_input * torch.conj(pi_max)[None]
    args = [q(v) for v in (short_twist, long_twist, phase_up, pe_max, pi_max)]
    outputs = q(block_sweep(*args, mc, q(ch_twist), q(pred_energy),
                            q(pred_input), longv))
    carry2 = Carry(input=inp, prev_input=inp if new else prev_in,
                   output=outputs, pred_energy=pred_energy)
    return carry2, outputs
