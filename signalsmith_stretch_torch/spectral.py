"""Spectral constants, controls and the peaks / output-map stage.

The per-(block, bin) parts of processSpectrum that the planner needs
(signalsmith-stretch.h:633-917): the incremental phase rotor, the frequency
map with its tonality limit, and the peak finder + output map, batched over
block rows.  All arithmetic is float32 to track the reference's
`Sample=float` numerics.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import prng
from .config import MAX_CLEAN_STRETCH, NOISE_FLOOR, StretchConfig
from .tables import on_device

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class SpectralConsts:
    bands: int
    channels: int
    fft_samples: int
    interval: int
    long_vertical_step: int       # round(fftSamples/interval) (:637)
    smoothing_bins: float         # float32 fftSamples/interval (:636)
    slew: float                   # 1/(1 + smoothingBins*0.5) (:819)
    rotor: np.ndarray             # [bands] complex64 incremental rotor values
    band_freq: np.ndarray         # [bands] float32 binToFreq(b)

    @classmethod
    def for_config(cls, cfg: StretchConfig) -> "SpectralConsts":
        B, N, H = cfg.bands, cfg.fft_samples, cfg.interval_samples
        band_freq = ((np.arange(B, dtype=f32) + f32(0.5)) / f32(N)).astype(f32)
        # incremental rotor exactly as the reference builds it (:647-655):
        # float32 complex multiplies accumulate the same drift
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
            re = f32(f32(rot.real * rot_step.real) - f32(rot.imag * rot_step.imag))
            im = f32(f32(rot.real * rot_step.imag) + f32(rot.imag * rot_step.real))
            rot = np.complex64(complex(re, im))
        smoothing_bins = float(f32(N) / f32(H))
        slew = float(f32(1) / f32(f32(1) + f32(smoothing_bins) * f32(0.5)))
        return cls(bands=B, channels=cfg.channels, fft_samples=N, interval=H,
                   long_vertical_step=cfg.long_vertical_step,
                   smoothing_bins=smoothing_bins, slew=slew,
                   rotor=rotor, band_freq=band_freq)


@dataclasses.dataclass(frozen=True)
class SpectralFlags:
    """Static branch structure (the reference's bools)."""
    mapped: bool                  # customFreqMap || freqMultiplier != 1 (:300)
    process_formants: bool = False        # (:310)
    formant_compensation: bool = False
    formant_auto: bool = True     # formantBaseFreq <= 0 (in some block):
                                  # run the pitch estimator (:982-983)
    # the reference's RandomEngine (:34-39, 610-616): a callable (key,
    # shape, minval, maxval) -> float32 tensor of uniform draws, consumed
    # only by the randomised binTimeFactors above 2x (:747-757); key is a
    # clip's prng.key(seed).  None: JAX's seeded threefry (ops/draws:
    # kernel I on the card, prng.uniform its plain version).
    random_engine: Optional[Callable] = None
    # the reference's customFreqMap (:119-122, 850-851): an elementwise
    # callable from input to output frequency (normalised, cycles a
    # sample) on float32 tensors of the render's device, which replaces
    # the multiplier and its tonality limit.  None: the built-in map.
    custom_map: Optional[Callable] = None


class Controls(NamedTuple):
    """Control values, numpy float32 (so host arithmetic rounds to f32):
    each a scalar, or under automation an [nB] array of one value per
    block (the JAX package's per-block Controls leaves)."""
    freq_multiplier: np.float32
    freq_tonality_limit: np.float32
    formant_multiplier: np.float32 = f32(1)
    inv_formant_multiplier: np.float32 = f32(1)
    formant_base_freq: np.float32 = f32(0)

    @classmethod
    def make(cls, freq_multiplier=1.0, freq_tonality_limit=1.0):
        return cls(f32(freq_multiplier), f32(freq_tonality_limit))

    @property
    def automated(self) -> bool:
        """One value per block, not one for the render."""
        return np.ndim(self.freq_multiplier) > 0

    def tile(self, rows: int) -> "Controls":
        """Per-row values for `rows` rows block-major per clip (row r is
        block r % nB); scalar controls as they are."""
        if not self.automated:
            return self
        n = len(self.freq_multiplier)
        if rows % n:
            raise ValueError(f"{rows} rows are not clips of {n} blocks")
        return Controls(*[np.tile(np.asarray(v, f32), rows // n)
                          for v in self])

    def key(self) -> tuple:
        """A hashable key of the values (bytes and shape of each)."""
        return tuple((np.asarray(v, f32).tobytes(), np.shape(v))
                     for v in self)

    @classmethod
    def from_key(cls, key) -> "Controls":
        vals = [np.frombuffer(b, f32).reshape(shape) for b, shape in key]
        return cls(*[f32(v) if v.ndim == 0 else v.copy() for v in vals])


def _bcast(value, like: torch.Tensor):
    """A control value against `like`: a scalar as a Python float, an [n]
    array as an [n, 1] float32 tensor on like's device (a value per row)."""
    if np.ndim(value) == 0:
        return float(value)
    return torch.as_tensor(np.asarray(value, f32), device=like.device)[:, None]


# ---------------------------------------------------------------------------
# Frequency maps (signalsmith-stretch.h:850-856)
# ---------------------------------------------------------------------------
def map_freq(freq: torch.Tensor, controls: Controls) -> torch.Tensor:
    """The built-in frequency map: the multiplier with its tonality limit;
    per-row controls ([n] arrays) broadcast as [n, 1] against freq.  A
    custom map goes through custom_map_freq instead."""
    limit = np.asarray(controls.freq_tonality_limit, f32)
    mult = np.asarray(controls.freq_multiplier, f32)
    above_off = (mult - f32(1)) * limit          # float32, rounded twice
    return torch.where(freq > _bcast(limit, freq),
                       freq + _bcast(above_off, freq),
                       freq * _bcast(mult, freq))


def custom_map_freq(fn: Callable, freq: torch.Tensor) -> torch.Tensor:
    """fn(freq) for a custom frequency map, held to its contract: a
    contiguous float32 tensor of freq's shape on freq's device.  Anything
    else raises, on every device; nothing is cast or copied."""
    out = fn(freq)
    name = getattr(fn, "__qualname__", None) or repr(fn)
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"custom frequency map {name} returned "
                        f"{type(out).__name__}, not a torch.Tensor")
    if out.dtype != torch.float32:
        raise TypeError(f"custom frequency map {name} returned {out.dtype}, "
                        f"not torch.float32")
    if out.shape != freq.shape or out.device != freq.device:
        raise ValueError(f"custom frequency map {name} returned "
                         f"{tuple(out.shape)} on {out.device} for "
                         f"{tuple(freq.shape)} on {freq.device}: it must be "
                         f"elementwise")
    if not out.is_contiguous():
        raise ValueError(f"custom frequency map {name} returned a tensor "
                         f"that is not contiguous (strides {out.stride()})")
    return out


def inv_map_formant(freq: torch.Tensor, controls: Controls) -> torch.Tensor:
    """The inverse formant map (:920-925), per-row controls as map_freq."""
    limit = np.asarray(controls.freq_tonality_limit, f32)
    inv = _bcast(np.asarray(controls.inv_formant_multiplier, f32), freq)
    above_off = (f32(1) - np.asarray(controls.formant_multiplier, f32)) * limit
    return torch.where(freq * inv > _bcast(limit, freq),
                       freq + _bcast(above_off, freq), freq * inv)


def draw_uniform(flags: SpectralFlags, key, shape, minval: torch.Tensor,
                 maxval: torch.Tensor) -> torch.Tensor:
    """The randomised binTimeFactors' draws through the user's engine
    flags.random_engine (JAX spectral.draw_uniform): float32 of `shape` on
    minval's device.  Without an engine the callers take ops/draws."""
    out = flags.random_engine(key, shape, minval, maxval)
    return torch.as_tensor(out, dtype=torch.float32,
                           device=minval.device).expand(shape)


def _freq_to_band(freq, consts: SpectralConsts):
    return freq * float(consts.fft_samples) - 0.5


def _band_to_freq(band, consts: SpectralConsts):
    return (band + 0.5) / float(consts.fft_samples)


def _gather_band(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [..., W], idx int [..., B] -> values, zero outside [0, W)."""
    W = rows.shape[-1]
    valid = (idx >= 0) & (idx < W)
    v = torch.gather(rows, -1, idx.clamp(0, W - 1))
    return torch.where(valid, v, torch.zeros((), dtype=rows.dtype,
                                             device=rows.device))


def _segment_sums(index: torch.Tensor, values: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Sum values into n slots, each slot's values added in index order
    from 0 (bin-ascending, the order of the reference's `+=`): on the CPU,
    `index_put_` with accumulate under deterministic algorithms runs
    serially in that order.  The card's `index_put_` does not keep it for
    every run (on an H100, one run slot of chip_smoke.peaks_edge_rows at
    4096 bins came out otherwise than on the CPU), and the chaotic phase
    recursion turns a flipped low bit into another render, so a CUDA
    tensor's sums are taken on a CPU copy."""
    if values.device.type != "cpu":
        return _segment_sums(index.cpu(), values.cpu(), n).to(values.device)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = torch.zeros(n, dtype=values.dtype, device=values.device)
        return out.index_put_((index,), values, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was)


# ---------------------------------------------------------------------------
# Peaks + output map (signalsmith-stretch.h:859-917), batched over rows
# ---------------------------------------------------------------------------
def _peaks_and_map(energy: torch.Tensor, smoothed: torch.Tensor,
                   controls: Controls, consts: SpectralConsts):
    """energy, smoothed [R, B] f32 -> (input_bin, freq_grad) [R, B] under
    the built-in map.  Per-block controls ([nB] arrays) apply to the rows
    block-major per clip: row r takes block r % nB's.  A custom map runs
    between the same runs and output map (ops.peaks.peaks_positions_custom)."""
    peak_in, avg_freq, n_peaks = _peak_runs(energy, smoothed, consts)
    mapped = map_freq(avg_freq, controls.tile(energy.shape[0]))
    return _output_map(peak_in, mapped, n_peaks, energy.shape[1], consts)


def _peak_runs(energy: torch.Tensor, smoothed: torch.Tensor,
               consts: SpectralConsts):
    """The runs of _peaks_and_map: energy, smoothed [R, B] f32 -> (peak_in,
    avg_freq) [R, nseg] f32, nseg = B // 2 + 2, and n_peaks [R] int32.  Slot
    i < n_peaks[r] holds peak i's average band and its frequency (avg +
    0.5) / N; the later slots hold 0 in both."""
    R, B = energy.shape
    dev = energy.device
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
    return (torch.where(valid, avg_band, zero),
            torch.where(valid, _band_to_freq(avg_band, consts), zero),
            n_peaks.to(torch.int32))


def _output_map(peak_in: torch.Tensor, mapped: torch.Tensor,
                n_peaks: torch.Tensor, B: int, consts: SpectralConsts):
    """The output map of _peaks_and_map from the runs: peak_in [R, nseg],
    mapped [R, nseg] (each peak's frequency through the map; slots >=
    n_peaks[r] may hold anything, NaN too: they are masked) and n_peaks
    [R] -> (input_bin, freq_grad) [R, B] f32."""
    R, nseg = peak_in.shape
    dev = peak_in.device
    n_peaks = n_peaks.to(torch.int64)
    b_idx = torch.arange(B, dtype=torch.float32, device=dev)
    valid = torch.arange(nseg, device=dev)[None, :] < n_peaks[:, None]
    peak_out_raw = _freq_to_band(mapped, consts)
    peak_out = torch.where(valid, peak_out_raw,
                           torch.full_like(peak_out_raw, math.inf))

    # updateOutputMap: k[b] = #peaks with output <= b, as a histogram of
    # ceil(output) and its inclusive prefix sum
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

    # the top rule runs last in C++ and overwrites from trunc(last.output)
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
# Pitch estimation (signalsmith-stretch.h:927-968), batched over rows
# ---------------------------------------------------------------------------
def _top3_local_maxima(metric: torch.Tensor):
    """Plain version of the top-3 insertion scan (:931-948): a loop over
    bins 1..B-2, vectorised over rows.  metric [R, B] f32 -> (i0, v0, i1,
    v1, i2, v2), each [R] (indices int32, values f32)."""
    R, B = metric.shape
    i0 = i1 = i2 = torch.zeros(R, dtype=torch.int32, device=metric.device)
    v0 = v1 = v2 = metric[:, 0]
    for b in range(1, B - 1):
        e, ep, en = metric[:, b], metric[:, b - 1], metric[:, b + 1]
        bt = torch.full_like(i0, b)
        is_max = ~(e < ep) & ~(e <= en)
        m0 = is_max & (e > v0)
        m1 = m0 & (e > v1)
        m2 = m1 & (e > v2)
        i0, v0 = (torch.where(m1, i1, torch.where(m0, bt, i0)),
                  torch.where(m1, v1, torch.where(m0, e, v0)))
        i1, v1 = (torch.where(m2, i2, torch.where(m1, bt, i1)),
                  torch.where(m2, v2, torch.where(m1, e, v1)))
        i2, v2 = torch.where(m2, bt, i2), torch.where(m2, e, v2)
    return i0, v0, i1, v1, i2, v2


def _peak_estimate(i0, v0, i1, v1, i2, v2):
    """Harmonic-spacing heuristic (:950-959) -> (peakEstimate int32,
    weight f32).  Every operand of // and % is non-negative, so floor
    division and remainder give the C++ (truncating) values."""
    def div(a, b):
        return torch.div(a, b, rounding_mode="floor")

    pe = i2
    c1 = v1 > v2 * float(f32(0.1))
    diff = (pe - i1).abs()
    ok1 = c1 & (diff > div(pe, 8)) & (diff < div(pe * 7, 8))
    pe = torch.where(ok1, torch.remainder(pe, diff.clamp(min=1)), pe)
    c2 = c1 & (v0 > v2 * float(f32(0.01)))
    diff2 = (pe - i0).abs()
    ok2 = c2 & (diff2 > div(pe, 8)) & (diff2 < div(pe * 7, 8))
    pe = torch.where(ok2, torch.remainder(pe, diff2.clamp(min=1)), pe)
    return pe, v2


# ---------------------------------------------------------------------------
# The block step of the streaming engine (signalsmith-stretch.h:633-813)
# ---------------------------------------------------------------------------
class SpectralCarry(NamedTuple):
    """What a stream carries from block to block (JAX spectral.
    SpectralCarry): tensors on the stream's device, and the PRNG key as two
    32-bit words on the host, so that splitting it launches nothing."""
    input: torch.Tensor        # [ch, B] complex64 (Band.input)
    prev_input: torch.Tensor   # [ch, B] complex64 (Band.prevInput)
    output: torch.Tensor       # [ch, B] complex64 (Band.output)
    pred_energy: torch.Tensor  # [ch, B] float32 (Prediction.energy)
    freq_est_weighted: torch.Tensor   # [1] float32 (:927)
    freq_est_weight: torch.Tensor     # [1] float32 (:928)
    rng: tuple                 # (word0, word1), prng.key(seed) at the start

    @classmethod
    def initial(cls, consts: SpectralConsts, seed: int = 0,
                device="cpu") -> "SpectralCarry":
        shape = (consts.channels, consts.bands)
        z = torch.zeros(shape, dtype=torch.complex64, device=device)
        zf = torch.zeros(shape, dtype=torch.float32, device=device)
        s = torch.zeros(1, dtype=torch.float32, device=device)
        return cls(z, z, z, zf, s, s, prng.key(seed))


class BlockInputs(NamedTuple):
    """One block's inputs (JAX spectral.BlockInputs); the schedule's values
    are known on the host."""
    spectrum: torch.Tensor       # [ch, B] complex64 (read if new_spectrum)
    prev_spectrum: torch.Tensor  # [ch, B] complex64 (read if reanalyse)
    new_spectrum: bool
    reanalyse: bool
    time_factor: np.float32


# the smoothing's four passes: down, up, down, up (:816-848)
SMOOTHING = (True, False, True, False)


@functools.lru_cache(maxsize=8)
def _block_tables(B: int, longv: int, device: torch.device) -> dict:
    """Per-(shape, device) constants of process_block, built once."""
    b = torch.arange(B, device=device)
    return dict(
        b_f=b.to(torch.float32),
        up1=(b + 1).clamp(max=B - 1), upl=(b + longv).clamp(max=B - 1),
        has_up1=b < B - 1, has_upl=b < B - longv,
        zero=torch.zeros(1, dtype=torch.float32, device=device),
        czero=torch.zeros((), dtype=torch.complex64, device=device))


def _sel(rows: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """rows [ch, B] -> [B]: row mc[b] at each bin b."""
    return torch.gather(rows, 0, mc[None])[0]


def process_block(carry: SpectralCarry, xs: BlockInputs, controls: Controls,
                  flags: SpectralFlags, consts: SpectralConsts,
                  dbg: Optional[dict] = None):
    """One spectral block (JAX spectral.process_block, in its order of
    operations) -> (carry', output spectrum [ch, B] complex64).

    Through the kernels: C (the smoothing) and G (peaks, output map and
    the down-vote positions) for a mapped render, E and, with the base
    estimated, F and C for formants, I (the draws) above 2x, A (every
    lookup of the block in one launch: the prediction at the input bins
    when mapped, and the votes) and H (the bin sweep); their plain
    versions on a CPU carry or inside ops.plain().  Nothing in it waits
    for the card: every branch is decided by the flags and the block's
    host values.  A `dbg` dict receives each kernel's inputs (the card's
    checks call the kernels on them)."""
    from . import planner
    from .ops import block_sweep, draws, interp, peaks, scan_ops
    ch, B = consts.channels, consts.bands
    longv = consts.long_vertical_step
    dev = carry.output.device
    t = _block_tables(B, longv, dev)
    new = bool(xs.new_spectrum)

    inp = xs.spectrum if new else carry.input
    prev_in = xs.prev_spectrum if xs.reanalyse else carry.prev_input
    output = carry.output
    if new:
        rotor = on_device(consts.rotor, dev)
        output = output * rotor
        prev_in = prev_in * rotor
    in_energy = inp.real * inp.real + inp.imag * inp.imag      # [ch, B]

    tf = max(f32(xs.time_factor), f32(1 / MAX_CLEAN_STRETCH))
    random_tf = bool(tf > f32(MAX_CLEAN_STRETCH))
    ltf = f32(f32(longv) * tf)
    if flags.mapped or flags.process_formants:
        energy = in_energy[0]
        for c in range(1, ch):
            energy = energy + in_energy[c]
        energy = energy[None]                                 # [1, B]

    pos = None
    if flags.mapped:
        # smoothing (C), then peaks, output map and the positions input_bin,
        # input_bin - tf and input_bin - longv*tf (G: :486-487 when the
        # block is not randomised)
        sm, _ = scan_ops.iir_chain(energy, t["zero"], consts.slew, SMOOTHING)
        tf_d = torch.full((1,), float(tf), device=dev)
        ltf_d = torch.full((1,), float(ltf), device=dev)
        if flags.custom_map is not None:
            pos, freq_grad = peaks.peaks_positions_custom(
                energy, sm, tf_d, ltf_d, flags.custom_map, consts)
        else:
            pos, freq_grad = peaks.peaks_positions(energy, sm, tf_d, ltf_d,
                                                   controls, consts)
        input_bin = pos[0, 0]
        if dbg is not None:
            dbg.update(energy=energy, smoothed=sm, shifts=(tf_d, ltf_d))
    else:
        input_bin = t["b_f"]

    few, fw = carry.freq_est_weighted, carry.freq_est_weight
    if flags.process_formants:
        ratio, estimate = planner._formant_ratio(
            energy, 1, controls, flags, consts, None, estimate=(few, fw))
        in_energy = in_energy * ratio
        if estimate is not None:
            few, fw = estimate

    # ---- the draws (:747-757): the split advances on every block, the
    # draws are taken only where they are used --------------------------
    rng, sub = prng.split(carry.rng)
    if random_tf:
        lo = f32(f32(2 * MAX_CLEAN_STRETCH) - tf)
        if flags.random_engine is not None:
            btf1, btf2 = draw_uniform(flags, sub, (2, B),
                                      torch.full((), float(lo), device=dev),
                                      torch.full((), float(tf), device=dev))
        else:
            btf1, btf2 = draws.draws_block(sub, lo, tf, B, dev)
        vote_pos = [input_bin - btf1, input_bin - float(longv) * btf1,
                    torch.roll(input_bin, -1) - btf2,
                    torch.roll(input_bin, -longv) - float(longv) * btf2]
    elif flags.mapped:
        vote_pos = [pos[0, 1], pos[0, 2]]
    else:
        vote_pos = [input_bin - float(tf), input_bin - float(ltf)]

    # ---- every lookup in one call (A): the prediction at input_bin of the
    # input, prevInput and energy rows when mapped, and the votes of each
    # channel's input, selected by the loudest channel below ------------
    rows_list = [inp[c][None] for c in range(ch)]
    specs = [(v[None], ch) for v in vote_pos]
    if flags.mapped:
        rows_list += ([prev_in[c][None] for c in range(ch)]
                      + [in_energy[c][None] for c in range(ch)])
        specs = [(input_bin[None], 3 * ch)] + specs
    if flags.mapped and not random_tf:
        stacked = pos                     # G's planes, as they lie
        specs = [(pos[:, k], n) for k, (_, n) in enumerate(specs)]
    else:
        stacked = torch.stack([p for p, _ in specs], 1)
        specs = [(stacked[:, k], n) for k, (_, n) in enumerate(specs)]
    planes, pos_sets, kinds = interp.pack(rows_list, specs)
    results, _ = interp.interp_multi(planes, pos_sets, pos=stacked)
    if dbg is not None:
        dbg.update(interp=(planes, pos_sets, stacked), energy_sum=(
            energy if flags.mapped or flags.process_formants else None))
    looked = interp.unpack(results, specs, kinds)     # per set, [1, B] rows
    if flags.mapped:
        vals, *looked = looked
    votes = [torch.cat(v, 0) for v in looked]           # per set, [ch, B]

    # ---- preliminary prediction (:697-719) --------------------------------
    if flags.mapped:
        pred_input = torch.cat(vals[:ch], 0)
        prev_interp = torch.cat(vals[ch:2 * ch], 0)
        pred_energy = torch.cat(vals[2 * ch:], 0) * torch.clamp(freq_grad,
                                                                min=0)
    else:
        pred_energy, pred_input, prev_interp = in_energy, inp, prev_in
    phase = output * (pred_input * torch.conj(prev_interp))
    out_prelim = planner._cdivr(
        phase, torch.maximum(carry.pred_energy, pred_energy) + NOISE_FLOOR)

    # ---- main prediction (:722-803) ---------------------------------------
    mc = torch.argmax(pred_energy, 0)                    # first max wins
    pe_max = _sel(pred_energy, mc)
    pi_max = _sel(pred_input, mc)
    if random_tf:
        short_down, long_down, up_short, up_long = (_sel(v, mc)
                                                    for v in votes)
    else:
        # both branches use the same factor: the up votes read the down
        # lookups one (and longv) bins up, in this bin's loudest channel
        short_down, long_down = _sel(votes[0], mc), _sel(votes[1], mc)
        up_short = _sel(torch.roll(votes[0], -1, 1), mc)
        up_long = _sel(torch.roll(votes[1], -longv, 1), mc)
    short_twist = pi_max * torch.conj(short_down)
    long_twist = pi_max * torch.conj(long_down)
    pi_up1 = _sel(pred_input[:, t["up1"]], mc)
    pi_upl = _sel(pred_input[:, t["upl"]], mc)
    up_twist = pi_up1 * torch.conj(up_short)
    up_long_twist = pi_upl * torch.conj(up_long)
    out_up1 = _sel(out_prelim[:, t["up1"]], mc)
    out_upl = _sel(out_prelim[:, t["upl"]], mc)
    phase_up = (torch.where(t["has_up1"], out_up1 * torch.conj(up_twist),
                            t["czero"])
                + torch.where(t["has_upl"],
                              out_upl * torch.conj(up_long_twist),
                              t["czero"]))
    ch_twist = pred_input * torch.conj(pi_max)[None]

    sweep_in = block_sweep.BlockSweepInputs(
        *[v.contiguous() for v in (short_twist, long_twist, phase_up, pe_max,
                                   pi_max)],
        mc.to(torch.int32),
        *[v.contiguous() for v in (ch_twist, pred_energy, pred_input)])
    if dbg is not None:
        dbg["sweep"] = sweep_in
    outputs = block_sweep.block_sweep(sweep_in, longv)

    # ---- prevInput <- input (:806-812) ------------------------------------
    carry2 = SpectralCarry(input=inp, prev_input=inp if new else prev_in,
                           output=outputs, pred_energy=pred_energy,
                           freq_est_weighted=few, freq_est_weight=fw, rng=rng)
    return carry2, outputs
