"""The peaks and output map (kernel G, csrc/peaks.cu), with the mapped
planner's position sets.

`peaks_positions` is the port of signalsmith_stretch_tpu/spectral.py:
_peaks_and_map over rows, fused with the vote positions the planner
subtracts from its input bins: the runs of bins where the energy lies above
its smoothed curve, each run's sums of b*energy[b] and energy[b] taken
bin-ascending (the reference's `+=` order), the peaks through the frequency
map (one set of controls, or one for each block under automation), and per
bin the input bin, the input bin less the block's time factor
tf and less its long step's ltf (the three position sets of kernel A's one
call), and the gradient of the output map.  On a CPU tensor, or inside
ops.plain(), it runs the plain version (`peaks_positions_plain`); on a
CUDA tensor it launches the kernel or raises.

A custom frequency map is a Python callable, which cannot run inside the
kernel: `peaks_positions_custom` splits G around it into two entries of
the same source, each a kernel of its own, `peak_runs` (the runs, each
peak's average band and frequency) and `output_positions` (the output map
and the position sets from the mapped frequencies), and calls the map on
the card between them.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, runs_plain
from .. import spectral

launches = 0          # kernel launches of peaks_positions
runs_launches = 0     # of peak_runs (the runs entry)
out_launches = 0      # of output_positions (the out entry)
# the entries' phases, as their timed entries split them (csrc/peaks.cu
# STAMP)
PHASES = ("wait", "flags", "runs", "prefix", "map")
RUNS_PHASES = ("wait", "flags", "runs")
OUT_PHASES = ("wait", "peaks", "prefix", "map")

f32 = np.float32


def peaks_positions_plain(energy: torch.Tensor, smoothed: torch.Tensor,
                          tf: torch.Tensor, ltf: torch.Tensor,
                          controls: spectral.Controls,
                          consts: spectral.SpectralConsts):
    """Plain version of peaks_positions (same contract): the plain peaks
    map and the two subtractions, each one float32 operation."""
    input_bin, freq_grad = spectral._peaks_and_map(energy, smoothed, controls,
                                                   consts)
    return _position_sets(input_bin, tf, ltf), freq_grad


def _position_sets(input_bin, tf, ltf):
    """[R, 3, B]: input_bin, less tf and less ltf of each row's block."""
    clips = input_bin.shape[0] // tf.shape[0]
    t1 = tf.repeat(clips)[:, None]          # rows are block-major per clip
    t2 = ltf.repeat(clips)[:, None]
    return torch.stack([input_bin, input_bin - t1, input_bin - t2], 1)


def _check_rows(what, energy, smoothed, consts):
    _build.require_cuda(energy, smoothed)
    if any(t.dtype != torch.float32 for t in (energy, smoothed)):
        raise TypeError(f"{what}: float32 tensors expected")
    if energy.dim() != 2 or smoothed.shape != energy.shape:
        raise ValueError(f"{what}: energy and smoothed [R, B] expected, got "
                         f"{tuple(energy.shape)} and "
                         f"{tuple(smoothed.shape)}")
    N = consts.fft_samples
    if N & (N - 1):
        # the kernel and the plain version on the card multiply by 1/N,
        # which equals the CPU's division only for a power of two
        raise ValueError(f"{what}: FFT size {N} is not a power of two")
    if 3 * energy.numel() >= 2 ** 31:
        raise ValueError(f"{what}: {tuple(energy.shape)} exceeds 32-bit "
                         f"indexing")


def _check_shifts(what, R, tf, ltf):
    _build.require_cuda(tf, ltf)
    if any(t.dtype != torch.float32 for t in (tf, ltf)):
        raise TypeError(f"{what}: float32 tensors expected")
    if (tf.dim() != 1 or ltf.shape != tf.shape or tf.shape[0] == 0
            or R % tf.shape[0]):
        raise ValueError(f"{what}: tf and ltf [nB] with nB dividing {R} rows "
                         f"expected, got {tuple(tf.shape)} and "
                         f"{tuple(ltf.shape)}")


def _check(energy, smoothed, tf, ltf, controls, consts):
    _check_rows("peaks_positions", energy, smoothed, consts)
    _build.require_cuda(energy, tf)
    _check_shifts("peaks_positions", energy.shape[0], tf, ltf)
    if controls.automated and len(controls.freq_multiplier) != tf.shape[0]:
        raise ValueError(f"peaks_positions: per-block controls of "
                         f"{len(controls.freq_multiplier)} blocks for "
                         f"{tf.shape[0]} blocks")


def map_constants(controls: spectral.Controls) -> np.ndarray:
    """The frequency map's float32 constants per block, [nC, 3]: limit,
    mult and above_off = f32(f32(mult - 1) * limit), the expressions of
    spectral.map_freq; nC = 1 for scalar controls, nB under automation."""
    limit = np.atleast_1d(np.asarray(controls.freq_tonality_limit, f32))
    mult = np.atleast_1d(np.asarray(controls.freq_multiplier, f32))
    above_off = (mult - f32(1)) * limit
    return np.ascontiguousarray(np.stack([limit, mult, above_off], 1), f32)


@functools.lru_cache(maxsize=8)
def _map_constants_on(key: tuple, device: torch.device) -> torch.Tensor:
    """map_constants of the controls with this Controls.key() on `device`,
    copied once per (controls, device)."""
    return torch.as_tensor(map_constants(spectral.Controls.from_key(key)),
                           device=device)


def _launch(entry, energy, smoothed, tf, ltf, controls, consts, *extra):
    R, B = energy.shape
    ctl = _map_constants_on(controls.key(), energy.device)
    pos = torch.empty((R, 3, B), dtype=torch.float32, device=energy.device)
    freq_grad = torch.empty_like(energy)
    rc = _build.entry(entry)(
        energy.data_ptr(), smoothed.data_ptr(), tf.data_ptr(), ltf.data_ptr(),
        pos.data_ptr(), freq_grad.data_ptr(), R, B, tf.shape[0],
        consts.fft_samples, ctl.data_ptr(), ctl.shape[0],
        *extra, torch.cuda.current_stream(energy.device).cuda_stream)
    _build.check(rc, f"peaks kernel entry {entry!r}")
    return pos, freq_grad


def peaks_positions(energy: torch.Tensor, smoothed: torch.Tensor,
                    tf: torch.Tensor, ltf: torch.Tensor,
                    controls: spectral.Controls,
                    consts: spectral.SpectralConsts):
    """Kernel wrapper (G): energy, smoothed [R, B] f32 (rows block-major per
    clip), tf and ltf [nB] f32 -> (pos [R, 3, B], freq_grad [R, B]) f32,
    one launch.  pos[:, 0] is the input bin, pos[:, 1] and pos[:, 2] that
    less tf and ltf of the row's block.  Controls are scalars or per-block
    [nB] arrays (automation); the kernel reads row r's block r % nB."""
    global launches
    if runs_plain(energy):
        return peaks_positions_plain(energy, smoothed, tf, ltf, controls,
                                     consts)
    _check(energy, smoothed, tf, ltf, controls, consts)
    out = _launch("peaks", energy, smoothed, tf, ltf, controls, consts)
    launches += 1
    return out


def phase_stamps(energy: torch.Tensor, smoothed: torch.Tensor,
                 tf: torch.Tensor, ltf: torch.Tensor,
                 controls: spectral.Controls,
                 consts: spectral.SpectralConsts) -> torch.Tensor:
    """The kernel's timed entry, which the main path never calls: the same
    outputs, and per CTA the clock64() cycles of each of PHASES summed over
    its rows, its start and end on the global timer (ns) and its SM, as
    [CTAs, len(PHASES) + 3] int64 on the card.  Not counted in
    `launches`."""
    _check(energy, smoothed, tf, ltf, controls, consts)
    stamps = torch.zeros((energy.shape[0], len(PHASES) + 3),
                         dtype=torch.int64, device=energy.device)
    _launch("peaks_timed", energy, smoothed, tf, ltf, controls, consts,
            stamps.data_ptr())
    return stamps[stamps[:, len(PHASES) + 1] > 0]


# ---------------------------------------------------------------------------
# G split around a custom frequency map: the runs entry and the out entry
# ---------------------------------------------------------------------------
def peak_runs_plain(energy: torch.Tensor, smoothed: torch.Tensor,
                    consts: spectral.SpectralConsts):
    """Plain version of peak_runs: spectral._peak_runs."""
    return spectral._peak_runs(energy, smoothed, consts)


_queues: dict = {}


def _queue(device: torch.device, stream: int) -> torch.Tensor:
    """The out entry's row queue (csrc/peaks.cu claim_row) for `stream`
    on `device`: two int32 counters, zeroed once here; every launch leaves
    them zero, and launches on one stream run in turn."""
    key = (device, stream)
    if key not in _queues:
        _queues[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _queues[key]


def _launch_runs(entry, energy, smoothed, consts, *extra):
    R, B = energy.shape
    nseg = B // 2 + 2
    peak_in = torch.empty((R, nseg), dtype=torch.float32,
                          device=energy.device)
    avg_freq = torch.empty_like(peak_in)
    n_peaks = torch.empty(R, dtype=torch.int32, device=energy.device)
    rc = _build.entry(entry)(
        energy.data_ptr(), smoothed.data_ptr(), peak_in.data_ptr(),
        avg_freq.data_ptr(), n_peaks.data_ptr(), R, B, consts.fft_samples,
        *extra, torch.cuda.current_stream(energy.device).cuda_stream)
    _build.check(rc, f"peaks kernel entry {entry!r}")
    return peak_in, avg_freq, n_peaks


def peak_runs(energy: torch.Tensor, smoothed: torch.Tensor,
              consts: spectral.SpectralConsts):
    """Kernel wrapper (G's runs entry): energy, smoothed [R, B] f32 ->
    (peak_in, avg_freq) [R, B // 2 + 2] f32 and n_peaks [R] int32: slot i <
    n_peaks[r] holds row r's peak i, its average band (each run summed
    bin-ascending) and its frequency (avg + 0.5) / N; the later slots hold
    0.  One launch; no map, no histogram."""
    global runs_launches
    if runs_plain(energy):
        return peak_runs_plain(energy, smoothed, consts)
    _check_rows("peak_runs", energy, smoothed, consts)
    out = _launch_runs("peaks_runs", energy, smoothed, consts)
    runs_launches += 1
    return out


def output_positions_plain(peak_in: torch.Tensor, mapped: torch.Tensor,
                           n_peaks: torch.Tensor, tf: torch.Tensor,
                           ltf: torch.Tensor, B: int,
                           consts: spectral.SpectralConsts):
    """Plain version of output_positions: spectral._output_map and the two
    subtractions."""
    input_bin, freq_grad = spectral._output_map(peak_in, mapped, n_peaks, B,
                                                consts)
    return _position_sets(input_bin, tf, ltf), freq_grad


def _check_out(peak_in, mapped, n_peaks, tf, ltf, B, consts):
    what = "output_positions"
    _build.require_cuda(peak_in, mapped, n_peaks, tf, ltf)
    if peak_in.dtype != torch.float32 or mapped.dtype != torch.float32:
        raise TypeError(f"{what}: float32 peak_in and mapped expected")
    if n_peaks.dtype != torch.int32:
        raise TypeError(f"{what}: int32 n_peaks expected")
    R = peak_in.shape[0]
    nseg = B // 2 + 2
    if (peak_in.shape != (R, nseg) or mapped.shape != peak_in.shape
            or n_peaks.shape != (R,)):
        raise ValueError(f"{what}: peak_in and mapped [R, {nseg}] and "
                         f"n_peaks [R] expected, got {tuple(peak_in.shape)}, "
                         f"{tuple(mapped.shape)} and {tuple(n_peaks.shape)}")
    _check_shifts(what, R, tf, ltf)
    if consts.fft_samples & (consts.fft_samples - 1):
        raise ValueError(f"{what}: FFT size {consts.fft_samples} is not a "
                         f"power of two")
    if 3 * R * B >= 2 ** 31:
        raise ValueError(f"{what}: [{R}, 3, {B}] exceeds 32-bit indexing")


def _launch_out(entry, peak_in, mapped, n_peaks, tf, ltf, B, consts, *extra):
    R = peak_in.shape[0]
    pos = torch.empty((R, 3, B), dtype=torch.float32, device=peak_in.device)
    freq_grad = torch.empty((R, B), dtype=torch.float32,
                            device=peak_in.device)
    stream = torch.cuda.current_stream(peak_in.device).cuda_stream
    rc = _build.entry(entry)(
        peak_in.data_ptr(), mapped.data_ptr(), n_peaks.data_ptr(),
        tf.data_ptr(), ltf.data_ptr(), pos.data_ptr(), freq_grad.data_ptr(),
        R, B, tf.shape[0], consts.fft_samples,
        _queue(peak_in.device, stream).data_ptr(), *extra, stream)
    _build.check(rc, f"peaks kernel entry {entry!r}")
    return pos, freq_grad


def output_positions(peak_in: torch.Tensor, mapped: torch.Tensor,
                     n_peaks: torch.Tensor, tf: torch.Tensor,
                     ltf: torch.Tensor, B: int,
                     consts: spectral.SpectralConsts):
    """Kernel wrapper (G's out entry): peak_in and mapped [R, B // 2 + 2]
    f32 (peak_runs' peak_in and its avg_freq through the frequency map),
    n_peaks [R] int32, tf and ltf [nB] f32 -> (pos [R, 3, B], freq_grad
    [R, B]) f32, as peaks_positions.  Each peak's output band is mapped * N
    - 0.5; only the slots below n_peaks[r] are read, so the later ones may
    hold anything, NaN too.  One launch."""
    global out_launches
    if runs_plain(peak_in):
        return output_positions_plain(peak_in, mapped, n_peaks, tf, ltf, B,
                                      consts)
    _check_out(peak_in, mapped, n_peaks, tf, ltf, B, consts)
    out = _launch_out("peaks_out", peak_in, mapped, n_peaks, tf, ltf, B,
                      consts)
    out_launches += 1
    return out


def peaks_positions_custom(energy: torch.Tensor, smoothed: torch.Tensor,
                           tf: torch.Tensor, ltf: torch.Tensor,
                           custom_map, consts: spectral.SpectralConsts):
    """peaks_positions under a custom frequency map: G's runs entry, the
    callable on every slot of avg_freq [R, B // 2 + 2] on the card (float32
    in and out, elementwise: spectral.custom_map_freq holds it to that),
    then G's out entry (each entry's plain version where it runs plain)."""
    peak_in, avg_freq, n_peaks = peak_runs(energy, smoothed, consts)
    mapped = spectral.custom_map_freq(custom_map, avg_freq)
    return output_positions(peak_in, mapped, n_peaks, tf, ltf,
                            energy.shape[1], consts)


def split_occupancy(B: int) -> dict:
    """The split's entries on the current card at width B, as the main path
    launches them (16-byte rows): {"peaks_runs": (CTAs resident an SM,
    registers a thread), "peaks_out": (...)}, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor at each entry's shared
    memory and cudaFuncGetAttributes.  Launches nothing."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.entry("peaks_occupancy")(B, ctypes.addressof(out)),
                 "peaks kernel entry 'peaks_occupancy'")
    return {"peaks_runs": (out[0], out[1]), "peaks_out": (out[2], out[3])}


def runs_stamps(energy: torch.Tensor, smoothed: torch.Tensor,
                consts: spectral.SpectralConsts) -> torch.Tensor:
    """The runs entry's timed entry (never on the main path): per CTA the
    cycles of each of RUNS_PHASES, as phase_stamps.  Not counted."""
    _check_rows("peak_runs", energy, smoothed, consts)
    P = len(RUNS_PHASES)
    stamps = torch.zeros((energy.shape[0], P + 3), dtype=torch.int64,
                         device=energy.device)
    _launch_runs("peaks_runs_timed", energy, smoothed, consts,
                 stamps.data_ptr())
    return stamps[stamps[:, P + 1] > 0]


def out_stamps(peak_in: torch.Tensor, mapped: torch.Tensor,
               n_peaks: torch.Tensor, tf: torch.Tensor, ltf: torch.Tensor,
               B: int, consts: spectral.SpectralConsts) -> torch.Tensor:
    """The out entry's timed entry (never on the main path): per CTA the
    cycles of each of OUT_PHASES, as phase_stamps.  Not counted."""
    _check_out(peak_in, mapped, n_peaks, tf, ltf, B, consts)
    P = len(OUT_PHASES)
    stamps = torch.zeros((peak_in.shape[0], P + 3), dtype=torch.int64,
                         device=peak_in.device)
    _launch_out("peaks_out_timed", peak_in, mapped, n_peaks, tf, ltf, B,
                consts, stamps.data_ptr())
    return stamps[stamps[:, P + 1] > 0]
