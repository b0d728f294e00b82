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
call), and the gradient of the output map.  On a CPU tensor it runs the
plain version (`peaks_positions_plain`); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .. import spectral

launches = 0          # kernel launches of peaks_positions
# the kernel's phases, as its timed entry splits them (csrc/peaks.cu STAMP)
PHASES = ("wait", "flags", "runs", "prefix", "map")

f32 = np.float32


def peaks_positions_plain(energy: torch.Tensor, smoothed: torch.Tensor,
                          tf: torch.Tensor, ltf: torch.Tensor,
                          controls: spectral.Controls,
                          consts: spectral.SpectralConsts):
    """Plain version of peaks_positions (same contract): the plain peaks
    map and the two subtractions, each one float32 operation."""
    input_bin, freq_grad = spectral._peaks_and_map(energy, smoothed, controls,
                                                   consts)
    clips = energy.shape[0] // tf.shape[0]
    t1 = tf.repeat(clips)[:, None]          # rows are block-major per clip
    t2 = ltf.repeat(clips)[:, None]
    return torch.stack([input_bin, input_bin - t1, input_bin - t2], 1), \
        freq_grad


def _check(energy, smoothed, tf, ltf, controls, consts):
    _build.require_cuda(energy, smoothed, tf, ltf)
    if any(t.dtype != torch.float32 for t in (energy, smoothed, tf, ltf)):
        raise TypeError("peaks_positions: float32 tensors expected")
    if energy.dim() != 2 or smoothed.shape != energy.shape:
        raise ValueError(f"peaks_positions: energy and smoothed [R, B] "
                         f"expected, got {tuple(energy.shape)} and "
                         f"{tuple(smoothed.shape)}")
    if (tf.dim() != 1 or ltf.shape != tf.shape or tf.shape[0] == 0
            or energy.shape[0] % tf.shape[0]):
        raise ValueError(f"peaks_positions: tf and ltf [nB] with nB dividing "
                         f"{energy.shape[0]} rows expected, got "
                         f"{tuple(tf.shape)} and {tuple(ltf.shape)}")
    if controls.automated and len(controls.freq_multiplier) != tf.shape[0]:
        raise ValueError(f"peaks_positions: per-block controls of "
                         f"{len(controls.freq_multiplier)} blocks for "
                         f"{tf.shape[0]} blocks")
    N = consts.fft_samples
    if N & (N - 1):
        # the kernel and the plain version on the card multiply by 1/N,
        # which equals the CPU's division only for a power of two
        raise ValueError(f"peaks_positions: FFT size {N} is not a power of "
                         f"two")
    if 3 * energy.numel() >= 2 ** 31:
        raise ValueError(f"peaks_positions: {tuple(energy.shape)} exceeds "
                         f"32-bit indexing")


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
    if energy.device.type == "cpu":
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
