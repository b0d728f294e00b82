"""The peaks and output map (kernel G, csrc/peaks.cu).

`peaks_and_map` is the port of signalsmith_stretch_tpu/spectral.py:
_peaks_and_map over rows: the runs of bins where the energy lies above its
smoothed curve, each run's sums of b*energy[b] and energy[b] taken
bin-ascending (the reference's `+=` order), the peaks through the frequency
map, and per bin the input bin and the gradient of the output map.  On a
CPU tensor it runs the plain version (`spectral._peaks_and_map`); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .. import spectral

launches = 0          # kernel launches of peaks_and_map

f32 = np.float32


def peaks_and_map(energy: torch.Tensor, smoothed: torch.Tensor,
                  controls: spectral.Controls,
                  consts: spectral.SpectralConsts):
    """Kernel wrapper (G): energy, smoothed [R, B] f32 -> (input_bin,
    freq_grad) [R, B] f32, one launch."""
    global launches
    if energy.device.type == "cpu":
        return spectral._peaks_and_map(energy, smoothed, controls, consts)
    _build.require_cuda(energy, smoothed)
    if energy.dtype != torch.float32 or smoothed.dtype != torch.float32:
        raise TypeError("peaks_and_map: float32 tensors expected")
    if energy.dim() != 2 or smoothed.shape != energy.shape:
        raise ValueError(f"peaks_and_map: energy and smoothed [R, B] expected, "
                         f"got {tuple(energy.shape)} and "
                         f"{tuple(smoothed.shape)}")
    N = consts.fft_samples
    if N & (N - 1):
        # the plain version on the card multiplies by 1/N where the kernel
        # divides: the two agree only for a power of two
        raise ValueError(f"peaks_and_map: FFT size {N} is not a power of two")
    R, B = energy.shape
    if energy.numel() >= 2 ** 31:
        raise ValueError(f"peaks_and_map: {tuple(energy.shape)} exceeds 32-bit "
                         f"indexing")
    limit = f32(controls.freq_tonality_limit)
    mult = f32(controls.freq_multiplier)
    above_off = f32(f32(mult - f32(1)) * limit)
    input_bin = torch.empty_like(energy)
    freq_grad = torch.empty_like(energy)
    rc = _build.entry("peaks")(
        energy.data_ptr(), smoothed.data_ptr(), input_bin.data_ptr(),
        freq_grad.data_ptr(), R, B, N, float(limit), float(mult),
        float(above_off), torch.cuda.current_stream(energy.device).cuda_stream)
    _build.check(rc, "sst_peaks_map")
    launches += 1
    return input_bin, freq_grad
