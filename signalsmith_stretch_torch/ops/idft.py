"""The synthesis's inverse modified DFT (kernel K, csrc/idft.cu).

`synthesize` turns spectra [..., bands] complex64 into windowed blocks
[..., block] float32, y[n] = 2 Re(ifft(pad(S, N))[n] conj(twist[n])) w[n]
for n < block, as kernel D's factorisation run backwards: one complex FFT
of half length M = N/2 a block (a pre-combine of bands b and M-1-b, D's
Stockham passes on D's tables between two conjugations, an epilogue that
unpacks the sample pairs and applies the twist and the window).  It
replaces no Pallas kernel: the JAX package synthesises with XLA's FFT
(signalsmith_stretch_tpu/stft.py:synthesize).  On a CPU tensor, or inside
ops.plain(), it runs the plain version, `stft.synthesize` (torch.fft: a
zero-padded copy and cuFFT's ifft on the card); on a CUDA tensor it
launches the kernel or raises.  The kernel is held to the plain version at
3e-6 of the block's peak magnitude, D's tolerance, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build, dft, runs_plain
from .. import stft
from ..tables import on_device

launches = 0          # kernel launches of synthesize


def _scaled(window: np.ndarray, fft_samples: int) -> np.ndarray:
    """The window over N, exact (N a power of two), padded to N samples."""
    w = np.zeros(fft_samples, np.float32)
    w[:window.size] = window / np.float32(fft_samples)
    return w


def consts(basis: "stft.StftBasis", device):
    """The scaled window and D's tables (pre-twist, post-twiddle, pass
    twiddles) on `device`, made once per (basis, device) (on_device)."""
    N = basis.fft_samples
    return ((on_device(basis.window, device, _scaled, N),)
            + dft.consts(basis, device)[1:])


def synthesize(spectra: torch.Tensor,
               basis: "stft.StftBasis") -> torch.Tensor:
    """Kernel wrapper: spectra [..., bands] complex64 -> [..., block] f32."""
    global launches
    if runs_plain(spectra):
        return stft.synthesize(spectra, basis)
    N, block, bands = basis.fft_samples, basis.block_samples, basis.bands
    log2n = N.bit_length() - 1
    if N != 1 << log2n or log2n not in dft.LOG2_FFT:
        raise ValueError(f"synthesize: fft size {N} is not a power of two in "
                         f"{1 << dft.LOG2_FFT[0]}..{1 << dft.LOG2_FFT[-1]}")
    if spectra.dtype != torch.complex64 or spectra.shape[-1] != bands:
        raise TypeError(f"synthesize: complex64 spectra [..., {bands}] "
                        f"expected, got {spectra.dtype} "
                        f"{tuple(spectra.shape)}")
    lead = spectra.shape[:-1]
    s = spectra.reshape(-1, bands).contiguous()
    wn, pre, post, tw = consts(basis, s.device)
    _build.require_cuda(s, wn, pre, post, tw)
    out = torch.empty((s.shape[0], block), dtype=torch.float32,
                      device=s.device)
    rc = _build.entry("idft")(
        s.data_ptr(), wn.data_ptr(), pre.data_ptr(), post.data_ptr(),
        tw.data_ptr(), out.data_ptr(), s.shape[0], block, log2n,
        tw.shape[0], torch.cuda.current_stream(s.device).cuda_stream)
    _build.check(rc, "sst_idft")
    launches += 1
    return out.reshape(lead + (block,))
