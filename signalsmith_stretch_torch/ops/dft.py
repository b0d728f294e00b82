"""The analysis DFT (kernel D, csrc/dft.cu).

`analyze` is the port of the TPU kernel `fwd` (tools/exp_pallas_dft.py:
pallas_fwd): the modified real DFT S_b = sum_n w[n] x[n] e^{-2πi n (b+0.5)/N},
b < N/2, of windowed frames, which the kernel computes as one complex FFT of
half length M = N/2 per frame (pack the sample pairs, pre-twist, a mixed-radix
Stockham FFT in shared memory, post-combine bands b and M-1-b).  On a CPU
tensor, or inside ops.plain(), it runs the plain version,
`stft.analyze_plain` (torch.fft); on a CUDA tensor it launches the kernel
or raises.  The kernel is held to the
plain version (cuFFT on the card) at 3e-6 of the spectrum's peak magnitude,
not bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, runs_plain
from .. import stft
from ..tables import on_device

launches = 0          # kernel launches of analyze
# the radices of the FFT passes for each log2 N, in order: the plan the
# kernel hard-codes (csrc/dft.cu `radix`), M = N/2 points in all
RADICES = {10: (8, 8, 8), 11: (16, 8, 8), 12: (16, 16, 8), 13: (16, 16, 16),
           14: (16, 16, 16, 2)}
LOG2_FFT = range(10, 15)   # fft sizes the kernel is built for: 1024..16384


def _rounded(angle: np.ndarray) -> np.ndarray:
    """e^{i angle} from float64, each part rounded to float32."""
    return (np.cos(angle).astype(np.float32)
            + 1j * np.sin(angle).astype(np.float32)).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def tables(fft_samples: int):
    """The kernel's host-built constants for N = fft_samples, complex64:
    pre [M] = e^{-iπ m/M} (pre-twist), post [M/2] = e^{-2πi (b+0.5)/N}
    (post-twiddle of bands b < M/2; band M-1-b takes -conj), and the pass
    twiddles tw: for each pass p >= 1 of RADICES (radix R after
    NS = R_0...R_{p-1}), W_{NS R}^{r k} = e^{-2πi r k/(NS R)} at
    [(r-1)*NS + k] for 1 <= r < R, k < NS, the passes one after another."""
    N = fft_samples
    M = N // 2
    pre = _rounded(-np.pi * np.arange(M, dtype=np.float64) / M)
    post = _rounded(-2 * np.pi * (np.arange(M // 2, dtype=np.float64) + 0.5)
                    / N)
    parts, ns = [], 1
    for p, R in enumerate(RADICES[N.bit_length() - 1]):
        if p:
            r = np.arange(1, R, dtype=np.float64)[:, None]
            k = np.arange(ns, dtype=np.float64)[None, :]
            parts.append(_rounded(-2 * np.pi * r * k / (ns * R)).ravel())
        ns *= R
    return pre, post, np.concatenate(parts)


def _padded(window: np.ndarray, fft_samples: int) -> np.ndarray:
    """The window padded with zeros to N = fft_samples samples."""
    w = np.zeros(fft_samples, np.float32)
    w[:window.size] = window
    return w


def consts(basis: "stft.StftBasis", device):
    """The padded window and the tables on `device`, made once per (basis,
    device) and fft size (on_device)."""
    N = basis.fft_samples
    return ((on_device(basis.window, device, _padded, N),)
            + tuple(on_device(t, device) for t in tables(N)))


def analyze(frames: torch.Tensor, basis: "stft.StftBasis") -> torch.Tensor:
    """Kernel wrapper: frames [..., block] f32 -> [..., bands] complex64."""
    global launches
    if runs_plain(frames):
        return stft.analyze_plain(frames, basis)
    N, block = basis.fft_samples, basis.block_samples
    log2n = N.bit_length() - 1
    if N != 1 << log2n or log2n not in LOG2_FFT:
        raise ValueError(f"analyze: fft size {N} is not a power of two in "
                         f"{1 << LOG2_FFT[0]}..{1 << LOG2_FFT[-1]}")
    if frames.dtype != torch.float32 or frames.shape[-1] != block:
        raise TypeError(f"analyze: float32 frames [..., {block}] expected, "
                        f"got {frames.dtype} {tuple(frames.shape)}")
    lead = frames.shape[:-1]
    x = frames.reshape(-1, block).contiguous()
    w, pre, post, tw = consts(basis, x.device)
    _build.require_cuda(x, w, pre, post, tw)
    out = torch.empty((x.shape[0], basis.bands), dtype=torch.complex64,
                      device=x.device)
    rc = _build.entry("dft")(
        x.data_ptr(), w.data_ptr(), pre.data_ptr(), post.data_ptr(),
        tw.data_ptr(), out.data_ptr(), x.shape[0], block, log2n,
        tw.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sst_dft")
    launches += 1
    return out.reshape(lead + (basis.bands,))
