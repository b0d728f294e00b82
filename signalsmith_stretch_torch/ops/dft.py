"""The analysis DFT (kernel D, csrc/dft.cu).

`analyze` is the port of the TPU kernel `fwd` (tools/exp_pallas_dft.py:
pallas_fwd), the fused two-stage forward DFT of windowed frames: the
modified real DFT S_b = sum_n w[n] x[n] e^{-2πi n (b+0.5)/N}, b < N/2, from
the constants of `stft._dft_mats`.  On a CPU tensor it runs the plain
version, `stft.analyze_plain` (torch.fft); on a CUDA tensor it launches the
kernel or raises.  The kernel is held to the plain version (cuFFT on the
card) at 3e-6 of the spectrum's peak magnitude, not bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .. import stft

launches = 0          # kernel launches of analyze
LOG2_FFT = range(10, 15)   # fft sizes the kernel is built for: 1024..16384


@functools.lru_cache(maxsize=8)
def _consts(window: bytes, fft_samples: int, device: torch.device):
    """The window and the DFT constants on `device`: dft1 cut to the
    n1u = ceil(block / N2) rows a frame fills, the twiddles and dft2, all
    complex64.  Built once per (window, fft size, device)."""
    _, N2, dft1, tw, dft2 = stft._dft_mats(fft_samples)
    w = np.frombuffer(window, np.float32).copy()
    n1u = -(-w.size // N2)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dev(w), dev(dft1[:, :n1u]), dev(tw), dev(dft2), n1u


def analyze(frames: torch.Tensor, basis: "stft.StftBasis") -> torch.Tensor:
    """Kernel wrapper: frames [..., block] f32 -> [..., bands] complex64."""
    global launches
    if frames.device.type == "cpu":
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
    w, dft1, tw, dft2, n1u = _consts(
        np.ascontiguousarray(basis.window, np.float32).tobytes(), N,
        x.device)
    _build.require_cuda(x, w, dft1, tw, dft2)
    out = torch.empty((x.shape[0], basis.bands), dtype=torch.complex64,
                      device=x.device)
    rc = _build.entry("dft")(
        x.data_ptr(), w.data_ptr(), dft1.data_ptr(), tw.data_ptr(),
        dft2.data_ptr(), out.data_ptr(), x.shape[0], block, log2n, n1u,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sst_dft")
    launches += 1
    return out.reshape(lead + (basis.bands,))
