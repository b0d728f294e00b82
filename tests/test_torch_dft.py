"""Kernel D's tables and algorithm, on the CPU.

Kernel D (csrc/dft.cu) computes the analysis spectra as one complex FFT of
half length M = N/2 per frame: pack the windowed sample pairs as
z_m = (y_2m + i y_2m+1) e^{-iπm/M}, run a mixed-radix Stockham FFT
(`dft.RADICES`), and post-combine band b with band M-1-b.  No CPU can run the
kernel, so these tests prove its pieces here:
- its host-built tables (pre-twist, post-twiddle, pass twiddles) lie within
  half an ulp of their float64 definitions, built here independently;
- a float64 numpy model of its algorithm, with its packing, its index maps
  (pass p reads X[j + r M/R], twiddles tw[(r-1)*NS + j mod NS], writes
  Y[(j/NS)*NS*R + j mod NS + r*NS]) and its pairing and post-combine, agrees
  with the port's plain analysis (torch.fft) and with the JAX package's
  matmul DFT `stft._matmul_dft` within 3e-6 of the spectrum's peak
  magnitude, the JAX package's own gate between its matmul DFT and its FFT
  (tests/test_stft.py:79), at the four SHAPES and at every FFT size the
  kernel is built for.
The kernel itself is held to the plain analysis on the card
(tests/test_torch_cuda.py, chip_smoke.py) at the same 3e-6.

Count: the 8 cases of the two-stage DFT this kernel replaced (its constants
against JAX's, 4; its two-stage sum, 4) went with it; 13 cases came in their
place (the tables, 4; the model at SHAPES, 4; the model at every FFT size, 5).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import ops, stft  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.ops import dft  # noqa: E402
from signalsmith_stretch_tpu import stft as jstft  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa: E402

# the block/interval pairs of tests/test_stft.py:52-53 (48 kHz default and
# cheaper presets, 44.1 kHz cheaper) and the 8 kHz fixtures' default preset
SHAPES = [(5760, 1440), (4800, 1920), (4410, 1764), (960, 240)]
# one block for each FFT size the kernel is built for, N 1024..16384
SIZES = [(600, 150), (1500, 375), (3000, 750), (5000, 1250), (11000, 2750)]
TOL = 3e-6


def _basis(block, interval):
    return (stft.StftBasis.for_config(StretchConfig(2, block, interval)),
            jstft.StftBasis.for_config(JConfig(2, block, interval)))


@pytest.mark.parametrize("block,interval", SHAPES)
def test_tables_match_float64(block, interval):
    """Every table entry within half an ulp (2^-24 at magnitude 1) of its
    float64 value, laid out as the kernel indexes it; the post-twiddle of
    band M-1-b is -conj of band b's, which the kernel relies on."""
    basis, _ = _basis(block, interval)
    N = basis.fft_samples
    M = N // 2
    pre, post, tw = dft.tables(N)
    assert pre.dtype == post.dtype == tw.dtype == np.complex64
    half_ulp = 2.0 ** -24
    want_pre = np.array([np.exp(-1j * np.pi * m / M) for m in range(M)])
    assert np.abs(pre - want_pre).max() <= half_ulp
    b = np.arange(M)
    full = np.exp(-2j * np.pi * (b + 0.5) / N)
    assert post.shape == (M // 2,)
    assert np.abs(post - full[:M // 2]).max() <= half_ulp
    assert np.abs(-np.conj(post) - full[::-1][:M // 2]).max() <= half_ulp
    want, ns = [], 1
    for p, R in enumerate(dft.RADICES[N.bit_length() - 1]):
        if p:
            want += [np.exp(-2j * np.pi * r * k / (ns * R))
                     for r in range(1, R) for k in range(ns)]
        ns *= R
    assert ns == M
    assert tw.shape == (len(want),)
    assert np.abs(tw - np.array(want)).max() <= half_ulp


def kernel_model(frames, basis):
    """Kernel D's algorithm in float64 with its index maps and its float32
    tables: frames [..., block] f32 -> spectra [..., M] complex128."""
    N, block = basis.fft_samples, basis.block_samples
    M = N // 2
    pre, post, tw = (t.astype(np.complex128) for t in dft.tables(N))
    y = np.zeros(frames.shape[:-1] + (N,))
    y[..., :block] = (frames * basis.window).astype(np.float32)  # kernel's y
    X = (y[..., 0::2] + 1j * y[..., 1::2]) * pre
    ns, off = 1, 0
    for p, R in enumerate(dft.RADICES[N.bit_length() - 1]):
        j = np.arange(M // R)[:, None]
        r = np.arange(R)[None, :]
        k = j % ns
        v = X[..., j + r * (M // R)]                     # [..., M/R, R]
        if p:
            v[..., 1:] *= tw[off + (r[:, 1:] - 1) * ns + k]
            off += (R - 1) * ns
        v = v @ np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        Y = np.empty_like(X)
        Y[..., (j // ns) * ns * R + k + r * ns] = v
        X, ns = Y, ns * R
    b = np.arange(M // 2)
    zb, zm = X[..., b], np.conj(X[..., M - 1 - b])
    po = post[b] * (zb - zm) / 2j
    S = np.empty_like(X)
    S[..., b] = (zb + zm) / 2 + po
    S[..., M - 1 - b] = np.conj((zb + zm) / 2 - po)
    return S


def _peak_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("block,interval", SHAPES)
def test_kernel_model_matches_fft_and_jax(block, interval):
    basis, jbasis = _basis(block, interval)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((5, 2, block)).astype(np.float32)
    model = kernel_model(frames, basis)
    plain = stft.analyze_plain(torch.as_tensor(frames), basis).numpy()
    assert _peak_err(plain, model) < TOL
    N2 = jstft._dft_mats(basis.fft_samples)[1]
    y = jnp.asarray(frames) * jnp.asarray(jbasis.window)
    pad = -(-block // N2) * N2 - block
    y = jnp.pad(y, [(0, 0), (0, 0), (0, pad)])
    xr, xi = jstft._matmul_dft(y, jbasis)
    assert _peak_err(np.asarray(xr) + 1j * np.asarray(xi), model) < TOL


@pytest.mark.parametrize("block,interval", SIZES,
                         ids=[f"N{1 << k}" for k in dft.LOG2_FFT])
def test_kernel_model_every_fft_size(block, interval):
    """The plan of every FFT size the kernel is built for, on frames of a
    tone over noise, against the plain analysis."""
    basis, _ = _basis(block, interval)
    assert basis.fft_samples.bit_length() - 1 in dft.RADICES
    rng = np.random.default_rng(4)
    n = np.arange(block)
    frames = (np.sin(2 * np.pi * 0.0371 * n)
              + 0.1 * rng.standard_normal((3, block))).astype(np.float32)
    model = kernel_model(frames, basis)
    plain = stft.analyze_plain(torch.as_tensor(frames), basis).numpy()
    assert _peak_err(plain, model) < TOL


def test_wrapper_takes_the_plain_analysis_on_the_cpu():
    """On a CPU tensor the kernel wrapper runs the plain analysis, bit for
    bit, and launches nothing; so it does inside ops.plain()."""
    basis, _ = _basis(960, 240)
    frames = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (3, 4, 960)).astype(np.float32))
    want = stft.analyze_plain(frames, basis)
    assert torch.equal(dft.analyze(frames, basis), want)
    with ops.plain():
        assert torch.equal(dft.analyze(frames, basis), want)
    assert dft.launches == 0
