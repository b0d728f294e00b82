"""The port's DFT constants and the factorisation of kernel D, on the CPU.

Kernel D (csrc/dft.cu) computes the analysis spectra as the two-stage DFT
of `stft._dft_mats`: stage 1 over n1 from the real windowed frame, the
twiddle, stage 2 over n2.  No CPU can run it, so these tests prove its
pieces here: the constants are bit-equal to the JAX package's (host numpy
in float64, cast to complex64 and float32), and the two-stage sum built
from them, evaluated in float64 with the kernel's indexing (n1u rows of N2
samples, zeros past the block), agrees with the port's plain analysis
(torch.fft) and with the JAX package's matmul DFT `stft._matmul_dft` within
3e-6 of the spectrum's peak magnitude, the JAX package's own gate between
its matmul DFT and its FFT (tests/test_stft.py:79).  Measured: up to
1.5e-7 of peak against torch.fft, up to 2.6e-7 against the matmul DFT.  The
kernel itself is held to the plain analysis on the card
(tests/test_torch_cuda.py, chip_smoke.py) at the same 3e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import stft  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.ops import dft  # noqa: E402
from signalsmith_stretch_tpu import stft as jstft  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa: E402

# the block/interval pairs of tests/test_stft.py:52-53 (48 kHz default and
# cheaper presets, 44.1 kHz cheaper) and the 8 kHz fixtures' default preset
SHAPES = [(5760, 1440), (4800, 1920), (4410, 1764), (960, 240)]
TOL = 3e-6


def _basis(block, interval):
    return (stft.StftBasis.for_config(StretchConfig(2, block, interval)),
            jstft.StftBasis.for_config(JConfig(2, block, interval)))


@pytest.mark.parametrize("block,interval", SHAPES)
def test_dft_constants_match_jax(block, interval):
    """The port keeps only the forward constants kernel D reads (N1, N2,
    dft1, tw, dft2): bit-equal to the first five of JAX's `_dft_mats`, and
    the twiddle-folded stage-2 tensors of the TPU kernel (T1, T2 of JAX's
    `_dft_fused_mats`) follow from them bit for bit."""
    basis, _ = _basis(block, interval)
    N = basis.fft_samples
    got, ref = stft._dft_mats(N), jstft._dft_mats(N)
    assert got[:2] == ref[:2]
    for a, b in zip(got[2:], ref[2:5]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    _, _, _, tw, dft2 = got
    T1 = (tw.real[:, :, None] * dft2.real[None]
          - tw.imag[:, :, None] * dft2.imag[None]).astype(np.float32)
    T2 = (tw.real[:, :, None] * dft2.imag[None]
          + tw.imag[:, :, None] * dft2.real[None]).astype(np.float32)
    for a, b in zip((T1, T2), jstft._dft_fused_mats(N)[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _two_stage(frames, basis):
    """Kernel D's sum in float64: y = frames * window (float32, as the
    kernel rounds it), n1u = ceil(block/N2) rows of N2 samples with zeros
    past the block, stage 1 with dft1[:, :n1u], the twiddle, stage 2, and
    band b = k1 + N1*k2."""
    N1, N2, dft1, tw, dft2 = stft._dft_mats(basis.fft_samples)
    block = basis.block_samples
    n1u = -(-block // N2)
    y = (frames * basis.window).astype(np.float32).astype(np.float64)
    y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, n1u * N2 - block)])
    y = y.reshape(-1, n1u, N2)
    a = np.einsum("kn,fnm->fkm", dft1[:, :n1u].astype(np.complex128), y)
    b = a * tw.astype(np.complex128)
    x = np.einsum("fkm,mq->fqk", b, dft2.astype(np.complex128))
    return x.reshape(frames.shape[:-1] + (basis.bands,))


def _peak_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("block,interval", SHAPES)
def test_two_stage_sum_matches_fft_and_jax(block, interval):
    basis, jbasis = _basis(block, interval)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((5, 2, block)).astype(np.float32)
    two = _two_stage(frames, basis)
    plain = stft.analyze_plain(torch.as_tensor(frames), basis).numpy()
    assert _peak_err(plain, two) < TOL
    N2 = jstft._dft_mats(basis.fft_samples)[1]
    y = jnp.asarray(frames) * jnp.asarray(jbasis.window)
    pad = -(-block // N2) * N2 - block
    y = jnp.pad(y, [(0, 0), (0, 0), (0, pad)])
    xr, xi = jstft._matmul_dft(y, jbasis)
    assert _peak_err(np.asarray(xr) + 1j * np.asarray(xi), two) < TOL


def test_wrapper_takes_the_plain_analysis_on_the_cpu():
    """On a CPU tensor the kernel wrapper runs the plain analysis, bit for
    bit, and launches nothing; so does stft.analyze."""
    basis, _ = _basis(960, 240)
    frames = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (3, 4, 960)).astype(np.float32))
    want = stft.analyze_plain(frames, basis)
    assert torch.equal(dft.analyze(frames, basis), want)
    assert torch.equal(stft.analyze(frames, basis), want)
    assert dft.launches == 0
