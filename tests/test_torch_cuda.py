"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips without
one.  These tests import neither JAX nor the JAX package, so on a machine
without JAX run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: bit equality.  The kernels are built with --fmad=false and IEEE
division and square root, so they round at the same points as the plain
versions, which are written as separate float32 PyTorch ops.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import wavefront  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.ops import interp, scan_ops  # noqa: E402
from signalsmith_stretch_torch.planner import SweepInputs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _t(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


@pytest.mark.parametrize("taps", [False, True])
def test_interp_kernel_matches_plain(dev, taps):
    rng = np.random.default_rng(0)
    rows, n, W0, B = 6, 5, 300, 256
    planes = _t(rng.standard_normal((rows, n, W0)).astype(np.float32), dev)
    base = np.cumsum(rng.uniform(0.2, 2.0, (rows, B)), 1).astype(np.float32)
    base -= 20                                   # some positions below 0
    far = base * 1.5 + 50                        # some at and past W0
    far[0, :3] = np.nan                          # NaN positions read zeros
    sets = [(_t(base, dev), 5, taps), (_t(far, dev), 2, taps),
            (_t(base - 3.25, dev), 3, taps)]
    got, viol = interp.interp_multi(planes, sets)
    ref, _ = interp.interp_multi_plain(planes, sets)
    assert viol == 0
    for g, r in zip(got, ref):
        for gg, rr in zip(g if taps else (g,), r if taps else (r,)):
            # bit equality; a NaN position's lerp is NaN in both
            torch.testing.assert_close(gg, rr, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("backward", [False, True])
def test_iir_kernel_matches_plain(dev, backward):
    rng = np.random.default_rng(1)
    x = _t(rng.uniform(0, 3, (37, 513)).astype(np.float32), dev)
    init = _t(rng.uniform(0, 1, 37).astype(np.float32), dev)
    y, fin = scan_ops.iir(x, init, 0.13, backward=backward)
    yp, finp = scan_ops.iir_plain(x, init, 0.13, backward=backward)
    assert torch.equal(y, yp) and torch.equal(fin, finp)


def _sweep_inputs(rng, batch, nB, B, ch, dev):
    def cplx(scale=1.0):
        z = (rng.standard_normal((batch, nB, B))
             + 1j * rng.standard_normal((batch, nB, B))) * scale
        return _t(z.astype(np.complex64), dev)

    return SweepInputs(
        a1=cplx(0.5), a2=cplx(0.5), d1=cplx(0.5), d2=cplx(0.5),
        mc=_t(rng.integers(0, ch, (batch, nB, B)).astype(np.int32), dev),
        pe=tuple(_t(rng.uniform(0, 2, (batch, nB, B)).astype(np.float32),
                    dev) for _ in range(ch)),
        pi=tuple(cplx() for _ in range(ch)))


@pytest.mark.parametrize("nB,B", [(70, 96), (2200, 24)],
                         ids=["shared_ring", "global_fallback"])
def test_sweep_kernel_matches_plain(dev, nB, B):
    """The second shape's ring (2200 rows x 2 channels x 7 diagonals) does
    not fit in shared memory, so the kernel reads its outputs back from the
    output array instead."""
    rng = np.random.default_rng(2)
    inputs = _sweep_inputs(rng, 2, nB, B, 2, dev)
    got = wavefront.sweep(inputs, 6)
    ref = wavefront.sweep_plain(inputs, 6)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("semitones", [0, 12])
def test_render_kernels_match_plain(dev, semitones):
    rng = np.random.default_rng(3)
    rate, n = 8000, 12000
    t = np.arange(n) / rate
    clip = np.stack([0.4 * np.sin(2 * np.pi * 165 * t + c)
                     + 0.02 * rng.standard_normal(n) for c in range(2)])
    model = StretchModel.build(channels=2, sample_rate=rate, in_samples=n,
                               out_samples=int(n * 1.25),
                               semitones=semitones, tonality_hz=2000,
                               device=dev)
    audio = _t(clip[None].astype(np.float32), dev)
    assert torch.equal(model.batched(audio), model.batched(audio, plain=True))
