"""The port's slew scan (ops/scan_ops.py) against the JAX package, on the CPU.

The port runs the recurrence y_b = y_{b-1} + (x_b - y_{b-1}) * slew in the
reference's serial bin order (its card kernel, csrc/scan.cu, is held to the
plain loop bit for bit in tests/test_torch_cuda.py).  The JAX package runs
the same recurrence as a log-depth associative scan, which reassociates the
products and sums.  Tolerance: 1e-6 of each row's largest magnitude
(docs/PARITY.md pins the JAX smoothing to ~3e-7 of the reference's serial
values; on these rows one pass measures up to 1.6e-7, the four-pass chain
up to 4.6e-7, and a pass's final value against its own magnitude up to
7.8e-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.ops import scan_ops  # noqa: E402
from signalsmith_stretch_torch.spectral import SpectralConsts  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.ops import scan_ops as jscan  # noqa: E402

RTOL = 1e-6


def _energy(rows, bins, seed):
    """Spectral-energy-like rows: a few sharp peaks over a noise floor."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(0.01, (rows, bins))
    for r in range(rows):
        x[r, rng.integers(0, bins, 6)] += rng.uniform(1, 50, 6)
    return x.astype(np.float32)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    err = np.abs(got - ref).max(axis=-1, keepdims=True)
    assert (err <= RTOL * scale).all(), float((err / scale).max())


def _slew(sample_rate):
    return SpectralConsts.for_config(
        StretchConfig.preset_default(2, sample_rate)).slew


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("rate", [8000, 48000])
def test_iir_matches_jax(backward, rate):
    slew = _slew(rate)
    x = _energy(6, 512, rate)
    init = np.random.default_rng(1).uniform(0, 1, 6).astype(np.float32)
    fn = scan_ops.iir_backward if backward else scan_ops.iir_forward
    jfn = jscan.iir_backward if backward else jscan.iir_forward
    y, fin = fn(torch.as_tensor(x), torch.as_tensor(init), slew)
    ry, rfin = jfn(jnp.asarray(x), jnp.asarray(init), np.float32(slew))
    _close(y.numpy(), ry)
    _close(fin.numpy()[:, None], np.asarray(rfin)[:, None])


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_iir_final_is_the_last_value(backward):
    x = torch.as_tensor(_energy(3, 100, 5))
    init = torch.zeros(3)
    y, fin = scan_ops.iir(x, init, 0.3, backward=backward)
    assert torch.equal(fin, y[:, 0] if backward else y[:, -1])
    assert scan_ops.launches == 0         # CPU tensors take the plain loop


def test_iir_is_the_serial_recurrence():
    """The plain loop against a float32 numpy loop in the reference order:
    bit for bit."""
    x = _energy(4, 64, 6)
    slew = np.float32(_slew(8000))
    y, _ = scan_ops.iir_plain(torch.as_tensor(x), torch.zeros(4), float(slew))
    v = np.zeros(4, np.float32)
    want = np.empty_like(x)
    for b in range(x.shape[1]):
        v = (v + (x[:, b] - v) * slew).astype(np.float32)
        want[:, b] = v
    np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("rate", [8000, 48000])
def test_smoothing_chain_matches_jax(rate):
    """The planner's four passes (down, up, down, up, each pass starting
    from the previous pass's last value) against the JAX smoothing."""
    consts = SpectralConsts.for_config(StretchConfig.preset_default(2, rate))
    x = _energy(5, consts.bands, rate + 1)
    sm = torch.as_tensor(x)
    e = torch.zeros(5)
    for _ in range(2):
        sm, e = scan_ops.iir_backward(sm, e, consts.slew)
        sm, e = scan_ops.iir_forward(sm, e, consts.slew)
    ref = np.stack([np.asarray(jspectral._smooth_energy(jnp.asarray(row),
                                                        consts))
                    for row in x])
    _close(sm.numpy(), ref)
