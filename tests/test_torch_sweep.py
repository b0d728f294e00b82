"""The port's diagonal sweep (wavefront.py) against the JAX package's, on the
CPU.

The same SweepInputs (the port's planner on the 8 kHz stereo fixture) go
through JAX `_sweep_unskew_fn` (a lax.scan over skewed diagonals, complex
cells on the CPU) and the port's plain sweep, the loop over diagonals that
the card's kernel (csrc/sweep.cu) is held to in tests/test_torch_cuda.py.

Tolerances.  The cell's makeOutput is bit-equal to JAX's run op by op.  The
compiled JAX scan rounds the complex vote products in its own order, and
the phase recursion is chaotic under stretching and pitch maps: at 1.0x it
stays within 1e-5 of the largest output (measured 4e-7); elsewhere the gate
is chaos-relative (docs/PARITY.md), the port within 6 dB of the JAX sweep's
own response to a 1-ulp change of the four vote coefficients, the operands
whose products the two round differently (measured: the port 0.7 dB
closer at 1.25x, 2.6 dB further at +12 semitones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
from signalsmith_stretch_torch import engine, planner, wavefront  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_tpu import wavefront as jwavefront  # noqa: E402

CASES = {"1.0": (1.0, 0), "1.25": (1.25, 0), "pitch+12": (1.0, 12),
         "pitch+12_1.25": (1.25, 12)}


def _inputs(sig, rate, case):
    ratio, semis = CASES[case]
    n = sig.shape[1]
    model = StretchModel.build(2, rate, n, int(round(n * ratio)),
                               semitones=semis, tonality_hz=2000,
                               device="cpu")
    spectra, prev = engine.analyze_stage(torch.as_tensor(sig)[None],
                                         model.plan)
    inp = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                model.controls, model.flags, model.plan.consts)
    return inp, model


def _jax_sweep(inp, model):
    """The JAX sweep of clip 0 of the port's inputs -> [ch, nB, B]."""
    consts = model.plan.consts
    fn = jwavefront._sweep_unskew_fn(consts.long_vertical_step, len(inp.pe),
                                     not model.flags.mapped, consts.bands, 8)
    j = jwavefront.SweepInputs(
        *[jnp.asarray(getattr(inp, k)[0].numpy())
          for k in ("a1", "a2", "d1", "d2", "mc")],
        pe=tuple(jnp.asarray(p[0].numpy()) for p in inp.pe),
        pi=tuple(jnp.asarray(p[0].numpy()) for p in inp.pi))
    return np.asarray(jax.jit(fn)(j))


def _ri(z):
    z = np.asarray(z)
    return np.stack([z.real, z.imag])


def test_skew_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 31, 2)).astype(np.float32)   # [nB, B, P]
    t = torch.as_tensor(x).permute(2, 0, 1)                   # [P, nB, B]
    for step in (1, 3, 5, 7):
        s = wavefront._skew(t, step)
        np.testing.assert_array_equal(
            s.permute(1, 2, 0).numpy(), np.asarray(jwavefront.skew(
                jnp.asarray(x), step)))
        assert torch.equal(wavefront._unskew(s, step, 31), t)


def test_make_output_matches_jax():
    """makeOutput on planes, strong and weak (|phase|^2 <= noise floor)
    phases and zero energies: bit-equal to JAX's plane form and to its
    complex form, both run op by op."""
    rng = np.random.default_rng(1)
    n = 4096
    pe = rng.uniform(0, 3, n).astype(np.float32)
    pe[:50] = 0
    pi = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    ph = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    ph[100:400] *= np.float32(1e-9)          # weak: falls back to the input
    ph[400:450] = 0
    got = wavefront._make_output_pair(*[torch.as_tensor(v) for v in (
        pe, pi.real, pi.imag, ph.real, ph.imag)])
    ref = jwavefront._make_output_pair(*[jnp.asarray(v) for v in (
        pe, pi.real, pi.imag, ph.real, ph.imag)])
    refc = jwavefront._make_output(jnp.asarray(pe), jnp.asarray(pi),
                                   jnp.asarray(ph))
    for g, r, rc in zip(got, ref, (np.real(refc), np.imag(refc))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(rc))


def test_sweep_identity_matches_jax(stereo_signal):
    sig, rate = stereo_signal
    inp, model = _inputs(sig, rate, "1.0")
    got = wavefront.sweep_plain(inp, model.plan.consts.long_vertical_step)[0]
    ref = _jax_sweep(inp, model)
    assert got.shape == ref.shape
    err = np.abs(_ri(got) - _ri(ref)).max()
    assert err <= 1e-5 * np.abs(_ri(ref)).max(), err


@pytest.mark.parametrize("case", ["1.25", "pitch+12", "pitch+12_1.25"])
def test_sweep_chaos_relative_to_jax(stereo_signal, case):
    sig, rate = stereo_signal
    inp, model = _inputs(sig, rate, case)
    got = wavefront.sweep_plain(inp, model.plan.consts.long_vertical_step)[0]
    ref = _jax_sweep(inp, model)

    def nudge(z):
        up = [torch.nextafter(x, torch.full_like(x, np.inf))
              for x in (z.real, z.imag)]
        return torch.complex(*up)

    nudged = inp._replace(a1=nudge(inp.a1), a2=nudge(inp.a2),
                          d1=nudge(inp.d1), d2=nudge(inp.d2))
    sens = rel_err_db(_ri(_jax_sweep(nudged, model)), _ri(ref))
    dev = rel_err_db(_ri(got), _ri(ref))
    assert dev < sens + 6.0, (dev, sens)


def test_sweep_on_cpu_is_plain_and_per_clip(stereo_signal):
    """The wrapper takes the plain version on CPU tensors and launches
    nothing; a batch of two clips sweeps as each clip alone, bit for bit."""
    sig, rate = stereo_signal
    one, model = _inputs(sig, rate, "pitch+12")
    two, _ = _inputs(sig[:, ::-1].copy(), rate, "pitch+12")
    both = planner.SweepInputs(*[torch.cat([a, b]) if torch.is_tensor(a)
                                 else tuple(torch.cat([x, y])
                                            for x, y in zip(a, b))
                                 for a, b in zip(one, two)])
    longv = model.plan.consts.long_vertical_step
    out = wavefront.sweep(both, longv)
    assert wavefront.launches == 0
    assert torch.equal(out[:1], wavefront.sweep_plain(one, longv))
    assert torch.equal(out[1:], wavefront.sweep_plain(two, longv))
