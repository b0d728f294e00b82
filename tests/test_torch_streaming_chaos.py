"""Chaotic streams of the port against the JAX package's, on the CPU.

A stretch or a pitch map makes the phase recursion chaotic: a 1-ulp
change of the input moves JAX's own stream by -38 to -77 dB over 2 s
(docs/PARITY.md).  The port's analysis and synthesis FFTs (torch.fft) round
otherwise than JAX's, and its block step rounds apart from JAX's in the
stages before the sweep (tests/test_torch_block.py), so its stream is held
to JAX's relatively: within 12 dB of JAX's own response to a 1-ulp change
of its input, the larger of a change up and one down (the two differ by 8
dB at 1.25x), and band energies within 3 dB.  Measured on the stereo
fixture in 512-sample chunks: 1.25x -64.5 dB against -76.6 (up) and -68.2
(down); +5 semitones -49.0 dB against -39.3 and -38.1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
from test_torch_streaming import _drive, _pair  # noqa: E402

f32 = np.float32
CHAOS_MARGIN_DB = 12.0
BAND_DB = 3.0


def _band_energy_db(x, nbands=24):
    spec = np.abs(np.fft.rfft(x * np.hanning(x.shape[-1]), axis=-1)) ** 2
    edges = np.linspace(0, spec.shape[-1], nbands + 1, dtype=int)
    e = np.stack([spec[..., a:b].sum(-1) for a, b in zip(edges, edges[1:])],
                 -1)
    return 10 * np.log10(e + 1e-20)


@pytest.mark.parametrize("case", ["1.25x", "pitch+5"])
def test_chaotic_streams_within_jax_sensitivity(stereo_signal, case):
    """A 1.25x stretch and a +5 semitone map (a 2 kHz tonality limit, a
    quarter of the rate as 8 kHz is of 32 kHz), seek, 512-sample chunks
    and flush, through the port and JAX; the deterministic region (before
    the flush's randomised tail) gated."""
    sig, rate = stereo_signal
    time_f, semis = (1.25, 0.0) if case == "1.25x" else (1.0, 5.0)
    port, ref, cfg = _pair(2, rate, semitones=semis, tonality=2000 / rate)
    got = np.concatenate(_drive(port, cfg, sig, 512, time_f), 1)
    want = np.concatenate(_drive(ref, cfg, sig, 512, time_f), 1)
    n = sig.shape[1]
    sens = []
    for way in (np.inf, -np.inf):
        ref.reset(1)
        nudged = np.nextafter(sig, way).astype(f32)
        probe = np.concatenate(_drive(ref, cfg, nudged, 512, time_f), 1)
        sens.append(rel_err_db(probe[:, :n], want[:, :n]))
    dev = rel_err_db(got[:, :n], want[:, :n])
    band = np.abs(_band_energy_db(got[:, :n])
                  - _band_energy_db(want[:, :n])).max()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert dev < max(sens) + CHAOS_MARGIN_DB, (dev, sens)
    assert band <= BAND_DB, band
