"""The port's analysis and synthesis stages against the JAX package's, on the
CPU.

Both packages compute the modified real FFT (half-bin twist) with an FFT
library (torch.fft here, jnp.fft there), whose algorithms round
differently.  Tolerances: frame gathers, windows and the silence bypass's
passthrough are bit-equal; spectra agree to 1e-6 of their largest magnitude
(measured about 2e-7) and synthesised audio to 1e-6 of its largest sample
(measured about 3e-7).  The JAX stages run op by op on the CPU, in their
complex64 (not plane-pair) form.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import engine, stft  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_tpu import engine as jengine  # noqa: E402
from signalsmith_stretch_tpu import stft as jstft  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa: E402

RTOL = 1e-6
RATIOS = {"1.0": 1.0, "1.25": 1.25, "0.8": 0.8, "1.004": 1.004}


def _plans(channels, n_in, ratio, preset="preset_default", split=False):
    n_out = int(round(n_in * ratio))
    cfg = getattr(StretchConfig, preset)(channels, 8000, split)
    jcfg = getattr(JConfig, preset)(channels, 8000, split)
    return (engine.build_exact_plan(cfg, n_in, n_out),
            jengine.build_exact_plan(jcfg, n_in, n_out))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if np.iscomplexobj(ref):
        got = np.stack([got.real, got.imag])
        ref = np.stack([ref.real, ref.imag])
    scale = np.abs(ref).max()
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("preset", ["preset_default", "preset_cheaper"])
def test_basis_matches_jax(preset):
    """Window, twist, band centres and the WOLA weight: bit for bit."""
    cfg = getattr(StretchConfig, preset)(2, 8000)
    jcfg = getattr(JConfig, preset)(2, 8000)
    basis = stft.StftBasis.for_config(cfg)
    jbasis = jstft.StftBasis.for_config(jcfg)
    for k in ("window", "twist"):
        a, b = getattr(basis, k), getattr(jbasis, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(stft.band_freqs(basis),
                                  jstft.band_freqs(jbasis))
    pos = np.arange(0, 20 * cfg.interval_samples, cfg.interval_samples)
    np.testing.assert_array_equal(stft.wola_weight(basis, 9000, pos),
                                  jstft.wola_weight(jbasis, 9000, pos))


@pytest.mark.parametrize("ratio", sorted(RATIOS))
def test_gather_frames_matches_jax(stereo_signal, ratio):
    sig, _ = stereo_signal
    plan, jplan = _plans(2, sig.shape[1], RATIOS[ratio])
    timeline = engine._build_timeline(torch.as_tensor(sig)[None], plan)
    jtimeline = jengine._build_timeline(jnp.asarray(sig), jplan)
    np.testing.assert_array_equal(timeline[0].numpy(), np.asarray(jtimeline))
    for idx in (plan.frame_idx, plan.re_frame_idx):
        got = engine.gather_frames(timeline, idx[:, 0],
                                   plan.cfg.block_samples)[0]
        ref = jengine.gather_frames(jtimeline, idx, plan.cfg.block_samples)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ratio", sorted(RATIOS))
def test_analysis_matches_jax(stereo_signal, ratio):
    """Spectra and the re-analysis one interval back (zero outside re_rows)
    against engine.analyze_stage(pair=False)."""
    sig, _ = stereo_signal
    plan, jplan = _plans(2, sig.shape[1], RATIOS[ratio])
    spectra, prev = engine.analyze_stage(torch.as_tensor(sig)[None], plan)
    jspectra, jprev = jengine.analyze_stage(jnp.asarray(sig), jplan,
                                            pair=False)
    _close(spectra[0].numpy(), jspectra)
    _close(prev[0].numpy(), jprev)
    others = np.setdiff1d(np.arange(plan.frame_idx.shape[0]), plan.re_rows)
    assert not prev[0, others].any() and not np.asarray(jprev)[others].any()
    if ratio == "1.004":
        assert 0 < len(plan.re_rows) < plan.frame_idx.shape[0]


def test_analysis_is_per_clip(stereo_signal):
    """A batch of clips analyses as each clip alone, bit for bit."""
    sig, _ = stereo_signal
    plan, _ = _plans(2, sig.shape[1], 1.25)
    clips = torch.as_tensor(np.stack([sig, sig[::-1] * 0.5]))
    both = engine.analyze_stage(clips, plan)
    for i in range(2):
        one = engine.analyze_stage(clips[i:i + 1], plan)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b[0])


def _spectra(plan, seed=0):
    rng = np.random.default_rng(seed)
    shape = (plan.cfg.channels, plan.frame_idx.shape[0], plan.consts.bands)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("ratio", sorted(RATIOS))
def test_synthesis_matches_jax(stereo_signal, ratio):
    """The same spectral planes through both synthesis stages."""
    sig, _ = stereo_signal
    plan, jplan = _plans(2, sig.shape[1], RATIOS[ratio])
    spec = _spectra(plan)
    got = engine.synthesis_stage(torch.as_tensor(spec)[None], plan,
                                 audio=torch.as_tensor(sig)[None])[0]
    ref = jengine.synthesis_stage((jnp.asarray(spec.real),
                                   jnp.asarray(spec.imag)), jplan,
                                  audio=jnp.asarray(sig))
    assert got.shape[-1] == plan.sched.out_samples
    _close(got.numpy(), ref)


@pytest.mark.parametrize("ratio", [0.2, 1.25])
def test_synthesis_silence_bypass_matches_jax(ratio):
    """Sub-noise-floor input (tests/test_silence_exact.py's clips): at 0.2x
    the main process bypasses and emits a passthrough of the input, at 1.25x
    the flush bypasses and emits zeros.  The bypassed regions are bit-equal,
    the rest within the FFT tolerance."""
    rng = np.random.default_rng(11 if ratio > 1 else 12)
    n = (2 if ratio > 1 else 4) * 8000
    sig = (1e-10 * rng.standard_normal((1, n))).astype(np.float32)
    plan, jplan = _plans(1, n, ratio, preset="preset_cheaper")
    sch = plan.sched
    spec = _spectra(plan, 3)
    got = engine.synthesis_stage(torch.as_tensor(spec)[None], plan,
                                 audio=torch.as_tensor(sig)[None])[0].numpy()
    ref = np.asarray(jengine.synthesis_stage(
        (jnp.asarray(spec.real), jnp.asarray(spec.imag)), jplan,
        audio=jnp.asarray(sig)))
    main, flush = slice(0, sch.main_out), slice(
        sch.main_out, sch.main_out + sch.flush_block_out)
    if ratio < 1:
        assert plan.silence.main_possible
        want = sig[:, plan.silence.pass_idx]
        np.testing.assert_array_equal(got[:, main], want)
        np.testing.assert_array_equal(ref[:, main], want)
    else:
        assert sch.flush_block_out > 0
        assert not got[:, flush].any() and not ref[:, flush].any()
    _close(got, ref)
