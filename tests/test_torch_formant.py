"""The port's formant path against the JAX package's, on the CPU.

Pieces (spectral.py, ops/scan_ops.py, planner.py) and whole renders.
Tolerances:
- the formant maps, the top-3 scan and the peak estimate are bit-equal
  (host float32 and integer arithmetic, a serial scan on both sides);
- the decay scans: the port runs the reference's serial order, JAX a
  log-depth associative scan that reassociates the decayed products: rtol
  2e-6, the tolerance at which JAX pins its own scan against the serial one
  (tests/test_scan_ops.py, whose inputs these are; measured 5.6e-7, and up
  to 1.2e-6 over three other seeds); the decay = inf
  case discards its NaN products the same way on both sides, bit for bit;
- the planner's freqEstimate chains: 1e-6 of their largest magnitude, as
  the slew scan of tests/test_torch_scan.py (measured up to 2.0e-7); the
  envelope within rtol 2e-6 of JAX's scans on the same metric (measured up
  to 1.9e-6, eight passes) and its ratio within 1e-5 (measured up to
  1.8e-6), since the ratio divides two envelopes' rounding;
- renders: formant-only at 1.0x is stable, so the port is held within
  -100 dB of the JAX render (measured -124 dB with a fixed base, -126 dB
  with the estimated base); with a pitch map the recursion is chaotic and
  the gate is the chaos-relative one of tests/test_torch_render.py (within
  6 dB of the JAX render's 1-ulp input sensitivity, measured 2.6 dB further;
  band energies within 3 dB).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
from test_torch_render import _band_energy_db  # noqa: E402
from signalsmith_stretch_torch import engine, planner, spectral  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.ops import scan_ops  # noqa: E402
from signalsmith_stretch_tpu import engine as jengine  # noqa: E402
from signalsmith_stretch_tpu import planner as jplanner  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.models import StretchModel as JModel  # noqa: E402
from signalsmith_stretch_tpu.ops import scan_ops as jscan  # noqa: E402

f32 = np.float32
# the formant cases of tests/test_parity_exact.py:56-58, at 1.0x
CASES = {
    "fixed_base": dict(formant_semitones=3, formant_base_hz=110),
    "auto_base": dict(formant_semitones=4),
    "pitch_comp": dict(semitones=5, tonality_hz=2000, formant_semitones=0.001,
                       formant_compensation=True),
}


def _models(sig, rate, case):
    n = sig.shape[1]
    kw = CASES[case]
    return (StretchModel.build(sig.shape[0], rate, n, n, device="cpu", **kw),
            JModel.build(sig.shape[0], rate, n, n, **kw))


def _jax_controls(controls):
    return jspectral.Controls(*[jnp.float32(v) for v in controls])


@pytest.mark.parametrize("case", list(CASES))
def test_formant_maps_match_jax(stereo_signal, case):
    """map_freq and inv_map_formant on the band centres, and the target
    bands the envelope lookup reads: bit for bit."""
    sig, rate = stereo_signal
    model, jm = _models(sig, rate, case)
    assert model.controls == tuple(np.asarray(v) for v in jm.controls)
    consts = model.plan.consts
    freq = consts.band_freq
    jc = _jax_controls(model.controls)
    got = spectral.map_freq(torch.as_tensor(freq), model.controls)
    ref = jspectral.map_freq(jnp.asarray(freq), jc, jm.flags)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        spectral.inv_map_formant(got, model.controls).numpy(),
        np.asarray(jspectral.inv_map_formant(ref, jc)))
    lo, hi, frac, below = planner._formant_targets(
        model.controls, model.flags.formant_compensation, consts.bands,
        consts.fft_samples, torch.device("cpu"))
    out_f = ref if model.flags.formant_compensation else jnp.asarray(freq)
    target = jspectral._freq_to_band(jspectral.inv_map_formant(out_f, jc),
                                     consts)
    tb = jnp.minimum(target, f32(consts.bands))
    fl = jnp.floor(tb).astype(jnp.int32)
    B = consts.bands
    np.testing.assert_array_equal(lo.numpy(), np.clip(fl, 0, B + 1))
    np.testing.assert_array_equal(hi.numpy(), np.clip(fl + 1, 0, B + 1))
    np.testing.assert_array_equal(frac.numpy(),
                                  np.asarray(tb - fl.astype(jnp.float32)))
    np.testing.assert_array_equal(below.numpy(), np.asarray(target < 0))


def _metric_rows(seed, rows=12, bins=300):
    """Energy-like rows with peaks, plus rows of ties, an all-zero row and a
    constant row."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(0.01, (rows, bins)).astype(f32)
    for r in range(rows):
        m[r, rng.integers(1, bins - 1, 8)] += rng.uniform(0.5, 5, 8)
    m[1] = np.round(m[1] * 4) / 4          # plateaus: equal neighbours
    m[2, 10:20] = m[2, 40:50] = 3.0        # equal peaks
    m[3] = 0                               # silent block
    m[4] = 1.5
    return m


def test_top3_local_maxima_matches_jax():
    m = _metric_rows(5)
    got = scan_ops.top3_local_maxima(torch.as_tensor(m))
    ref = jspectral._top3_local_maxima(jnp.asarray(m))
    assert scan_ops.top3_launches == 0      # CPU tensors take the plain loop
    for g, r, dt in zip(got, ref, (torch.int32, torch.float32) * 3):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not got[0][3].any() and not got[4][3].any()   # all-zero row


def test_peak_estimate_matches_jax():
    """The harmonic heuristic on random states and on the states of the
    metric rows: bit for bit, integer floor division and remainder."""
    rng = np.random.default_rng(6)
    n = 4000
    idx = [rng.integers(0, 4096, n).astype(np.int32) for _ in range(3)]
    val = [rng.uniform(0, 1, n).astype(f32) for _ in range(3)]
    val[2][::7] = 0
    state = [idx[0], val[0], idx[1], val[1], idx[2], val[2]]
    top3 = jspectral._top3_local_maxima(jnp.asarray(_metric_rows(7)))
    for st in (state, [np.asarray(v) for v in top3]):
        got = spectral._peak_estimate(*[torch.as_tensor(np.array(v))
                                        for v in st])
        ref = jspectral._peak_estimate(*[jnp.asarray(v) for v in st])
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_decay_scans_match_jax(op, backward):
    """Per-row coefficients and initial values, against JAX's associative
    scan: rtol 2e-6, on the inputs of tests/test_scan_ops.py (values in
    [0.01, 2], decay near 0.97: the chains of decayed products stay short,
    as they do for the envelope, whose decay is 1 - 1/(f*0.5 + 1) for a
    pitch of f bins)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.01, 2.0, (6, 257)).astype(f32)
    init = np.full(6, 0.5, f32)
    decay = np.array([0.97, 0.97, 0.97, 0.9, 0.93, 0.95], f32)
    coef = decay if op == "max" else (f32(1) / decay).astype(f32)
    y, fin = scan_ops.decay(torch.as_tensor(x), torch.as_tensor(init),
                            torch.as_tensor(coef), op == "min", backward)
    name = f"decay_{op}_{'backward' if backward else 'forward'}"
    ry, rfin = getattr(jscan, name)(jnp.asarray(x), jnp.asarray(init),
                                    jnp.asarray(coef))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=2e-6)
    np.testing.assert_allclose(fin.numpy(), np.asarray(rfin), rtol=2e-6)
    assert torch.equal(fin, y[:, 0] if backward else y[:, -1])


def test_decay_inf_discards_nan():
    """decay = inf on a silent row: every inf*0 product is NaN and the C++
    selection keeps the other operand, as JAX's _cpp_min/_cpp_max do."""
    x = torch.zeros(2, 64)
    init = torch.tensor([0.0, 1.5])
    coef = torch.full((2,), np.inf)
    for is_min, jfn in ((True, jscan.decay_min_forward),
                        (False, jscan.decay_max_forward)):
        y, fin = scan_ops.decay(x, init, coef, is_min)
        assert not torch.isnan(y).any()
        for r in range(2):
            ry, rfin = jfn(x[r].numpy(), f32(init[r]), f32(np.inf))
            if is_min:
                np.testing.assert_array_equal(y[r].numpy(), np.asarray(ry))
                assert float(fin[r]) == float(rfin) == 0.0
    assert scan_ops.decay_launches == 0


def test_decay_chain_plain_matches_jax():
    """The envelope's eight passes (max backward/forward twice with the
    decay, then min with its inverse, each from the previous pass's last
    value) as decay_chain_plain runs them, against the JAX passes: rtol
    2e-6 as the single passes; a silent row (decay 0, inverse inf, every
    min product NaN and discarded) bit for bit.  On the CPU the wrapper is
    the plain chain, bit for bit."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0.01, 2.0, (7, 257)).astype(f32)
    x[3] = 0                                  # a silent row
    decay = rng.uniform(0.9, 0.99, 7).astype(f32)
    decay[3] = 0
    with np.errstate(divide="ignore"):
        inv = (f32(1) / decay).astype(f32)    # inf on row 3
    dt, it = torch.as_tensor(decay), torch.as_tensor(inv)
    passes = [(c, m, b) for c, m in ((dt, False), (it, True))
              for _ in range(2) for b in (True, False)]
    init = torch.zeros(7)
    y, fin = scan_ops.decay_chain_plain(torch.as_tensor(x), init, passes)
    ry, rfin = jnp.asarray(x), jnp.zeros(7, jnp.float32)
    for name, coef in (("max", decay), ("min", inv)):
        for _ in range(2):
            for d in ("backward", "forward"):
                ry, rfin = getattr(jscan, f"decay_{name}_{d}")(
                    ry, rfin, jnp.asarray(coef))
    ry, rfin = np.asarray(ry), np.asarray(rfin)
    assert not torch.isnan(y).any()
    np.testing.assert_allclose(y.numpy(), ry, rtol=2e-6)
    np.testing.assert_allclose(fin.numpy(), rfin, rtol=2e-6)
    np.testing.assert_array_equal(y[3].numpy(), ry[3])
    assert float(fin[3]) == float(rfin[3]) == 0.0
    y2, fin2 = scan_ops.decay_chain(torch.as_tensor(x), init, passes)
    assert torch.equal(y2, y) and torch.equal(fin2, fin)
    assert scan_ops.decay_launches == 0


def test_decay_chain_walk_model_matches_plain():
    """The chain kernel's walk (tests/test_torch_scan.walk_model) with the
    envelope's eight passes and their flags, at ragged R and B, bit-equal to
    decay_chain_plain, the silent row's NaN products discarded."""
    from test_torch_scan import walk_model
    rng = np.random.default_rng(9)
    R, B = 37, 335
    x = rng.exponential(0.5, (R, B)).astype(f32)
    x[5] = 0
    decay = rng.uniform(0.8, 0.99, R).astype(f32)
    decay[5] = 0
    dt = torch.as_tensor(decay)
    it = 1 / dt
    passes = [(c, m, b) for c, m in ((dt, False), (it, True))
              for _ in range(2) for b in (True, False)]
    flags = [scan_ops.BACKWARD * b + scan_ops.MIN * m
             + scan_ops.COEF1 * (c is it) for c, m, b in passes]

    def step(p, v, col):
        coef, is_min, _ = passes[p]
        t = coef * v
        return torch.where(t < col, t, col) if is_min \
            else torch.where(col < t, t, col)

    init = torch.as_tensor(rng.uniform(0, 1, R).astype(f32))
    y, fin, _ = walk_model(torch.as_tensor(x), init, flags, step, 128)
    yp, finp = scan_ops.decay_chain_plain(torch.as_tensor(x), init, passes)
    assert torch.equal(y, yp) and torch.equal(fin, finp)
    assert not torch.isnan(y).any()


def _plan_both(sig, rate, case):
    model, jm = _models(sig, rate, case)
    js, jp = jengine.analyze_stage(jnp.asarray(sig), jm.plan)
    _, jdbg = jplanner.plan_spectral(js, jp, jm.plan.arrays, jm.controls,
                                     jm.flags, jm.plan.consts, 0, debug=True)
    _, dbg = planner.plan_spectral(
        torch.as_tensor(np.array(js))[None],
        torch.as_tensor(np.array(jp))[None], model.plan.arrays,
        model.controls, model.flags, model.plan.consts, debug=True)
    return dbg, jdbg, model, jm


@pytest.mark.parametrize("case", ["auto_base", "pitch_comp"])
def test_freq_estimate_matches_jax(stereo_signal, case):
    """freqEstimateWeighted and its weight over blocks (the top-3 scan, the
    heuristic and two slew chains) against JAX's debug intermediates."""
    sig, rate = stereo_signal
    dbg, jdbg, model, _ = _plan_both(sig, rate, case)
    assert model.flags.formant_auto
    for k in ("freq_estimate_weighted", "freq_weight"):
        got = dbg[k][0].numpy().astype(np.float64)
        ref = np.asarray(jdbg[k])
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), k


@pytest.mark.parametrize("case", list(CASES))
def test_envelope_and_ratio_match_jax(stereo_signal, case):
    """The port's envelope and ratio against JAX's scan and map functions
    run on the port's own metric and decay (planner.py:407-477 of the JAX
    package, its clipped-take lookup)."""
    sig, rate = stereo_signal
    dbg, _, model, jm = _plan_both(sig, rate, case)
    metric = jnp.asarray(dbg["metric"].numpy())
    c, flags = model.controls, jm.flags
    consts = model.plan.consts
    decay = jnp.asarray((1 - 1 / (dbg["freq_estimate"] * 0.5 + 1)).numpy())
    env = metric
    e = jnp.zeros(metric.shape[0], jnp.float32)
    for _ in range(2):
        env, e = jscan.decay_max_backward(env, e, decay)
        env, e = jscan.decay_max_forward(env, e, decay)
    for _ in range(2):
        env, e = jscan.decay_min_backward(env, e, 1 / decay)
        env, e = jscan.decay_min_forward(env, e, 1 / decay)
    B = consts.bands
    jc = _jax_controls(c)
    f = jnp.asarray(consts.band_freq)
    out_f = jspectral.map_freq(f, jc, flags) if flags.formant_compensation \
        else f
    target = jspectral._freq_to_band(jspectral.inv_map_formant(out_f, jc),
                                     consts)
    tb = jnp.minimum(target, f32(B))
    fl = jnp.floor(tb).astype(jnp.int32)
    env_pad = jnp.concatenate([env, jnp.zeros((env.shape[0], 128))], -1)
    lo = jnp.take(env_pad, jnp.clip(fl, 0, B + 1), axis=-1)
    hi = jnp.take(env_pad, jnp.clip(fl + 1, 0, B + 1), axis=-1)
    target_e = jnp.where(target < 0, f32(0),
                         lo + (hi - lo) * (tb - fl.astype(jnp.float32)))
    ratio = target_e / (env + f32(1e-30))
    np.testing.assert_allclose(dbg["env"].numpy(), np.asarray(env), rtol=2e-6)
    np.testing.assert_allclose(dbg["ratio"].numpy(), np.asarray(ratio),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["fixed_base", "auto_base"])
def test_formant_render_matches_jax(stereo_signal, case):
    sig, rate = stereo_signal
    model, jm = _models(sig, rate, case)
    assert model.flags.process_formants and not model.flags.mapped
    got = model(sig).numpy()
    ref = np.asarray(jax.jit(jm.__call__)(jnp.asarray(sig)))
    assert got.shape == ref.shape == sig.shape
    assert rel_err_db(got, ref) < -100


@pytest.mark.parametrize("part", ["freq_estimate", "render"])
def test_three_channel_auto_base_matches_jax(stereo_signal, part):
    """The auto-base formant path at 3 channels (the fixture with a third
    channel made from it): the freqEstimate chains at 1e-6 of their largest
    magnitude, the render within -100 dB of JAX's."""
    from test_torch_planner import more_channels
    sig, rate = stereo_signal
    sig = more_channels(sig, 3)
    if part == "freq_estimate":
        dbg, jdbg, model, _ = _plan_both(sig, rate, "auto_base")
        assert model.flags.formant_auto and model.plan.consts.channels == 3
        for k in ("freq_estimate_weighted", "freq_weight"):
            got = dbg[k][0].numpy().astype(np.float64)
            ref = np.asarray(jdbg[k])
            assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), k
    else:
        model, jm = _models(sig, rate, "auto_base")
        got = model(sig).numpy()
        ref = np.asarray(jax.jit(jm.__call__)(jnp.asarray(sig)))
        assert got.shape == ref.shape == sig.shape
        assert rel_err_db(got, ref) < -100


def test_formant_pitch_render_chaos_relative(stereo_signal):
    sig, rate = stereo_signal
    model, jm = _models(sig, rate, "pitch_comp")
    assert model.flags.mapped and model.flags.process_formants
    got = model(sig).numpy()
    fn = jax.jit(jm.__call__)
    nudged = np.nextafter(sig, np.float32(np.inf)).astype(np.float32)
    ref, ref_nudged = (np.asarray(fn(jnp.asarray(x))) for x in (sig, nudged))
    sens, dev = rel_err_db(ref_nudged, ref), rel_err_db(got, ref)
    assert dev < sens + 6.0, (dev, sens)
    assert np.abs(_band_energy_db(got) - _band_energy_db(ref)).max() <= 3.0


def test_silent_leading_formant_render_is_finite():
    """Silent leading blocks drive the pitch estimate to 0 and the inverse
    decay to inf: the envelope and its ratio carry no NaN into the planner,
    and the render is finite."""
    rate = 8000
    t = np.arange(2 * rate) / rate
    x = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(f32)
    x[:rate // 2] = 0
    sig = np.stack([x, 0.8 * x])
    n = sig.shape[1]
    model = StretchModel.build(2, rate, n, n, semitones=4,
                               formant_compensation=True, device="cpu")
    assert model.flags.process_formants and model.flags.formant_auto
    spectra, prev = engine.analyze_stage(torch.as_tensor(sig)[None],
                                         model.plan)
    _, dbg = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                   model.controls, model.flags,
                                   model.plan.consts, debug=True)
    assert (dbg["freq_estimate"] == 0).any()      # decay 0, inverse inf
    assert not torch.isnan(dbg["env"]).any()
    assert not torch.isnan(dbg["ratio"]).any()
    out = model(sig).numpy()
    assert np.isfinite(out).all() and np.abs(out).max() > 0.1


def test_formant_build_flags():
    """StretchModel.build computes the formant controls and flags as the
    JAX builder does."""
    for kw in list(CASES.values()) + [dict(semitones=3), dict(
            formant_compensation=True)]:
        model = StretchModel.build(2, 48000, 96000, 96000, device="cpu", **kw)
        jm = JModel.build(2, 48000, 96000, 96000, **kw)
        assert model.controls == tuple(np.asarray(v) for v in jm.controls)
        for k in ("mapped", "process_formants", "formant_compensation",
                  "formant_auto"):
            assert getattr(model.flags, k) == getattr(jm.flags, k), (kw, k)
