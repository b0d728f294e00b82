"""Custom frequency maps (`set_freq_map`) in the port against the JAX
package's, on the CPU.

A custom map is an elementwise callable: the port's takes and returns
float32 torch tensors, JAX's the same formula on jnp arrays.  The peaks
map runs it between G's two entries (ops/peaks.peaks_positions_custom:
the runs, the callable on every slot's frequency, the output map), and
the formant targets under pitch compensation run it on the band centres.

Tolerances:
- the +5 semitone, 2 kHz tonality map written as a callable is the
  built-in map's formula, so in the port its planner outputs and its
  render are bit-identical to the built-in map's; against JAX the planner
  outputs hold to tests/test_torch_planner.py's 1e-6 of each leaf's
  largest magnitude (complex products round in another order);
- renders through a custom map are chaotic (a pitch map, a stretch): the
  gate is docs/PARITY.md's chaos-relative one, the port's distance from
  the JAX render within 12 dB of the JAX render's own distance from its
  render of the 1-ulp-nudged input, and band energies within 3 dB; at
  2.5x both draw the same per-bin factors from the same seed.  (The
  polynomial warp at 1.25x measures 8.8 dB past JAX's sensitivity, whose
  one-nudge estimate there, -44.7 dB, lies 9 dB under the port's own,
  -35.7 dB; the other cases measure within 6 dB.);
- G's split plain versions against the one-launch plain version: bit
  equality (the same operations in the same order).
A callable must round as its jnp twin compiles: XLA contracts a multiply
and an add into one fused operation, so the polynomial warp's torch form
rounds its inner multiply-add once (see poly_torch).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from conftest import rel_err_db  # noqa: E402
from test_torch_api import _band_energy_db  # noqa: E402
from test_torch_planner import _close, _leaves  # noqa: E402
from signalsmith_stretch_torch import SignalsmithStretch  # noqa: E402
from signalsmith_stretch_torch import planner, prng, spectral  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch import ops  # noqa: E402
from signalsmith_stretch_torch.ops import peaks  # noqa: E402
from signalsmith_stretch_tpu import api as japi  # noqa: E402
from signalsmith_stretch_tpu import engine as jengine  # noqa: E402
from signalsmith_stretch_tpu import planner as jplanner  # noqa: E402
from signalsmith_stretch_tpu.models import StretchModel as JModel  # noqa: E402

f32 = np.float32
RATE = 8000
SEMITONES, TONALITY_HZ = 5, 2000


def _tonality_constants():
    """The built-in map's float32 constants for +5 semitones with a 2 kHz
    limit at 8 kHz, as set_transpose_semitones computes them: mult, limit
    and above_off = f32(f32(mult - 1) * limit)."""
    s = SignalsmithStretch(device="cpu")
    s.set_transpose_semitones(SEMITONES, TONALITY_HZ / RATE)
    mult, limit = s._freq_multiplier, s._freq_tonality_limit
    return mult, limit, f32((mult - f32(1)) * limit)


MULT, LIMIT, ABOVE_OFF = _tonality_constants()


# the maps, once as torch callables and once as jnp ones (module-level
# functions: JAX keys its compiled renders on the callable)
def tonality_torch(f):
    return torch.where(f > float(LIMIT), f + float(ABOVE_OFF),
                       f * float(MULT))


def tonality_jax(f):
    return jnp.where(f > LIMIT, f + ABOVE_OFF, f * MULT)


def poly_torch(f):
    # XLA on the CPU compiles JAX's 0.8 * f + 0.8 into one fused
    # multiply-add, rounded once: the port's callable rounds it as JAX
    # does (prng.fma_f32).  Rounded twice it differs in the last bit for
    # ~7% of frequencies, and the chaotic recursion turns that into a
    # render 10.4 dB past JAX's 1-ulp sensitivity at 1.25x.
    c = torch.full_like(f, 0.8)
    return f * prng.fma_f32(c, f, c)


def poly_jax(f):
    return f * (0.8 + 0.8 * f)


def power_torch(f):
    return 0.5 * (2 * f) ** 0.9


def power_jax(f):
    return 0.5 * (2 * f) ** 0.9


MAPS = {"tonality": (tonality_torch, tonality_jax),
        "poly": (poly_torch, poly_jax),
        "power": (power_torch, power_jax)}


def _chaos_gate(got, ref_fn, sig, margin_db=12.0):
    """docs/PARITY.md's chaos-relative gate against the JAX render ref_fn
    (sig): within margin_db of its 1-ulp input sensitivity, band energies
    within 3 dB."""
    ref = np.asarray(ref_fn(sig))
    nudged = np.nextafter(sig, np.float32(np.inf)).astype(np.float32)
    sens = rel_err_db(np.asarray(ref_fn(nudged)), ref)
    dev = rel_err_db(got, ref)
    assert got.shape == ref.shape
    assert dev < sens + margin_db, (dev, sens)
    assert np.abs(_band_energy_db(got) - _band_energy_db(ref)).max() <= 3.0


def _pair(setup, map_name=None, seed=0):
    """The port's and the JAX package's objects, set up alike, with the
    named custom map."""
    port = SignalsmithStretch(seed=seed, device="cpu")
    ref = japi.SignalsmithStretch(seed=seed)
    for s, fn in zip((port, ref), MAPS[map_name] if map_name else
                     (None, None)):
        s.preset_default(2, RATE)
        setup(s)
        if fn is not None:
            s.set_freq_map(fn)
    return port, ref


def _none(s):
    pass


# ---------------------------------------------------------------------------
# (a) the built-in map written as a callable
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ratio", [1.0, 1.25])
def test_tonality_callable_planner_matches_builtin_and_jax(stereo_signal,
                                                           ratio):
    """The planner on JAX's analysis of the fixture, with the tonality map
    as a callable: every SweepInputs leaf, the position sets and the
    gradient bit-identical to the built-in map's; against JAX's planner
    with the jnp callable, every leaf within 1e-6 of its largest
    magnitude."""
    sig, rate = stereo_signal
    n = sig.shape[1]
    out = int(round(n * ratio))
    kw = dict(semitones=SEMITONES, tonality_hz=TONALITY_HZ)
    model = StretchModel.build(2, rate, n, out, device="cpu", **kw)
    jm = JModel.build(2, rate, n, out, **kw)
    js, jp = jengine.analyze_stage(jnp.asarray(sig), jm.plan)
    spectra, prev = (torch.as_tensor(np.array(x))[None] for x in (js, jp))
    custom = dataclasses.replace(model.flags, custom_map=tonality_torch)
    (want, wdbg), (got, gdbg) = (
        planner.plan_spectral(spectra, prev, model.plan.arrays,
                              model.controls, f, model.plan.consts,
                              debug=True) for f in (model.flags, custom))
    g, w = _leaves(got, 0), _leaves(want, 0)
    for k in g:
        assert g[k].tobytes() == w[k].tobytes(), k
    for k in ("pos", "freq_grad"):
        assert torch.equal(gdbg[k], wdbg[k]), k
    jflags = dataclasses.replace(jm.flags, custom_map=tonality_jax,
                                 inv_grad_bound=None)
    ref = jplanner.plan_spectral(js, jp, jm.plan.arrays, jm.controls, jflags,
                                 jm.plan.consts, 0)
    r = _leaves(ref)
    np.testing.assert_array_equal(g["mc"], r["mc"])
    for k in g:
        if k != "mc":
            _close(g[k], r[k], k)


def test_tonality_callable_render_matches_builtin_and_jax(stereo_signal):
    """exact() through set_freq_map with the tonality callable: the same
    bits as set_transpose_semitones in the port, and the chaos-relative
    gate against JAX's exact() with the jnp callable."""
    sig, _ = stereo_signal
    n = sig.shape[1]
    builtin = SignalsmithStretch(device="cpu")
    builtin.preset_default(2, RATE)
    builtin.set_transpose_semitones(SEMITONES, TONALITY_HZ / RATE)
    want, _ = builtin.exact(sig, n)
    port, ref = _pair(_none, "tonality")
    got, ok = port.exact(sig, n)
    assert ok and got.tobytes() == want.tobytes()
    _chaos_gate(got, lambda x: ref.exact(x, n)[0], sig)


# ---------------------------------------------------------------------------
# (b) warps no multiplier can express, at 1.0x, 1.25x and 2.5x
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ratio", [1.0, 1.25, 2.5])
@pytest.mark.parametrize("warp", ["poly", "power"])
def test_warp_render_chaos_relative_to_jax(stereo_signal, warp, ratio):
    """A monotone polynomial warp f * (0.8 + 0.8 f) and a power warp
    0.5 (2 f)^0.9: the port's exact() against JAX's, seed 3 (2.5x is the
    mapped randomised regime on the seeded draws)."""
    sig, _ = stereo_signal
    n_out = int(round(sig.shape[1] * ratio))
    port, ref = _pair(_none, warp, seed=3)
    assert port._flags().mapped and port._flags().custom_map is poly_torch \
        if warp == "poly" else port._flags().custom_map is power_torch
    got, ok = port.exact(sig, n_out)
    assert ok
    _chaos_gate(got, lambda x: ref.exact(x, n_out)[0], sig)


# ---------------------------------------------------------------------------
# (c) formant compensation through the custom map
# ---------------------------------------------------------------------------
def _formant_fixed(s):
    s.set_formant_semitones(3, True)
    s.set_formant_base(110 / RATE)


def _formant_auto(s):
    s.set_formant_semitones(3, True)


FORMANT = {"fixed_base": (_formant_fixed, None),
           "estimated_base": (_formant_auto, None),
           "formant_automation": (
               lambda s: s.set_formant_factor(1.0, True),
               dict(formant_semitones=lambda t: 3.0 * t, sample_rate=RATE))}


@pytest.mark.parametrize("case", list(FORMANT))
def test_formant_compensation_chaos_relative_to_jax(stereo_signal, case):
    """Formant compensation with the power warp as the pitch map, at a
    fixed base, at an estimated base and under formant automation (a ramp
    0 to +6 semitones, base estimated): the formant targets through the
    callable, the port's exact() against JAX's."""
    sig, _ = stereo_signal
    n = sig.shape[1]
    setup, auto = FORMANT[case]
    port, ref = _pair(setup, "power")
    flags = port._flags()
    assert flags.process_formants and flags.formant_compensation
    got, ok = port.exact(sig, n, automation=auto)
    assert ok
    _chaos_gate(got, lambda x: ref.exact(x, n, automation=auto)[0], sig)


def test_formant_targets_take_the_callable():
    """Under compensation the formant targets map the band centres through
    the callable (the built-in map as a callable gives the built-in map's
    targets, bit for bit); without compensation they ignore it; the cache
    keys on the callable object itself."""
    model = StretchModel.build(2, RATE, 16000, 16000, device="cpu",
                               semitones=SEMITONES, tonality_hz=TONALITY_HZ,
                               formant_semitones=3, formant_compensation=True)
    B, N = model.plan.consts.bands, model.plan.consts.fft_samples
    cpu = torch.device("cpu")
    want = planner._formant_targets(model.controls, True, B, N, cpu)
    got = planner._formant_targets(model.controls, True, B, N, cpu,
                                   tonality_torch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    warped = planner._formant_targets(model.controls, True, B, N, cpu,
                                      power_torch)
    assert not torch.equal(warped[0], want[0])
    plain = planner._formant_targets(model.controls, False, B, N, cpu)
    assert all(torch.equal(a, b) for a, b in zip(
        planner._formant_targets(model.controls, False, B, N, cpu,
                                 power_torch), plain))

    def fresh(f):           # equal to power_torch, another object
        return power_torch(f)

    again = planner._formant_targets(model.controls, True, B, N, cpu, fresh)
    assert again is not warped
    assert all(torch.equal(a, b) for a, b in zip(again, warped))


# ---------------------------------------------------------------------------
# (d) the setters, (e) the callable's contract
# ---------------------------------------------------------------------------
def test_set_transpose_clears_the_map():
    s = SignalsmithStretch(device="cpu")
    s.preset_default(2, RATE)
    s.set_freq_map(poly_torch)
    assert s._flags().custom_map is poly_torch and s._flags().mapped
    s.set_transpose_semitones(0)
    assert s._flags().custom_map is None and not s._flags().mapped
    s.set_freq_map(poly_torch)
    s.set_transpose_factor(1.5)
    assert s._flags().custom_map is None and s._flags().mapped
    s.set_freq_map(poly_torch)
    plan = s.plan(16000, 16000)
    _, flags = s._automated(plan, dict(formant_semitones=1.0))
    assert flags.custom_map is poly_torch and flags.mapped


def test_convert_refuses_a_custom_map():
    """A custom map is a callable, not state: convert.plan_to_arrays
    refuses flags that hold one rather than drop it."""
    from signalsmith_stretch_torch import convert
    s = SignalsmithStretch(device="cpu")
    s.preset_default(2, RATE)
    s.set_freq_map(poly_torch)
    plan = s.plan(16000, 16000)
    with pytest.raises(ValueError, match="custom frequency map"):
        convert.plan_to_arrays(plan, s._controls(), s._flags())
    s.set_transpose_semitones(3)
    d = convert.plan_to_arrays(plan, s._controls(), s._flags())
    assert convert.controls_from_arrays(d)[1] == s._flags()


@pytest.mark.parametrize("bad", ["float64", "shape", "numpy", "noncontiguous"])
def test_bad_callable_raises(stereo_signal, bad):
    """A callable that returns float64, another shape, a numpy array or a
    strided view raises, naming the callable; nothing is cast or copied."""
    sig, _ = stereo_signal

    def to_float64(f):
        return f.double() * 1.1

    def to_other_shape(f):
        return f.reshape(-1)[:5] * 1.1

    def to_numpy(f):
        return f.numpy() * 1.1

    def to_strided_view(f):
        return torch.stack([f * 1.1, f], -1)[..., 0]

    fn = {"float64": to_float64, "shape": to_other_shape,
          "numpy": to_numpy, "noncontiguous": to_strided_view}[bad]
    s = SignalsmithStretch(device="cpu")
    s.preset_default(2, RATE)
    s.set_freq_map(fn)
    with pytest.raises((TypeError, ValueError), match=fn.__name__):
        s.exact(sig, sig.shape[1])


# ---------------------------------------------------------------------------
# (f) G split around the callable against the one-launch G
# ---------------------------------------------------------------------------
def _nan_outside(f):
    """The tonality map on the valid slots (their frequencies are > 0) and
    NaN on the invalid ones, which hold 0."""
    return torch.where(f > 0, tonality_torch(f),
                       torch.full_like(f, float("nan")))


@pytest.mark.parametrize("fn", [tonality_torch, _nan_outside],
                         ids=["tonality", "nan_in_invalid_slots"])
@pytest.mark.parametrize("B", [512, 1000, 4096])
def test_split_plain_matches_one_launch(B, fn):
    """peaks_positions_custom's plain versions (peak_runs_plain, the
    callable, output_positions_plain) on chip_smoke.peaks_edge_rows(B):
    the four planes bit-equal to the one-launch plain version under the
    built-in map, also where the callable maps the invalid slots to NaN;
    and the CPU wrappers are those plain versions and launch nothing."""
    model = StretchModel.build(2, RATE, 16000, 16000, device="cpu",
                               semitones=SEMITONES, tonality_hz=TONALITY_HZ)
    consts = model.plan.consts
    e, s = (torch.as_tensor(a) for a in chip_smoke.peaks_edge_rows(B))
    rng = np.random.default_rng(B)
    tf = torch.as_tensor(rng.uniform(0.5, 2.0, 7).astype(f32))
    ltf = (tf * 6).contiguous()
    want = peaks.peaks_positions_plain(e, s, tf, ltf, model.controls, consts)
    with ops.plain():
        got = peaks.peaks_positions_custom(e, s, tf, ltf, fn, consts)
    wrapped = peaks.peaks_positions_custom(e, s, tf, ltf, fn, consts)
    for g, w, x in zip(got, want, wrapped):
        assert chip_smoke.same_bits(g, w) and chip_smoke.same_bits(x, w)
    assert peaks.runs_launches == 0 and peaks.out_launches == 0

    peak_in, avg_freq, n_peaks = peaks.peak_runs_plain(e, s, consts)
    nseg = B // 2 + 2
    assert peak_in.shape == avg_freq.shape == (e.shape[0], nseg)
    assert n_peaks.dtype == torch.int32
    invalid = torch.arange(nseg)[None] >= n_peaks[:, None]
    assert not peak_in[invalid].any() and not avg_freq[invalid].any()
    assert bool((avg_freq[~invalid] > 0).all())
    mapped = spectral.map_freq(avg_freq, model.controls)
    mapped = torch.where(invalid, torch.full_like(mapped, float("nan")),
                         mapped)
    out = peaks.output_positions_plain(peak_in, mapped, n_peaks, tf, ltf, B,
                                       consts)
    for o, w in zip(out, want):
        assert chip_smoke.same_bits(o, w)
