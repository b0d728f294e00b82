"""The port's spectral planner against the JAX package's, on the CPU.

The same spectra (the JAX analysis of the 8 kHz stereo fixture) go through
JAX `plan_spectral` (complex mode, run op by op, gather interpolation as on
the CPU) and the port's `plan_spectral`; the SweepInputs are compared leaf
by leaf, unmapped and mapped (+12 semitones with a tonality limit), on the
fixed-rate schedules and on one whose blocks are mostly not re-analysed,
and mapped at 3 and 4 channels (the fixture with channels added).

Tolerance: reassociation.  Every leaf within 1e-6 of its largest magnitude:
torch and XLA round a complex product's real and imaginary parts in
different orders (the vote coefficients measure up to 3e-7); the energies,
prediction inputs and the max-channel choice measure bit-equal.
"""
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import (convert, engine, planner,  # noqa: E402
                                       stft, tables)
from signalsmith_stretch_torch.config import MAX_CLEAN_STRETCH  # noqa: E402
from signalsmith_stretch_torch.ops import interp  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_tpu import engine as jengine  # noqa: E402
from signalsmith_stretch_tpu import planner as jplanner  # noqa: E402
from signalsmith_stretch_tpu.models import StretchModel as JModel  # noqa: E402

RTOL = 1e-6
# (time ratio, semitones, tonality limit in Hz)
CASES = {
    "1.0": (1.0, 0, 0),
    "1.25": (1.25, 0, 0),
    "0.8": (0.8, 0, 0),
    "1.004": (1.004, 0, 0),
    "pitch+12_1.0": (1.0, 12, 2000),
    "pitch+12_1.25": (1.25, 12, 2000),
    "pitch+12_1.004": (1.004, 12, 2000),
    "pitch-5_1.0": (1.0, -5, 0),
    # above 2x: the randomised regime, JAX's draws from the same seed
    "2.5": (2.5, 0, 0),
    "3.0": (3.0, 0, 0),
    "pitch+2_2.5": (2.5, 2, 2000),
    "pitch-5_3.0": (3.0, -5, 0),
}


def _models(sig, rate, case):
    ratio, semis, ton = CASES[case]
    n = sig.shape[1]
    out = int(round(n * ratio))
    kw = dict(semitones=semis, tonality_hz=ton)
    ch = sig.shape[0]
    return (StretchModel.build(ch, rate, n, out, device="cpu", **kw),
            JModel.build(ch, rate, n, out, **kw))


def _leaves(inp, batch_index=None):
    """SweepInputs -> {name: numpy}."""
    def f(x):
        x = x[batch_index] if batch_index is not None else x
        return np.asarray(x)
    d = {k: f(getattr(inp, k)) for k in ("a1", "a2", "d1", "d2", "mc")}
    for c in range(len(inp.pe)):
        d[f"pe{c}"] = f(inp.pe[c])
        d[f"pi{c}"] = f(inp.pi[c])
    return d


def _close(got, ref, name):
    assert got.shape == ref.shape, name
    if np.iscomplexobj(ref):
        got = np.stack([got.real, got.imag])
        ref = np.stack([ref.real, ref.imag])
    scale = np.abs(ref).max()
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= RTOL * scale, (name, err, scale)


def _plan_both(sig, rate, case, debug=False, engines=None):
    """The JAX and the port's planner on the same spectra, seed 0 (the
    port's default for a batch of one); engines = (JAX random_engine,
    port random_engine) replace the default draws on both sides."""
    model, jm = _models(sig, rate, case)
    jflags, flags = jm.flags, model.flags
    if engines is not None:
        jflags = dataclasses.replace(jflags, random_engine=engines[0])
        flags = dataclasses.replace(flags, random_engine=engines[1])
    js, jp = jengine.analyze_stage(jnp.asarray(sig), jm.plan)
    ref = jplanner.plan_spectral(js, jp, jm.plan.arrays, jm.controls,
                                 jflags, jm.plan.consts, 0, debug=debug)
    got = planner.plan_spectral(
        torch.as_tensor(np.array(js))[None], torch.as_tensor(np.array(jp))[None],
        model.plan.arrays, model.controls, flags, model.plan.consts,
        debug=debug)
    return got, ref, model


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_inputs_match_jax(stereo_signal, case):
    sig, rate = stereo_signal
    got, ref, model = _plan_both(sig, rate, case)
    assert model.flags.mapped == (CASES[case][1] != 0)
    g, r = _leaves(got, 0), _leaves(ref)
    assert g.keys() == r.keys()
    np.testing.assert_array_equal(g["mc"], r["mc"])
    for k in g:
        if k != "mc":
            assert g[k].dtype == r[k].dtype, k
            _close(g[k], r[k], k)


def _midpoint_jax(key, shape, minval, maxval):
    return jnp.broadcast_to((jnp.asarray(minval, jnp.float32)
                             + jnp.asarray(maxval, jnp.float32))
                            * jnp.float32(0.5), shape).astype(jnp.float32)


def _midpoint_torch(key, shape, minval, maxval):
    return ((minval + maxval) * 0.5).expand(shape)


@pytest.mark.parametrize("case", ["3.0", "pitch+2_2.5"])
def test_random_engine_hook_matches_jax(stereo_signal, case):
    """A random_engine (the reference's RandomEngine) injected on both
    sides, every draw at the midpoint of its range, unmapped and mapped:
    the SweepInputs leaf by leaf at the file's tolerance, and not those of
    the default draws."""
    sig, rate = stereo_signal
    got, ref, _ = _plan_both(sig, rate, case,
                             engines=(_midpoint_jax, _midpoint_torch))
    g, r = _leaves(got, 0), _leaves(ref)
    np.testing.assert_array_equal(g["mc"], r["mc"])
    for k in g:
        if k != "mc":
            _close(g[k], r[k], k)
    default = _leaves(_plan_both(sig, rate, case)[0], 0)
    assert not np.array_equal(default["a1"], g["a1"])


@pytest.mark.parametrize("case", ["pitch+12_1.0", "pitch+12_1.25"])
def test_mapped_intermediates_match_jax(stereo_signal, case):
    """Energy, its slew smoothing (kernel C's plain version), and the peaks
    and output map: the prediction positions and their gradients."""
    sig, rate = stereo_signal
    (_, dbg), (_, jdbg), _ = _plan_both(sig, rate, case, debug=True)
    for k in ("energy", "smoothed", "input_bin", "freq_grad"):
        got = dbg[k].numpy().reshape(np.shape(jdbg[k]))
        _close(got, np.asarray(jdbg[k]), k)


@pytest.mark.parametrize("case", ["pitch+12_1.0", "pitch+12_1.25"])
def test_fused_position_sets_match_jax(stereo_signal, case):
    """Kernel G's plain version writes kernel A's three position sets: the
    JAX planner's input_bin, input_bin - tf and input_bin - f32(longv)*tf
    of each block (planner.py:598-601), bit for bit, with its gradient
    beside them."""
    sig, rate = stereo_signal
    (_, dbg), (_, jdbg), model = _plan_both(sig, rate, case, debug=True)
    tf = np.maximum(model.plan.arrays["time_factor"],
                    np.float32(1.0 / MAX_CLEAN_STRETCH)).astype(np.float32)
    ltf = (np.float32(model.plan.consts.long_vertical_step) * tf).astype(
        np.float32)
    base = np.asarray(jdbg["input_bin"])                     # [nB, B]
    want = np.stack([base, base - tf[:, None], base - ltf[:, None]], 1)
    got = dbg["pos"].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(dbg["input_bin"].numpy(), got[:, 0])


def more_channels(sig, channels):
    """The stereo fixture with channels added: channel c >= 2 is channel
    c % 2 rolled by 37*c samples and scaled by 1 - 0.15*c."""
    extra = [np.roll(sig[c % 2], 37 * c) * np.float32(1 - 0.15 * c)
             for c in range(2, channels)]
    return np.concatenate([sig, np.stack(extra)]).astype(np.float32)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("case", ["pitch+12_1.0", "pitch+12_1.25"])
def test_multichannel_mapped_planner_matches_jax(stereo_signal, case,
                                                 channels):
    """The mapped planner at 3 and 4 channels: the cross-channel energy,
    summed in channel order here and by jnp.sum over the channel axis in
    the JAX package, bit-equal; its smoothing, the peaks and output map and
    every SweepInputs leaf at the file's tolerance."""
    sig, rate = stereo_signal
    sig = more_channels(sig, channels)
    (got, dbg), (ref, jdbg), model = _plan_both(sig, rate, case, debug=True)
    assert model.flags.mapped and len(got.pe) == channels
    np.testing.assert_array_equal(
        dbg["energy"].numpy().reshape(np.shape(jdbg["energy"])),
        np.asarray(jdbg["energy"]))
    for k in ("smoothed", "input_bin", "freq_grad"):
        _close(dbg[k].numpy().reshape(np.shape(jdbg[k])), np.asarray(jdbg[k]),
               k)
    g, r = _leaves(got, 0), _leaves(ref)
    assert g.keys() == r.keys()
    np.testing.assert_array_equal(g["mc"], r["mc"])
    for k in g:
        if k != "mc":
            _close(g[k], r[k], k)


def test_planner_is_per_clip(stereo_signal):
    """A batch of two clips plans as each clip alone, bit for bit (the
    mapped path's segment sums included)."""
    sig, rate = stereo_signal
    model, _ = _models(sig, rate, "pitch+12_1.25")
    from signalsmith_stretch_torch import engine
    clips = torch.as_tensor(np.stack([sig, sig[:, ::-1] * 0.7]))
    spectra, prev = engine.analyze_stage(clips, model.plan)
    args = (model.plan.arrays, model.controls, model.flags, model.plan.consts)
    both = _leaves(planner.plan_spectral(spectra, prev, *args))
    for i in range(2):
        one = _leaves(planner.plan_spectral(spectra[i:i + 1], prev[i:i + 1],
                                            *args), 0)
        for k in one:
            np.testing.assert_array_equal(both[k][i], one[k], err_msg=k)


# a render shape for each table of tables.on_device: (time ratio,
# semitones, tonality limit in Hz, preset, channels, input samples); the
# 5x compression reaches the silence bypass's restricted tails
TABLE_RENDERS = {
    "1.25": (1.25, 0, 0, "default", 2, 16000),
    "1.004": (1.004, 0, 0, "default", 2, 16000),
    "pitch+12": (1.25, 12, 2000, "default", 2, 16000),
    "3.0": (3.0, 0, 0, "default", 2, 16000),
    "not_all_new": (1.004, 0, 0, "default", 2, 16000),
    "0.2": (0.2, 0, 0, "cheaper", 1, 32000),
}
TABLES = {
    # name: (render, the plan's table arrays, each (array, derive, args))
    "frame_index": ("1.25", lambda p: [
        (p.arrays["frame_starts"], engine.window_index, ())]),
    "re_rows": ("1.004", lambda p: [(p.re_rows, None, ())]),
    "analysis_plain": ("1.25", lambda p: [(p.basis.window, None, ()),
                                          (p.basis.twist, None, ())]),
    "rotor": ("1.25", lambda p: [(p.consts.rotor, None, ())]),
    "input_chains": ("not_all_new", lambda p: [
        (p.arrays[k], None, ()) for k in (
            "input_idx", "input_valid", "base_idx", "base_keep",
            "reanalyse", "new_spectrum")]),
    "vote_shifts": ("pitch+12", lambda p: [(p.arrays["tf"], None, ()),
                                           (p.arrays["ltf"], None, ())]),
    "shift_taps": ("1.25", lambda p: [
        (p.arrays[k], interp.shift_taps, (p.consts.bands,))
        for k in ("tf", "ltf")]),
    "draw_bounds": ("3.0", lambda p: [
        (p.arrays["tf"], planner.draw_bounds, ())]),
    "wola_weight": ("1.25", lambda p: [(p.weight, None, ())]),
    "synthesis": ("1.25", lambda p: [
        (p.basis.twist, stft.twist_planes, ()),
        (p.basis.window, None, ())]),
    "silence": ("0.2", lambda p: [
        (p.silence.pre_weight, None, ()), (p.silence.pm_weight, None, ()),
        (p.silence.pass_idx, np.asarray, (np.int64,))]),
}
CPU = torch.device("cpu")


def _table_render(name):
    """A model of TABLE_RENDERS[name] on the CPU, its plan (with every
    third block not new for "not_all_new": mostly not re-analysed, it
    takes every gather of the input chains) and a batch of two clips."""
    ratio, semis, ton, preset, ch, n = TABLE_RENDERS[name]
    model = StretchModel.build(ch, 8000, n, int(round(n * ratio)),
                               semitones=semis, tonality_hz=ton,
                               cheaper=preset == "cheaper", device="cpu")
    plan = model.plan
    if name == "not_all_new":
        new = plan.arrays["new_spectrum"].copy()
        new[2::3] = False
        plan = dataclasses.replace(plan, arrays=engine.plan_tables(
            dict(plan.arrays, new_spectrum=new), plan.cfg))
    rng = np.random.default_rng(7)
    clips = torch.as_tensor(rng.standard_normal((2, ch, n)).astype(
        np.float32) * 0.1)
    return model, plan, clips


def _held(plan, tables_of):
    """The owner's copies of the plan's tables, None where it holds none."""
    return [tables._copies.get((id(a), CPU, derive, args))
            for a, derive, args in tables_of(plan)]


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("table", sorted(TABLES))
def test_tables_built_once(table):
    """Each table of a render is one copy per (plan, device), owned by
    tables.on_device: two renders of one plan read the very same tensors;
    another plan of the same shape (copies of its arrays carried across by
    convert) gets tensors of its own, with the same values; and its
    entries are gone once that plan is collected."""
    render, tables_of = TABLES[table]
    model, plan, clips = _table_render(render)

    def run(p):
        return engine.render_exact(clips, p, model.controls, model.flags)

    run(plan)
    first = _held(plan, tables_of)
    assert all(t is not None for t in first)
    run(plan)
    assert all(a is b for a, b in zip(first, _held(plan, tables_of)))
    other = convert.plan_from_arrays({
        k: np.array(v) for k, v in convert.plan_to_arrays(plan).items()})
    run(other)
    theirs = _held(other, tables_of)
    assert all(a is not b and _same(a, b) for a, b in zip(first, theirs))
    keys = [(id(a), CPU, derive, args) for a, derive, args in tables_of(other)]
    del other, theirs
    gc.collect()
    assert not any(k in tables._copies for k in keys)


@pytest.mark.parametrize("render", ["1.25", "pitch+12", "3.0", "0.2"])
def test_prepare_makes_every_table(render):
    """tables.prepare makes every table a render reads: the render after
    it adds none, and a second prepare adds none either."""
    model, plan, clips = _table_render(render)
    tables.prepare(plan, model.controls, model.flags, CPU)
    n = len(tables._copies)
    engine.render_exact(clips, plan, model.controls, model.flags)
    tables.prepare(plan, model.controls, model.flags, CPU)
    assert len(tables._copies) == n



def test_above_twice_stretch_is_not_ported(stereo_signal):
    """Stretches above 2x were once refused; the randomised regime is
    ported now, so a 3x render is finite, of the asked length, and its
    clips' seeds (0 and 1 by default) give different renders of one
    clip."""
    sig, rate = stereo_signal
    n = sig.shape[1]
    model = StretchModel.build(2, rate, n, 3 * n, device="cpu")
    out = model.batched(np.stack([sig, sig]))
    assert out.shape == (2, 2, 3 * n) and bool(torch.isfinite(out).all())
    assert not torch.equal(out[0], out[1])
    assert torch.equal(out[1], model(sig, seed=1))
