"""The port's library object (`SignalsmithStretch`) against the JAX
package's, on the CPU.

Tolerances, as tests/test_torch_render.py states them: at 1.0x the phase
recursion is stable and the port's render is held within -100 dB of the
JAX render.  A stretch, a pitch map or a formant shift makes it chaotic,
so there the gate is chaos-relative: the port's distance from the JAX
render within 6 dB of the JAX render's own distance from its render of the
1-ulp-nudged input, and the band energies within 3 dB.  Above 2x both
packages draw the same per-bin factors from the same seed
(tests/test_torch_prng.py).  Within the port, constant automation is held
bit-equal to the setters and SST_SILENCE=0 bit-equal to the normal path
on a loud clip: one package, no compile-to-compile variance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
from signalsmith_stretch_torch import SignalsmithStretch, engine  # noqa: E402
from signalsmith_stretch_tpu import api as japi  # noqa: E402

RATE = 8000


def _band_energy_db(x, nbands=24):
    spec = np.abs(np.fft.rfft(x * np.hanning(x.shape[-1]), axis=-1)) ** 2
    edges = np.linspace(0, spec.shape[-1], nbands + 1, dtype=int)
    e = np.stack([spec[..., a:b].sum(-1) for a, b in zip(edges, edges[1:])],
                 -1)
    return 10 * np.log10(e + 1e-20)


def _pair(setup, seed=0):
    """The port's and the JAX package's objects, set up alike."""
    port = SignalsmithStretch(seed=seed, device="cpu")
    ref = japi.SignalsmithStretch(seed=seed)
    for s in (port, ref):
        setup(s)
    return port, ref


def _default(channels):
    return lambda s: s.preset_default(channels, RATE)


def test_latencies_and_seek_lengths_match_jax():
    setups = [lambda s: s.preset_default(2, 48000),
              lambda s: s.preset_cheaper(1, 44100),
              lambda s: s.configure(2, 1000, 250, True),
              lambda s: s.configure(3, 777, 300)]
    for setup in setups:
        port, ref = _pair(setup)
        for name in ("block_samples", "interval_samples", "split_computation",
                     "input_latency", "output_latency", "seek_length"):
            assert getattr(port, name)() == getattr(ref, name)(), name
        for rate in (0.5, 1.0, 1.3, 2.75):
            assert port.output_seek_length(rate) == \
                ref.output_seek_length(rate)


def test_exact_identity_matches_jax(stereo_signal):
    sig, _ = stereo_signal
    port, ref = _pair(_default(2))
    got, ok = port.exact(sig, sig.shape[1])
    want, jok = ref.exact(sig, sig.shape[1])
    assert ok and jok and got.dtype == np.float32
    assert got.shape == want.shape == sig.shape
    assert rel_err_db(got, np.asarray(want)) < -100


def _chaos_gate(got, ref_fn, sig):
    ref = np.asarray(ref_fn(sig))
    nudged = np.nextafter(sig, np.float32(np.inf)).astype(np.float32)
    sens = rel_err_db(np.asarray(ref_fn(nudged)), ref)
    dev = rel_err_db(got, ref)
    assert got.shape == ref.shape
    assert dev < sens + 6.0, (dev, sens)
    assert np.abs(_band_energy_db(got) - _band_energy_db(ref)).max() <= 3.0


def _pitch4(s):
    s.preset_default(2, RATE)
    s.set_transpose_semitones(4, 2000 / RATE)


def _formant(s):
    s.preset_default(2, RATE)
    s.set_transpose_semitones(2, 3000 / RATE)
    s.set_formant_semitones(3, True)


EXACT = {
    "1.25x": (1.25, _default(2)),
    "pitch+4": (1.0, _pitch4),
    "formant+3_comp_auto": (1.0, _formant),
    "3x": (3.0, _default(2)),
}


@pytest.mark.parametrize("case", list(EXACT))
def test_exact_chaos_relative_to_jax(stereo_signal, case):
    sig, _ = stereo_signal
    ratio, setup = EXACT[case]
    port, ref = _pair(setup, seed=3)
    n_out = int(round(sig.shape[1] * ratio))
    got, ok = port.exact(sig, n_out)
    assert ok
    _chaos_gate(got, lambda x: ref.exact(x, n_out)[0], sig)


def _ramp(t):
    return 7.0 * t / 2.0          # 0 -> +7 semitones over the 2 s clip


AUTOMATION = {
    "pitch_ramp": (1.0, dict(semitones=_ramp, tonality_limit=2000 / RATE,
                             sample_rate=RATE)),
    "formant_ramp_1.25x": (1.25, dict(
        semitones=lambda t: 2.0 - t, formant_semitones=lambda t: 3.0 * t,
        sample_rate=RATE)),
}


@pytest.mark.parametrize("case", list(AUTOMATION))
def test_automation_chaos_relative_to_jax(stereo_signal, case):
    """A pitch ramp with a tonality limit, and a pitch and formant ramp
    (base estimated), as callables of output time: the port's exact
    against JAX's exact(automation=...)."""
    sig, _ = stereo_signal
    ratio, auto = AUTOMATION[case]

    def setup(s):
        s.preset_default(2, RATE)
        s.set_formant_factor(1.0, True)

    port, ref = _pair(setup)
    n_out = int(round(sig.shape[1] * ratio))
    got, ok = port.exact(sig, n_out, automation=auto)
    assert ok
    _chaos_gate(got, lambda x: ref.exact(x, n_out, automation=auto)[0], sig)


def test_constant_automation_equals_setters(stereo_signal):
    """Automation holding one value in every block (scalars and arrays)
    renders bit for bit what the setters render: the per-block path of
    the peaks map, the formant targets and the formant base."""
    sig, _ = stereo_signal
    n_out = int(round(sig.shape[1] * 1.25))

    def setters(s):
        s.preset_default(2, RATE)
        s.set_transpose_semitones(3, 2500 / RATE)
        s.set_formant_semitones(-2, True)
        s.set_formant_base(180 / RATE)

    a = SignalsmithStretch(device="cpu")
    setters(a)
    want, _ = a.exact(sig, n_out)
    b = SignalsmithStretch(device="cpu")
    b.preset_default(2, RATE)
    b.set_formant_factor(1.0, True)
    plan = b.plan(sig.shape[1], n_out)
    nB = len(b.block_output_times(plan))
    got, _ = b.exact(sig, n_out, automation=dict(
        semitones=3, tonality_limit=np.full(nB, 2500 / RATE),
        formant_semitones=-2, formant_base=np.full(nB, 180 / RATE)))
    assert got.tobytes() == want.tobytes()


def test_short_input_refused():
    s = SignalsmithStretch(device="cpu")
    s.preset_default(2, RATE)
    out, ok = s.exact(np.ones((2, 500), np.float32), 700)
    assert not ok and out.shape == (2, 700) and not out.any()


def test_all_zero_clip_skips_the_render(monkeypatch):
    """A clip of exact zeros renders exact zeros without the pipeline; a
    clip with one nonzero sample renders."""
    calls = []
    real = engine.render_exact

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(engine, "render_exact", counted)
    s = SignalsmithStretch(device="cpu")
    s.preset_cheaper(1, RATE)
    sig = np.zeros((1, RATE), np.float32)
    out, ok = s.exact(sig, 1250)
    assert ok and out.shape == (1, 1250) and not out.any() and not calls
    sig[0, 4000] = 1e-3
    out, ok = s.exact(sig, 1250)
    assert ok and len(calls) == 1 and out.any()


def _silence_pair(monkeypatch, sig, ratio, make):
    """Renders of sig with the bypass on and off (SST_SILENCE=0)."""
    n_out = int(round(sig.shape[1] * ratio))
    outs = []
    for env in ("1", "0"):
        monkeypatch.setenv("SST_SILENCE", env)
        s = make()
        s.preset_cheaper(1, RATE, split_computation=False)
        out, ok = s.exact(sig, n_out)
        assert ok
        outs.append(np.asarray(out))
    return outs


def test_silence_enable(monkeypatch, test_signal):
    """SST_SILENCE=0 turns the bypass off: a loud clip renders bit for bit
    as with it on; a sub-noise clip (amplitude 1e-10, energy below the
    1e-15 floor) differs, as the JAX package's does, and each of the two
    tracks the JAX render with the same setting within -100 dB (the flush
    region exact zeros with the bypass on, in both)."""
    sig, _ = test_signal
    on, off = _silence_pair(monkeypatch, sig, 1.25,
                            lambda: SignalsmithStretch(device="cpu"))
    assert on.tobytes() == off.tobytes()
    quiet = (1e-10 * np.random.default_rng(11).standard_normal(
        (1, 2 * RATE))).astype(np.float32)
    on, off = _silence_pair(monkeypatch, quiet, 1.25,
                            lambda: SignalsmithStretch(device="cpu"))
    jon, joff = _silence_pair(monkeypatch, quiet, 1.25,
                              lambda: japi.SignalsmithStretch(seed=0))
    assert not np.array_equal(on, off) and not np.array_equal(jon, joff)
    assert rel_err_db(on, jon) < -100 and rel_err_db(off, joff) < -100
    s = SignalsmithStretch(device="cpu")
    s.preset_cheaper(1, RATE, split_computation=False)
    sch = s.plan(quiet.shape[1], on.shape[1]).sched
    fz = slice(sch.main_out, sch.main_out + sch.flush_block_out)
    assert sch.flush_block_out > 0
    assert not on[:, fz].any() and off[:, fz].any()


def test_seed_and_random_engine(stereo_signal):
    """Above 2x the seed picks the draws: two seeds render differently, one
    seed twice alike; a random engine replaces the draws."""
    sig, _ = stereo_signal
    n_out = 3 * sig.shape[1]

    def render(**kw):
        s = SignalsmithStretch(device="cpu", **kw)
        s.preset_cheaper(2, RATE)
        return s.exact(sig, n_out)[0]

    base = render(seed=1)
    assert np.array_equal(base, render(seed=1))
    assert not np.array_equal(base, render(seed=2))
    mid = render(seed=1, random_engine=lambda k, shape, lo, hi:
                 ((lo + hi) * 0.5).expand(shape))
    assert np.isfinite(mid).all() and not np.array_equal(base, mid)


def test_process_many_matches_sequential_calls(test_signal):
    """A stream's batched quanta run (process_many, process_many_live) and
    equal, bit for bit, the seek + process calls and the process calls they
    stand for, through the library object's stream."""
    sig, _ = test_signal
    s = SignalsmithStretch(device="cpu")
    s.preset_default(1, RATE)
    s.set_transpose_semitones(3, 2000 / RATE)
    stream = s._stream()
    buf = stream.cfg.input_latency + stream.cfg.output_latency
    hists = np.stack([sig[:, 100 * i:100 * i + buf] for i in range(6)])
    rates = np.float32([1.0, 1.0, 0.8, 0.8, 1.25, 1.25])
    many = stream.process_many(hists, rates, 100)
    s.reset()
    seq = []
    for h, r in zip(hists, rates):
        s.seek(h, r)
        seq.append(s.process(np.zeros((1, 0), np.float32), 100))
    assert many.shape == (6, 1, 100)
    np.testing.assert_array_equal(many, np.stack(seq))
    xs = np.stack([sig[:, 5000 + 64 * i:5000 + 64 * (i + 1)]
                   for i in range(8)])
    snap = stream.state_dict()
    live = stream.process_many_live(xs, 64)
    stream.load_state_dict(snap)
    np.testing.assert_array_equal(live,
                                  np.stack([s.process(x, 64) for x in xs]))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert SignalsmithStretch().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SignalsmithStretch()


def test_jax_automation_carried_by_convert(stereo_signal):
    """A JAX automation's per-block controls and flags, carried across as
    numpy (convert.plan_to_arrays), are the port's own for the same
    automation, and the plan and controls carried render in the port what
    the port's exact renders, bit for bit."""
    from signalsmith_stretch_torch import convert
    sig, _ = stereo_signal
    n = sig.shape[1]
    auto = dict(semitones=_ramp, formant_semitones=lambda t: -t,
                sample_rate=RATE)

    def setup(s):
        s.preset_default(2, RATE)
        s.set_formant_factor(1.0, True)

    port, ref = _pair(setup)
    jplan = japi.engine.build_exact_plan(ref.config, n, n)
    d = convert.plan_to_arrays(jplan, *ref._automated(jplan, auto))
    controls, flags = convert.controls_from_arrays(d)
    own_c, own_f = port._automated(port.plan(n, n), auto)
    assert controls.automated and flags == own_f
    for a, b in zip(controls, own_c):
        np.testing.assert_array_equal(a, b)
    out = engine.render_exact(torch.as_tensor(sig[None]),
                              convert.plan_from_arrays(d), controls, flags)
    want, _ = port.exact(sig, n, automation=auto)
    assert out[0].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("entry", ["batched", "node"])
def test_plain_entries_enter_the_scope(monkeypatch, entry):
    """StretchModel.batched(plain=True) and StretchNode(plain=True) run
    their work inside ops.plain() and leave it on return, also when the
    work raises; plain=False leaves the scope off."""
    from signalsmith_stretch_torch import ops, spectral
    from signalsmith_stretch_torch.models import StretchModel
    from signalsmith_stretch_torch.scheduler import StretchNode
    seen, fail = [], []
    owner, name = ((engine, "render_exact") if entry == "batched"
                   else (spectral, "process_block"))
    real = getattr(owner, name)

    def work(*a, **k):
        seen.append(ops.runs_plain("cuda"))
        if fail:
            raise RuntimeError("work failed")
        return real(*a, **k)

    monkeypatch.setattr(owner, name, work)
    rng = np.random.default_rng(2)
    clip = rng.standard_normal((1, 1, 8000)).astype(np.float32) * 0.1

    def call(plain):
        if entry == "batched":
            StretchModel.build(1, RATE, 8000, 10000, device="cpu").batched(
                clip, None, plain)
        else:
            node = StretchNode(RATE, channels=1, device="cpu", plain=plain)
            node.add_buffers(clip[0])
            node.start(input=0.0, rate=0.8)
            node.render(0.25)

    call(False)
    assert seen and not any(seen)
    seen.clear()
    call(True)
    assert seen and all(seen) and not ops.runs_plain("cuda")
    seen.clear()
    fail.append(True)
    with pytest.raises(RuntimeError, match="work failed"):
        call(True)
    assert seen == [True] and not ops.runs_plain("cuda")
