"""The port's static plan against the JAX package's, on the CPU.

The plan (schedule, frame indices, WOLA weight, silence plan, STFT basis,
spectral constants) is host numpy arithmetic that replicates the C++
reference's integer and float32 semantics, so the port's own copy must give
the JAX package's arrays bit for bit.  `convert.plan_to_arrays` flattens a
plan of either package into numpy; `plan_from_arrays` rebuilds the port's.

Tolerance: bit equality of every array, with equal dtypes; equal renders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import convert  # noqa: E402
from signalsmith_stretch_torch import engine  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_tpu import engine as jengine  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa: E402
from signalsmith_stretch_tpu.models import StretchModel as JModel  # noqa: E402

# (channels, preset, sample rate, split, in samples, out samples)
CASES = {
    "default_1.0": (2, "default", 8000, False, 16000, 16000),
    "default_1.25": (2, "default", 8000, False, 16000, 20000),
    "default_0.8": (2, "default", 8000, False, 16000, 12800),
    # input interval 239 against 240: most blocks are not re-analysed
    "default_1.004": (2, "default", 8000, False, 16000, 16064),
    "default_2.0": (2, "default", 8000, False, 16000, 32000),
    "cheaper_split_1.25": (1, "cheaper", 8000, True, 24000, 30000),
    # 5x compression: the main-process silence bypass is reachable
    "cheaper_0.2": (1, "cheaper", 8000, False, 32000, 6400),
    # bench.py's clip length at its sample rate
    "default_48k_1.25": (2, "default", 48000, False, 480000, 600000),
    "default_48k_1.0": (2, "default", 48000, False, 480000, 480000),
    # shorter than the seek length: exact() refuses, the plan is empty
    "invalid": (2, "default", 8000, False, 500, 600),
}


def _cfgs(case):
    ch, preset, rate, split, _, _ = CASES[case]
    name = "preset_" + preset
    return (getattr(StretchConfig, name)(ch, rate, split),
            getattr(JConfig, name)(ch, rate, split))


def _plans(case):
    cfg, jcfg = _cfgs(case)
    n_in, n_out = CASES[case][4:]
    return (engine.build_exact_plan(cfg, n_in, n_out),
            jengine.build_exact_plan(jcfg, n_in, n_out))


def _assert_same(a, b):
    assert a.keys() == b.keys(), sorted(a.keys() ^ b.keys())
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_jax(case):
    plan, jplan = _plans(case)
    _assert_same(convert.plan_to_arrays(plan), convert.plan_to_arrays(jplan))


def test_cases_reach_both_schedule_branches():
    """The fixed-rate shortcut (every block new and re-analysed) and the
    general branch are both among the cases."""
    full = _plans("default_1.25")[0].arrays
    part = _plans("default_1.004")[0].arrays
    assert full["new_spectrum"].all() and full["reanalyse"].all()
    assert not part["reanalyse"].all()
    assert _plans("cheaper_0.2")[0].silence.main_possible
    assert not _plans("invalid")[0].sched.valid


@pytest.mark.parametrize("case", ["default_1.25", "cheaper_0.2",
                                  "default_1.004", "invalid"])
def test_plan_round_trip(case):
    """plan_from_arrays inverts plan_to_arrays, for the port's own plan and
    for the JAX package's export."""
    for p in _plans(case):
        d = convert.plan_to_arrays(p)
        _assert_same(convert.plan_to_arrays(convert.plan_from_arrays(d)), d)


def test_controls_round_trip():
    jm = JModel.build(2, 8000, 16000, 16000, semitones=12, tonality_hz=2000)
    d = convert.plan_to_arrays(jm.plan, jm.controls, jm.flags)
    controls, flags = convert.controls_from_arrays(d)
    model = StretchModel.build(2, 8000, 16000, 16000, semitones=12,
                               tonality_hz=2000, device="cpu")
    assert controls == model.controls and flags == model.flags
    assert flags.mapped


@pytest.mark.parametrize("semitones", [0, 12])
def test_plan_from_jax_export_renders_the_same(stereo_signal, semitones):
    """The JAX plan carried across as numpy renders exactly what the port's
    own plan renders."""
    sig, rate = stereo_signal
    n = sig.shape[1]
    out = int(n * 1.25)
    jm = JModel.build(2, rate, n, out, semitones=semitones, tonality_hz=2000)
    own = StretchModel.build(2, rate, n, out, semitones=semitones,
                             tonality_hz=2000, device="cpu")
    carried = StretchModel(own.cfg, own.controls, own.flags, n, out,
                           plan=convert.plan_from_arrays(
                               convert.plan_to_arrays(jm.plan)),
                           device="cpu")
    audio = torch.as_tensor(sig)[None]
    assert torch.equal(carried.batched(audio), own.batched(audio))
