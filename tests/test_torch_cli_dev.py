"""The port's dev CLI (cli_dev.py) and its profiling utilities
(utils/profiling.py), on the CPU.

The port of tests/test_components.py::test_cli_dev_golden_regression: the
first run snapshots <output>.reference.npy, the second passes the -60 dB
gate against it, both through the allocation guard.  The guard itself is
held to what it checks: it passes a render repeated on one plan and trips
when a call builds a plan.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import engine  # noqa: E402
from signalsmith_stretch_torch.cli_dev import main as dev_main  # noqa: E402
from signalsmith_stretch_torch.io import write_raw  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.utils import profiling  # noqa: E402


def test_cli_dev_golden_regression(tmp_path, test_signal, capsys):
    sig, rate = test_signal
    inp = str(tmp_path / "in.raw")
    outp = str(tmp_path / "out.raw")
    write_raw(inp, sig[:, :8000], rate)
    args = [inp, outp, "--raw", "--cheaper", "--time=1.25", "--seed=1",
            "--device", "cpu"]
    assert dev_main(args) == 0          # snapshots the reference
    assert os.path.exists(outp + ".reference.npy")
    first = capsys.readouterr().out
    assert "snapshotted" in first and "allocation guard: ok" in first
    assert dev_main(args + ["--profile"]) == 0    # passes the -60 dB gate
    second = capsys.readouterr().out
    assert "difference:" in second and "realtime" in second
    svg = tmp_path / "profile.svg"
    assert svg.exists() and "<svg" in svg.read_text()
    for stage in ("analysis", "plan", "sweep", "synthesis", "full"):
        assert stage in second
    # a changed render fails the gate
    np.save(outp + ".reference.npy",
            np.load(outp + ".reference.npy") * np.float32(1.01))
    assert dev_main(args) == 1


def test_allocation_guard_trips_on_a_plan_rebuild(test_signal):
    sig, rate = test_signal
    n = 8000
    x = torch.as_tensor(sig[:, :n])

    def model():
        return StretchModel.build(1, rate, n, 10000, semitones=2.0,
                                  tonality_hz=2000, cheaper=True,
                                  device="cpu")

    m = model()
    guard = profiling.AllocationGuard(lambda a: m(a, 1), "cpu")
    first = guard(x)
    again = guard(x)
    counts = guard.check()
    assert torch.equal(first, again) and guard.calls == 2
    assert counts["plans built"] == engine.plans_built
    assert "device allocations" not in counts       # the CPU has none

    rebuild = profiling.AllocationGuard(lambda a: model()(a, 1), "cpu")
    rebuild(x)
    rebuild(x)
    with pytest.raises(RuntimeError, match="plans built"):
        rebuild.check()


def test_profiling_helpers(tmp_path, test_signal):
    """timed() is a best time in seconds, stage_breakdown() times each
    stage and the full render, write_svg_bars() draws one bar each."""
    sig, rate = test_signal
    n = 8000
    model = StretchModel.build(1, rate, n, n, cheaper=True, device="cpu")
    clips = torch.as_tensor(sig[None, :, :n])
    assert profiling.timed(lambda: model.batched(clips), reps=2) > 0
    times = profiling.stage_breakdown(model, clips, reps=1)
    assert list(times) == ["analysis", "plan", "sweep", "synthesis", "full"]
    assert all(v > 0 for v in times.values())
    path = str(tmp_path / "bars.svg")
    profiling.write_svg_bars(path, {k: v * 1e3 for k, v in times.items()})
    assert open(path).read().count("<rect") == len(times)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        model.batched(clips)
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()
