"""A run with the timed path broken underneath comes out not correct: the
harness past its look for a chip, at a tiny size on the CPU (the port's
plain versions), once sound and once for each fault the cells can have."""
import io

import pytest

from benchmark.harness import common, runner
from benchmark.tests.test_bench_reference import (small_config, small_node,
                                                  small_offline)

BENCH = common.benchmark()


def run(workload, control=False, traced=False, **sizes):
    cell = common.cell(BENCH, workload)
    cfg = small_config(cell["config"])
    traffic = dict(small_offline() if "offline" in workload
                   else small_node(), **sizes)
    return runner.measure(BENCH, cell, cfg, traffic,
                          common.limits(workload), seed=2 ** 31 + 77,
                          seconds=0.3, traced=traced, t0=0.0, device="cpu",
                          log=io.StringIO(), control=control)


def faults_of(workload):
    """The FAULTS of the cell's loop, by name."""
    loop = common.traffic(common.cell(BENCH, workload)["traffic"])["loop"]
    return common.load("loops", loop).FAULTS


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_sound_run_is_correct(workload):
    line = run(workload)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in common.metrics_for(BENCH, workload,
                                                   "end_to_end")}
    assert set(line["metrics"]) == names


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_line(workload):
    """The traced run on the CPU: its spans, the breakdown and the device's
    busy and window seconds; the readers of the device's trace find no
    device events there and report nothing."""
    line = run(workload, traced=True, trace_seconds=0.2)
    assert line["correct"], line["checks"]
    listed = {m["name"]: m["source"]
              for m in common.metrics_for(BENCH, workload, "per_layer")}
    assert line["attempted"] > 0 and set(line["metrics"]) <= set(listed)
    assert all(listed[k] != "device_trace" for k in line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    (w["name"], f) for w in BENCH["workloads"] for f in faults_of(w["name"])],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch.setattr)
    line = run(workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_run_is_not_correct(workload):
    """The control, through the run's own decide and correct; offline with
    the cell's sample of 16 clips (the largest gap over fewer clips of
    1 s at 8 kHz swings from seed to seed: 1,250-5,109 over 4 clips)."""
    sizes = ({"batch": 16, "check_clips": 16} if "offline" in workload
             else {})
    line = run(workload, control=True, **sizes)
    assert not line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_patcher_undoes():
    from types import SimpleNamespace
    o = SimpleNamespace(a=1)
    patch, undo = common.patcher()
    patch(o, "a", 2)
    patch(o, "a", 3)
    assert o.a == 3
    undo()
    assert o.a == 1
