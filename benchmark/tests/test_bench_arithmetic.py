"""The harness's arithmetic: rates over the whole window, tails over all
requests, the pacer's timing from each quantum's due time, the union of
device intervals, and the stage rooflines' bytes from shapes."""
import statistics
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import common, roofline, trace

node = common.load("loops", "node")


def test_quantile_matches_numpy():
    rng = np.random.default_rng(3)
    v = list(rng.random(257))
    for q in (0.5, 0.95, 0.99):
        assert common.quantile(v, q) == pytest.approx(np.quantile(v, q))


def test_spread_is_statistics_quartiles():
    v = [1.0, 2.0, 3.0, 4.0, 10.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert common.spread(v) == (q3 - q1) / 3.0


def test_rate_over_the_whole_window():
    Loop = common.loop("offline")
    o = Loop.__new__(Loop)
    o.traffic = {"batch": 32, "clip_seconds": 10.0}
    w = {"attempted": 10, "failed": 1, "wall": 2.0,
         "latencies": [0.1] * 9 + [0.5]}
    e = o.end_to_end(w)
    assert e["render_rtf"] == 9 * 32 * 10.0 / 2.0
    assert e["render_p95_ms"] == pytest.approx(
        1e3 * np.quantile(w["latencies"], 0.95))


class _Engine:
    def __init__(self):
        self.blocks = 0
        carry = SimpleNamespace(**{k: torch.zeros(2, 8) for k in node.CARRY})
        self.state = SimpleNamespace(
            carry=carry, **{k: torch.zeros(2, 9) for k in node.BUFFERS},
            **{k: 0 for k in node.SCALARS})


class _SlowNode:
    """Quanta that take 3 ms every fourth call, else nothing."""

    def __init__(self, eng):
        self.eng, self.k = eng, 0

    def process_quantum(self):
        self.k += 1
        if self.k % 4 == 0:
            self.eng.blocks += 1
            t = time.perf_counter() + 0.003
            while time.perf_counter() < t:
                pass
        return np.zeros((2, 128), np.float32)


def test_latency_from_the_due_time():
    """A quantum after a slow one starts late, and its latency counts the
    wait; quanta that are not late start within the pacer's slack."""
    n = node.Loop.__new__(node.Loop)
    n.rate, n.quantum = 48000, 128
    n.traffic = {"check_run_quanta": 4, "check_runs": 2}
    n.s_check = np.random.SeedSequence(1)
    n.engine = _Engine()
    n.node = _SlowNode(n.engine)
    n.done = 0
    w = n.window(0.2)
    period = 128 / 48000
    lat = w["latencies"]
    assert len(lat) == int(0.2 / period)
    slow = np.arange(len(lat)) % 4 == 3
    assert (lat[slow] >= 0.003).all()
    # the quantum after a slow one was due 2.667 ms after it: it waits
    after = np.roll(slow, 1)
    after[0] = False
    assert (lat[after] >= 0.003 - period - 1e-4).all()
    assert w["blocks"].sum() == slow.sum()
    assert (w["pacer"] < 0.002).all()
    assert len(n.before) == len(n.after) == len(n.outs) == 8


def test_union_of_intervals():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_ns([(0, 10), (2, 3)]) == 10
    assert trace.union_ns([]) == 0
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_within_and_busy():
    dev = [("k1", 0, 10), ("k2", 5, 15), ("k3", 20, 30), ("k4", 40, 50)]
    assert [d[0] for d in trace.within(dev, 4, 25)] == ["k2", "k3"]
    assert trace.busy_ns(dev, [(0, 35)]) == 25
    assert trace.busy_ns(dev, [(0, 12), (19, 45)]) == 12 + 10 + 5


def test_idle_gaps_named_by_the_host():
    dev = [("k", 0, 10), ("k", 30, 40)]
    host = [("request", 0, 100), ("aten::copy_", 12, 28)]
    gaps = dict(trace.idle_gaps(host, dev, [(0, 50)]))
    assert gaps["aten::copy_"] == pytest.approx(20 / 1e9)
    assert gaps["request"] == pytest.approx(10 / 1e9)
    top = trace.top_ops(dev, [(0, 50)])
    assert top == [["k", 20 / 1e9]]


def test_stage_bound_from_shapes():
    a = torch.zeros(2, 3, 4, dtype=torch.complex64)
    b = torch.zeros(5, dtype=torch.float32)
    out = (torch.zeros(7, dtype=torch.int32), [a])
    assert roofline.nbytes((a, {"x": b})) == 2 * 3 * 4 * 8 + 20
    ms = roofline.stage_bound_ms((a, b), out)
    assert ms == pytest.approx(1e3 * (192 + 20 + 28 + 192) / 3.35e12)
    assert roofline.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound_ms(0, 67e9)[1] == "operations"


def test_roofline_readers():
    rec = {"stage_bound_ms": {"sweep": 0.25, "plan": 1.0},
           "stage_device_ns": {"sweep": 5_000_000, "plan": 0}}
    assert common.reader("sweep_roofline")(rec) == pytest.approx(5.0)
    assert common.reader("plan_roofline")(rec) is None


def test_node_readers():
    dev = [("k", 10, 20), ("k", 30, 60), ("m", 110, 120)]
    rec = {"device": dev, "spans": [(0, 100), (100, 200)],
           "blocks": np.array([2, 0])}
    assert common.reader("node.launches_per_quantum")(rec) == 1.5
    assert common.reader("stream.launches_per_block")(rec) == 1.0
    assert common.reader("stream.block_device_ms")(rec) == 40 / 1e6 / 2
    assert common.reader("device_idle_pct.node")(rec) == pytest.approx(75.0)


def test_offline_readers():
    dev = [("Memcpy HtoD (Pageable -> Device)", 0, 10), ("kern", 10, 50),
           ("Memcpy DtoH (Device -> Pageable)", 60, 80)]
    rec = {"device": dev, "spans": [(0, 100)],
           "stage_ms": {"plan": [1.0, 3.0]}}
    assert common.reader("render.copy_ms")(rec) == 30 / 1e6
    assert common.reader("device_idle_pct.render")(rec) == pytest.approx(30)
    assert common.reader("render.plan_ms")(rec) == 2.0
    assert common.reader("render.sweep_ms")(rec) is None
