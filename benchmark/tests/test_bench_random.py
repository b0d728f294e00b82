"""The cell above 2x (offline_3x_random): its files found by name, the
readers of its plan's phases and their bounds, its new fault not correct
with the cell's 16-clip sample, and the loop's check reading the port's
plain path bit for bit, at a tiny size on the CPU.  The cell's sound run,
traced line, every fault at 4 clips and the control at 16 clips run in
test_bench_faults.py's parametrised tests (with the cell's own loop,
conftest.py)."""
import io

import numpy as np
import pytest

from benchmark.harness import common, roofline, roofline_random, runner
from benchmark.tests.test_bench_reference import small_config, small_offline

BENCH = common.benchmark()
CELL = "offline_3x_random"
READERS = ["render.draws_device_ms", "render.positions_device_ms",
           "render.lookup_device_ms", "render.positions_launches",
           "draws_roofline", "lookup_roofline"]


def small():
    cell = common.cell(BENCH, CELL)
    return (cell, small_config(cell["config"]),
            dict(small_offline(),
                 loop=common.traffic(cell["traffic"])["loop"]))


def test_registry_finds_the_cell():
    cell = common.cell(BENCH, CELL)
    cfg = common.config(BENCH, cell["config"])
    assert cfg["name"] == "stretch3x_default" and cfg["time_factor"] == 3.0
    assert cfg["controls"] == {"semitones": 0.0, "tonality_hz": 0.0}
    assert cfg["reduced"] == [] and "seeds" in cfg["assumed"]
    traffic = common.traffic(cell["traffic"])
    assert traffic["loop"] == "offline_random"
    offline = common.traffic("offline_batch32x10s")
    assert {k: v for k, v in traffic.items()
            if k not in ("loop", "why", "check_block")} == {
        k: v for k, v in offline.items()
        if k not in ("loop", "why", "check_block")}
    loop = common.load("loops", "offline_random")
    assert [f.__name__ for f in loop.FAULTS] == [
        "half_batch_left_out", "render_altered", "draws_left_out"]
    assert common.limits(CELL)["chaos_gap"]["limit"] > 1
    per_layer = {m["name"] for m in common.metrics_for(BENCH, CELL,
                                                       "per_layer")}
    assert set(READERS) <= per_layer
    assert {m["name"] for m in common.metrics_for(BENCH, CELL,
                                                  "end_to_end")} == {
        "render_rtf", "render_p95_ms", "setup_s"}


def _rec(with_spans=True):
    """One request of the randomised plan: the draws launch one kernel,
    the positions five operations (one of which runs after its span has
    ended), the lookup two."""
    host = [("request", 0, 1000), ("sst.render.plan", 100, 800),
            ("sst.plan.draws", 110, 200), ("cudaLaunchKernel", 120, 125),
            ("sst.plan.positions", 200, 300)]
    host += [("cudaLaunchKernel", 210 + 10 * i, 215 + 10 * i)
             for i in range(5)]
    host += [("sst.plan.lookup", 300, 500), ("cudaMemcpyAsync", 310, 315),
             ("cudaLaunchKernel", 320, 325)]
    device = [("draws_kernel", 130, 190)]
    device += [(f"elementwise{i}", 220 + 10 * i, 228 + 10 * i)
               for i in range(4)]
    device += [("stack", 300, 310), ("Memcpy HtoD (Pageable -> Device)",
                                     320, 330), ("interp_kernel", 330, 430)]
    if not with_spans:
        host = [h for h in host if not h[0].startswith("sst.")]
    return {"host": sorted(host, key=lambda h: h[1]), "device": device,
            "spans": [(0, 1000)],
            "shapes": dict(R=8008, B=4096, channels=2, sets=4,
                           draws=2 * 8008 * 4096)}


def test_readers_arithmetic():
    rec = _rec()
    r = common.reader
    assert r("render.draws_device_ms")(rec) == pytest.approx(60 / 1e6)
    assert r("render.positions_device_ms")(rec) == pytest.approx(42 / 1e6)
    assert r("render.positions_launches")(rec) == 5
    assert r("render.lookup_device_ms")(rec) == pytest.approx(110 / 1e6)
    shapes = rec["shapes"]
    a_bytes = 8008 * 4096 * (4 * 4 + 2 * 8 + 4 * 2 * 8)
    assert roofline_random.lookup_bound_ms(shapes) == pytest.approx(
        1e3 * a_bytes / roofline.PEAK_BYTES)
    ops = 2 * 8008 * 4096 * 73
    t_ops = ops / (132 * 128 * 1.98e9)
    assert t_ops > 8008 * 4096 * 8 / roofline.PEAK_BYTES
    assert roofline_random.draws_bound_ms(shapes) == pytest.approx(
        1e3 * t_ops)
    assert r("draws_roofline")(rec) == pytest.approx(
        100 * 1e3 * t_ops / (60 / 1e6))
    assert r("lookup_roofline")(rec) == pytest.approx(
        100 * 1e3 * a_bytes / roofline.PEAK_BYTES / (110 / 1e6))


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_spans(name):
    """A program without spans (or without the positions span: the parent
    of this cell's reader reads the lookup only), or a record without
    shapes, reads None."""
    assert common.reader(name)(_rec(with_spans=False)) is None
    assert common.reader(name)({}) is None
    no_shapes = _rec()
    del no_shapes["shapes"]
    if "roofline" in name:
        assert common.reader(name)(no_shapes) is None
    no_positions = _rec()
    no_positions["host"] = [h for h in no_positions["host"]
                            if h[0] != "sst.plan.positions"]
    if "positions" in name:
        assert common.reader(name)(no_positions) is None


def _run(control=False, **sizes):
    cell, cfg, traffic = small()
    return runner.measure(BENCH, cell, cfg, dict(traffic, **sizes),
                          common.limits(CELL), seed=2 ** 32 + 12345,
                          seconds=0.2, traced=False, t0=0.0, device="cpu",
                          log=io.StringIO(), control=control)


def test_draws_left_out_is_not_correct(monkeypatch):
    """A 3x render without the per-bin draws, with the cell's sample of
    16 clips."""
    common.load("loops", "offline_random").draws_left_out(
        monkeypatch.setattr)
    line = _run(batch=16, check_clips=16)
    assert not line["correct"], line["checks"]


def test_loop_check_reads_the_plain_path_bit_for_bit():
    """At 8 kHz, 4 clips of 1 s at 3x on the CPU the program is the port's
    plain path: the loop's check, the sampled clips rendered by the
    reference from their indices as seeds, finds no gap at all."""
    cell, cfg, traffic = small()
    o = common.loop("offline_random")(cfg, traffic, 9, "cpu")
    o.window(0.01)
    p, idx, _ = o.sample()
    assert list(idx) == [0, 1, 2, 3]
    o.free()
    assert o.numbers() == {"chaos_gap": 0.0}
    # the seeds matter: the reference from other seeds reads a gap
    audio = o.pool[p][idx]
    other = o.reference(audio, seeds=[int(i) + 1 for i in idx])
    assert not np.array_equal(other, o.kept[p][idx])
