"""The readers of the program's spans (harness/spans.py and the
program_span metrics), on synthetic host and device events: launch-order
attribution, self time, None on a count mismatch or where the spans are
absent, and each reader's arithmetic.  Times are in nanoseconds."""
import pytest

from benchmark.harness import common, spans


def _render_rec():
    """One request: the analysis launches two kernels, the second of which
    runs only after the analysis span has ended, while the plan runs."""
    host = [
        ("request", 0, 1000),
        ("sst.render.copy_in", 2, 8), ("cudaMemcpyAsync", 3, 6),
        ("sst.render", 10, 900),
        ("sst.render.analysis", 20, 100),
        ("cudaLaunchKernel", 30, 35), ("aten::mul", 48, 58),
        ("cuLaunchKernelEx", 50, 55),
        ("sst.render.plan", 100, 400),
        ("sst.plan.smooth", 110, 200), ("cudaLaunchKernel", 120, 125),
        ("cudaMemcpyAsync", 300, 305), ("aten::add", 310, 320),
        ("sst.render.sweep", 400, 500), ("cudaLaunchKernelExC", 410, 415),
        ("sst.render.synthesis", 500, 800), ("cuLaunchKernel", 510, 515),
        ("cudaMemsetAsync", 520, 522)]
    device = [("Memcpy HtoD (Pageable -> Device)", 7, 9), ("a", 40, 60),
              ("b", 110, 140), ("c", 140, 160),
              ("Memcpy DtoD (Device -> Device)", 310, 330),
              ("sweep", 420, 480), ("fft", 520, 600),
              ("Memset (Device)", 600, 610)]
    return {"host": sorted(host, key=lambda h: h[1]), "device": device,
            "spans": [(0, 1000)]}


def _node_rec():
    """Two quanta: the first runs a block, the second does not."""
    host = [
        ("quantum", 0, 1000), ("sst.node.quantum", 5, 995),
        ("sst.node.history", 10, 100), ("sst.stream.seek", 100, 300),
        ("sst.stream.process", 300, 700), ("sst.stream.block", 400, 600),
        ("sst.stream.block.analysis", 410, 450),
        ("sst.stream.output", 650, 690), ("sst.stream.output", 700, 900),
        ("quantum", 1000, 1500), ("sst.node.quantum", 1000, 1500),
        ("sst.node.history", 1010, 1050), ("sst.stream.seek", 1050, 1150),
        ("sst.stream.process", 1150, 1300), ("sst.stream.output", 1250, 1260),
        ("sst.stream.output", 1300, 1400)]
    return {"host": sorted(host, key=lambda h: h[1]), "device": [],
            "spans": [(0, 1000), (1000, 1500)]}


def test_launch_order_attribution():
    """A device operation belongs to the span that launched it, even where
    it runs after that span has ended."""
    rec = _render_rec()
    at, device = spans.attributed(rec)
    assert len(at) == len(device) == 8
    ops = spans.device_ops(rec, "sst.render.analysis")
    assert [n for n, _, _ in ops[0]] == ["a", "b"]
    assert [n for n, _, _ in spans.device_ops(rec, "sst.render.plan")[0]] \
        == ["c", "Memcpy DtoD (Device -> Device)"]
    assert [n for n, _, _ in spans.device_ops(rec, "sst.render.synthesis")
            [0]] == ["fft", "Memset (Device)"]


def test_self_time():
    """The quantum span less what its child spans cover (the block and the
    inner output copy lie inside the process span)."""
    rec = _node_rec()
    got = spans.self_ms(rec, "sst.node.quantum")
    assert got == pytest.approx([(990 - 90 - 200 - 400 - 200) / 1e6,
                                 (500 - 40 - 100 - 150 - 100) / 1e6])


@pytest.mark.parametrize("how", ["one device op lost", "one launch lost",
                                 "an op in the next request",
                                 "a lost launch and an unlisted copy",
                                 "a graph launch"])
def test_none_on_count_mismatch(how):
    """Counts that differ, or pairs whose kinds differ: nothing is
    attributed."""
    rec = _render_rec()
    if how == "a lost launch and an unlisted copy":
        # the counts agree everywhere, but from the plan's copy on every
        # launch would pair with the operation after its own
        rec["host"] = [h for h in rec["host"] if h[1] != 120]
        rec["device"] = sorted(rec["device"] + [
            ("Memcpy DtoH (Device -> Pageable)", 200, 205)],
            key=lambda d: d[1])
    elif how == "a graph launch":
        rec["host"] = sorted(rec["host"] + [("cudaGraphLaunch", 600, 605)],
                             key=lambda h: h[1])
        rec["device"] = rec["device"] + [("g0", 700, 710), ("g1", 710, 720)]
    elif how == "one device op lost":
        rec["device"] = rec["device"][:-1]
    elif how == "one launch lost":
        rec["host"] = [h for h in rec["host"] if h[1] != 520]
    else:
        # the same counts over the record, but a request's last operation
        # starts in the next request's window
        rec["spans"] = [(0, 500), (500, 1000)]
        rec["host"] = [h for h in rec["host"] if h[1] != 520] + [
            ("cudaLaunchKernel", 490, 495)]
        rec["host"].sort(key=lambda h: h[1])
    assert spans.attributed(rec) is None
    for name in ("render.analysis_device_ms", "render.plan_device_ms",
                 "render.sweep_device_ms", "render.synthesis_device_ms",
                 "render.plan_launches"):
        assert common.reader(name)(rec) is None


NEW = ["render.analysis_device_ms", "render.plan_device_ms",
       "render.sweep_device_ms", "render.synthesis_device_ms",
       "render.plan_host_ms", "render.plan_launches",
       "stream.block_host_ms", "stream.seek_host_ms",
       "node.scheduler_self_ms", "node.output_wait_ms"]


@pytest.mark.parametrize("name", NEW)
def test_none_without_program_spans(name):
    """A program without spans: the same events less every sst.* span."""
    for rec in (_render_rec(), _node_rec()):
        rec["host"] = [h for h in rec["host"] if not h[0].startswith("sst.")]
        assert common.reader(name)(rec) is None


def test_render_readers():
    rec = _render_rec()
    r = common.reader
    assert r("render.analysis_device_ms")(rec) == pytest.approx(50 / 1e6)
    assert r("render.plan_device_ms")(rec) == pytest.approx(40 / 1e6)
    assert r("render.sweep_device_ms")(rec) == pytest.approx(60 / 1e6)
    assert r("render.synthesis_device_ms")(rec) == pytest.approx(90 / 1e6)
    assert r("render.plan_host_ms")(rec) == pytest.approx(300 / 1e6)
    assert r("render.plan_launches")(rec) == 2
    # two requests: the means over them
    two = dict(rec, spans=[(0, 1000), (1000, 2000)],
               host=rec["host"] + [(n, s + 1000, e + 1000)
                                   for n, s, e in rec["host"]],
               device=rec["device"] + [(n, s + 1000, e + 1000)
                                       for n, s, e in rec["device"]])
    assert r("render.plan_launches")(two) == 2
    assert r("render.plan_device_ms")(two) == pytest.approx(40 / 1e6)


def test_node_readers():
    rec = _node_rec()
    r = common.reader
    assert r("stream.block_host_ms")(rec) == pytest.approx(200 / 1e6)
    assert r("stream.seek_host_ms")(rec) == pytest.approx(150 / 1e6)
    assert r("node.scheduler_self_ms")(rec) == pytest.approx(
        (100 + 110) / 2 / 1e6)
    # only the first quantum runs a block: its two output spans
    assert r("node.output_wait_ms")(rec) == pytest.approx(240 / 1e6)
