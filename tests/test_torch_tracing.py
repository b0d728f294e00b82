"""The port's program spans (utils/profiling.span) on the CPU at 8 kHz.

Under torch.profiler every `sst.*` span is one CPU operation event, nested
under the span that encloses it: an offline render's copy in, the render
and its four stages (the plan's phases inside the plan), and a node
quantum's history read, seek, process, blocks and output.  With no
profiler running, or on a PyTorch without the fast record function, a span
records nothing.  The card test (marker `cuda`) holds that no span leaves
an event on the device's timeline; it imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.scheduler import StretchNode  # noqa: E402
from signalsmith_stretch_torch.utils import profiling  # noqa: E402

RATE = 8000
QUANTUM = 128
STAGES = ["sst.render.analysis", "sst.render.plan", "sst.render.sweep",
          "sst.render.synthesis"]
BLOCK_PHASES = ["sst.stream.block.analysis", "sst.stream.block.spectral",
                "sst.stream.block.synthesis"]
# the plan's phases as plan_spectral runs them, for each render below
_HEAD = ["sst.plan.inputs"]
_MAPPED = ["sst.plan.energy", "sst.plan.smooth", "sst.plan.peaks"]
_TAIL = ["sst.plan.lookup", "sst.plan.coefficients"]
PLAN_PHASES = {
    "stretch1.25": _HEAD + _TAIL,
    "pitch12": _HEAD + _MAPPED + _TAIL,
    "stretch3": _HEAD + ["sst.plan.draws", "sst.plan.positions"] + _TAIL,
    "formant": _HEAD + _MAPPED + ["sst.plan.formant"] + _TAIL,
}
RENDERS = {
    "stretch1.25": (1.25, {}),
    "pitch12": (1.0, dict(semitones=12.0, tonality_hz=3000.0)),
    "stretch3": (3.0, {}),
    "formant": (1.0, dict(semitones=5.0, formant_semitones=3.0,
                          formant_compensation=True, formant_base_hz=0.0)),
}


def _signal(seconds: float, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * seconds)) / RATE
    sig = (0.4 * np.sin(2 * np.pi * 110 * t)
           + 0.2 * np.sin(2 * np.pi * 555 * t + 1.0)
           + 0.02 * rng.standard_normal(t.shape))
    return sig.astype(np.float32)[None]


def _events(prof):
    """Every event the profiler kept, as its kineto event."""
    return list(prof.profiler.kineto_results.events())


def _spans(prof):
    """The sst.* events on the host: (name, start, end), by start."""
    out = [(e.name(), e.start_ns(), e.end_ns()) for e in _events(prof)
           if e.name().startswith("sst.")
           and e.device_type() == DeviceType.CPU]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _parent(spans, i):
    """The innermost span that encloses span i, or None."""
    _, s, e = spans[i]
    best = None
    for j, (_, ps, pe) in enumerate(spans):
        if j != i and ps <= s and pe >= e and (
                best is None or ps >= spans[best][1]):
            best = j
    return best


def _children(spans, i):
    return [spans[j][0] for j in range(len(spans)) if _parent(spans, j) == i]


def _render(name: str, device="cpu"):
    """One render of a 1 s clip by the render `name`, as the caller makes
    it (numpy in)."""
    tf, controls = RENDERS[name]
    n = RATE
    model = StretchModel.build(1, RATE, n, int(n * tf), device=device,
                               **controls)
    clips = _signal(1.0)[None]
    model.batched(clips)                       # outside the traced call
    return lambda: model.batched(clips)


def _node(device="cpu", live=False):
    """A node in buffer playback at rate 0.8 (or on live input), warmed by
    a few quanta; returns (node, its stream engine)."""
    node = StretchNode(RATE, channels=1, quantum=QUANTUM, preset="default",
                       device=device)
    node.add_buffers(_signal(4.0))
    node.start(input=0.0, rate=1.0 if live else 0.8)
    for _ in range(4):
        node.process_quantum(np.zeros((1, QUANTUM), np.float32) if live
                             else None)
    (eng,) = node._engine_cache.values()
    return node, eng


def _traced(fn, cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    return prof


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_spans_nest_in_order(name):
    """StretchModel.batched: the copy in, then sst.render holding the four
    stages in order, the plan's phases inside the plan stage."""
    run = _render(name)
    spans = _spans(_traced(run))
    names = [n for n, _, _ in spans]
    assert names.count("sst.render") == 1
    top = [n for i, (n, _, _) in enumerate(spans)
           if _parent(spans, i) is None]
    assert top == ["sst.render.copy_in", "sst.render"]
    render = names.index("sst.render")
    assert _children(spans, render) == STAGES
    plan = names.index("sst.render.plan")
    assert _children(spans, plan) == PLAN_PHASES[name]
    for stage in ("sst.render.analysis", "sst.render.sweep",
                  "sst.render.synthesis"):
        assert _children(spans, names.index(stage)) == []


def test_node_quantum_spans_and_block_count():
    """Each StretchNode quantum is one sst.node.quantum holding the history
    read, the seek, the process and the output copy; its blocks are
    sst.stream.block spans, each with its three phases, as many as the
    engine counted."""
    node, eng = _node()
    n_quanta = 40
    b0 = eng.blocks
    spans = _spans(_traced(lambda: [node.process_quantum()
                                    for _ in range(n_quanta)]))
    names = [n for n, _, _ in spans]
    blocks = eng.blocks - b0
    assert blocks > 0
    assert names.count("sst.stream.block") == blocks
    assert names.count("sst.node.quantum") == n_quanta
    assert "sst.stream.bypass" not in names
    for i, n in enumerate(names):
        if n == "sst.node.quantum":
            assert _parent(spans, i) is None
            assert _children(spans, i) == [
                "sst.node.history", "sst.stream.seek", "sst.stream.process",
                "sst.stream.output"]
        elif n == "sst.stream.process":
            kids = _children(spans, i)
            assert kids[-1] == "sst.stream.output"       # the normalisation
            assert set(kids[:-1]) <= {"sst.stream.block"}
        elif n == "sst.stream.block":
            assert _children(spans, i) == BLOCK_PHASES


def test_node_silence_bypass_span():
    """Silent live input: once the silence counter passes two blocks, each
    quantum takes the bypass (one sst.stream.bypass span, no block)."""
    node, eng = _node(live=True)
    zeros = np.zeros((1, QUANTUM), np.float32)
    b0 = eng.blocks
    spans = _spans(_traced(lambda: [node.process_quantum(zeros)
                                    for _ in range(60)]))
    names = [n for n, _, _ in spans]
    assert names.count("sst.stream.block") == eng.blocks - b0
    n_bypass = names.count("sst.stream.bypass")
    assert n_bypass > 0
    for i, n in enumerate(names):
        if n == "sst.stream.bypass":
            p = _parent(spans, i)
            assert names[p] == "sst.stream.process"
            assert "sst.stream.block" not in _children(spans, p)


@pytest.mark.parametrize("path", ["render", "node"])
def test_spans_are_cpu_ops_not_annotations(path):
    """Every sst.* event is a CPU operation, never a user annotation (which
    the profiler would mirror on the device's timeline)."""
    if path == "render":
        run = _render("pitch12")
    else:
        node, _ = _node()

        def run():
            for _ in range(12):
                node.process_quantum()
    sst = [e for e in _events(_traced(run)) if e.name().startswith("sst.")]
    assert sst
    for e in sst:
        assert e.device_type() == DeviceType.CPU, e.name()
        assert not e.is_user_annotation(), e.name()


class _Counting:
    """Stands in for the fast record function and counts its uses."""
    made = 0

    def __init__(self, name):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("path", ["render", "node"])
def test_no_profiler_records_nothing(monkeypatch, path):
    """With no profiler running a span makes no record function at all."""
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _Counting)
    _Counting.made = 0
    if path == "render":
        _render("stretch1.25")()
    else:
        node, _ = _node()
        for _ in range(12):
            node.process_quantum()
    assert _Counting.made == 0
    assert profiling.span("sst.render") is profiling._OFF


def test_span_without_fast_record_function(monkeypatch):
    """On a PyTorch without the fast record function a span is a no-op,
    under the profiler too (never record_function in its place)."""
    monkeypatch.setattr(profiling, "_RecordFunctionFast", None)
    run = _render("stretch1.25")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("sst.render") is profiling._OFF
        run()
    assert _spans(prof) == []
    assert not any(e.is_user_annotation() for e in _events(prof))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["render", "node"])
def test_spans_leave_no_device_event(path):
    """On the card: a traced render and traced quanta leave no device event
    named sst.*, and the spans are there on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    if path == "render":
        run = _render("pitch12", device="cuda")
    else:
        node, _ = _node(device="cuda")

        def run():
            for _ in range(24):
                node.process_quantum()
    events = _events(_traced(run, cuda=True))
    device = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    assert device, "no device events traced"
    assert not [n for n in device if n.startswith("sst.")]
    assert any(e.name().startswith("sst.") for e in events
               if e.device_type() == DeviceType.CPU)
