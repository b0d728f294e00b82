"""The port's batched quanta (StreamingStretch.process_many and
process_many_live), its scheduler (StretchNode) and its worklet host
(WorkletHost) against the port's own quantum-by-quantum calls and against
the JAX package's, on the CPU.

Tolerances.
- Batched against sequential, in the port: bit equality.  process_many
  runs the same seek and process steps on the same values (its inputs
  copied to the device once, its outputs kept there until the end).
- Against JAX: live input unmapped at 1.0x, each quantum within -100 dB
  of JAX's (the error's energy over the quantum against the mean energy of
  JAX's whole output, tests/test_torch_streaming.py; measured -131 to -142
  dB).  A stretch or a pitch map makes the recursion chaotic, and so does
  the re-seek before every quantum of buffer playback even at 1.0x
  unmapped: there every block re-analyses its previous frame, and JAX's
  own response to a 1-ulp change of its histories grows from -130 dB to
  -100 dB over 32 quanta of 128 samples at 8 kHz (the port, from -128 to
  -95 dB).  There the output is held within 12 dB of JAX's own response to
  a 1-ulp change of its input (up or down, the larger), band energies
  within 3 dB (tests/test_torch_streaming_chaos.py).  Silent (inactive)
  quanta and the input-time feedback: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
from test_torch_streaming import _assert_calls_match, _pair  # noqa: E402
from test_torch_streaming_chaos import _band_energy_db  # noqa: E402
from signalsmith_stretch_torch.scheduler import Segment, StretchNode  # noqa
from signalsmith_stretch_torch.worklet import WorkletHost  # noqa: E402
from signalsmith_stretch_tpu.scheduler import Segment as JSegment  # noqa
from signalsmith_stretch_tpu.scheduler import StretchNode as JNode  # noqa

f32 = np.float32
CHAOS_MARGIN_DB = 12.0
BAND_DB = 3.0
QUANTUM = 128


def _chaos_gate(got, want, probes):
    """got within CHAOS_MARGIN_DB of JAX's 1-ulp sensitivity (`probes`:
    JAX's outputs for its input nudged up and down), bands within BAND_DB."""
    sens = [rel_err_db(p, want) for p in probes]
    dev = rel_err_db(got, want)
    band = np.abs(_band_energy_db(got) - _band_energy_db(want)).max()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert dev < max(sens) + CHAOS_MARGIN_DB, (dev, sens)
    assert band <= BAND_DB, band


def _nudged(sig):
    return [np.nextafter(sig, way).astype(f32) for way in (np.inf, -np.inf)]


# ---- process_many and process_many_live ------------------------------------
CASES = {"1.0x": (1, 1.0, 0.0), "1.25x": (2, 0.8, 0.0),
         "pitch+5": (2, 1.0, 5.0)}


def _histories(sig, cfg, rate, m):
    """The worklet's re-seek windows: bufferLength of history ending where
    the input time has reached at each of m quanta (zeros before 0)."""
    buf = cfg.input_latency + cfg.output_latency
    pad = np.concatenate([np.zeros((sig.shape[0], buf), f32), sig], 1)
    ends = [buf + int(round(3000 + i * QUANTUM * rate)) for i in range(m)]
    return np.stack([pad[:, e - buf:e] for e in ends])


def _case(case, test_signal, stereo_signal):
    ch, rate, semis = CASES[case]
    sig, sr = stereo_signal if ch == 2 else test_signal
    port, ref, cfg = _pair(ch, sr, semitones=semis,
                           tonality=(2000 / sr) if semis else 0.0)
    return sig, port, ref, cfg, rate


@pytest.mark.parametrize("case", list(CASES))
def test_process_many_bit_equal_to_sequential(case, test_signal,
                                              stereo_signal):
    sig, port, _, cfg, rate = _case(case, test_signal, stereo_signal)
    hists = _histories(sig, cfg, rate, 24)
    many = port.process_many(hists, np.full(24, rate, f32), QUANTUM)
    port.reset(1)
    seq = []
    for h in hists:
        port.seek(h, rate)
        seq.append(port.process(np.zeros((sig.shape[0], 0), f32), QUANTUM))
    assert many.shape == (24, sig.shape[0], QUANTUM)
    np.testing.assert_array_equal(many, np.stack(seq))


@pytest.mark.parametrize("case", ["1.0x", "pitch+5"])
def test_process_many_live_bit_equal_to_sequential(case, test_signal,
                                                   stereo_signal):
    sig, port, _, cfg, _ = _case(case, test_signal, stereo_signal)
    port.seek(sig[:, :cfg.input_latency], 1.0)
    snap = port.state_dict()
    xs = np.stack([sig[:, 4000 + i * QUANTUM:4000 + (i + 1) * QUANTUM]
                   for i in range(24)])
    many = port.process_many_live(xs, QUANTUM)
    port.load_state_dict(snap)
    seq = np.stack([port.process(x, QUANTUM) for x in xs])
    np.testing.assert_array_equal(many, seq)
    assert port.process_many_live(xs[:0], QUANTUM).shape == (
        0, sig.shape[0], QUANTUM)


@pytest.mark.parametrize("case", list(CASES))
def test_process_many_matches_jax(case, test_signal, stereo_signal):
    sig, port, ref, cfg, rate = _case(case, test_signal, stereo_signal)
    m = 32
    rates = np.full(m, rate, f32)
    got = port.process_many(_histories(sig, cfg, rate, m), rates, QUANTUM)
    want = ref.process_many(_histories(sig, cfg, rate, m), rates, QUANTUM)
    probes = []
    for x in _nudged(sig):
        ref.reset(1)
        probes.append(ref.process_many(_histories(x, cfg, rate, m), rates,
                                       QUANTUM))
    _chaos_gate(np.concatenate(got, 1), np.concatenate(want, 1),
                [np.concatenate(p, 1) for p in probes])


@pytest.mark.parametrize("case", ["1.0x", "pitch+5"])
def test_process_many_live_matches_jax(case, test_signal, stereo_signal):
    sig, port, ref, cfg, _ = _case(case, test_signal, stereo_signal)

    def live(s, x):
        s.seek(x[:, :cfg.input_latency], 1.0)
        return s.process_many_live(np.stack(
            [x[:, 2000 + i * QUANTUM:2000 + (i + 1) * QUANTUM]
             for i in range(32)]), QUANTUM)

    got, want = live(port, sig), live(ref, sig)
    if case == "1.0x":
        _assert_calls_match(list(got), list(want))
        return
    probes = []
    for x in _nudged(sig):
        ref.reset(1)
        probes.append(np.concatenate(live(ref, x), 1))
    _chaos_gate(np.concatenate(got, 1), np.concatenate(want, 1), probes)


# ---- the scheduler against JAX's (tests/test_components.py:11-55) ----------
def test_stretch_node_buffer_playback(test_signal):
    """A +12 semitone segment over stored buffers renders the octave-shifted
    fundamental (the JAX test's gate) and holds to JAX's node."""
    sig, rate = test_signal

    def run(cls, x, **kw):
        node = cls(rate, channels=1, preset="cheaper", quantum=400, **kw)
        node.add_buffers(x)
        assert node.buffer_seconds == pytest.approx(3.0, abs=0.01)
        node.schedule(input=0.5, rate=1.0, semitones=12.0, tonality_hz=2000)
        return node.render(0.5)

    out = run(StretchNode, sig, device="cpu")
    assert out.shape == (1, int(0.5 * rate))
    seg = out[0, 1600:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    peak = np.fft.rfftfreq(len(seg), 1 / rate)[np.argmax(spec)]
    assert 195 < peak < 245, peak
    _chaos_gate(out, run(JNode, sig), [run(JNode, x) for x in _nudged(sig)])


def test_stretch_node_stop_and_updates(test_signal):
    """Inactive quanta render zeros, the input-time feedback fires with
    JAX's values, the latencies are JAX's; the 1.0x quanta within -100 dB."""
    sig, rate = test_signal

    def run(cls, **kw):
        node = cls(rate, channels=1, preset="cheaper", quantum=320, **kw)
        node.add_buffers(sig)
        times = []
        node.set_update_interval(0.1, times.append)
        node.schedule(input=0.0, rate=1.0)
        played = node.render(0.2)
        node.stop()
        return node, played, node.render(0.2), times

    node, played, stopped, times = run(StretchNode, device="cpu")
    jnode, jplayed, jstopped, jtimes = run(JNode)
    assert np.all(stopped == 0) and np.all(jstopped == 0)
    assert len(times) >= 2 and times == jtimes
    assert node.input_time == jnode.input_time
    assert node.latency() == jnode.latency()
    _assert_calls_match([played[:, i:i + 320] for i in range(0, 1600, 320)],
                        [jplayed[:, i:i + 320] for i in range(0, 1600, 320)])


def test_stretch_node_loop():
    """Segment.input_at: the loop wraps, as JAX's does, value for value."""
    kw = dict(input=0.0, output=0.0, rate=1.0, loop_start=0.5, loop_end=1.0)
    seg, jseg = Segment(**kw), JSegment(**kw)
    assert seg.input_at(1.25) == pytest.approx(0.75)
    assert seg.input_at(2.3) == pytest.approx(0.8, abs=1e-6)
    ts = np.linspace(-0.5, 4.0, 91)
    assert [seg.input_at(t) for t in ts] == [jseg.input_at(t) for t in ts]


def _scheduled(cls, sig, rate, batched=False, **kw):
    """tests/test_worklet.py's schedule: 1.25x from 0, then 0.8x from input
    0.5 s at quantum 24; the input time after every quantum."""
    node = cls(rate, channels=1, quantum=QUANTUM, preset="cheaper", **kw)
    node.add_buffers(sig)
    times = []
    node.set_update_interval(1e-9, times.append)
    node.start(input=0.0, rate=1.25)
    node.schedule(output=24 * QUANTUM / rate, input=0.5, rate=0.8)
    return node.render(48 * QUANTUM / rate, batched=batched), times


def test_scheduled_render_matches_jax(test_signal):
    """The worklet tests' schedule through the port's node and JAX's: the
    output at the chaos gate (1.25x and 0.8x), the input-time feedback
    equal, quantum by quantum and batched."""
    sig, rate = test_signal
    got, times = _scheduled(StretchNode, sig, rate, device="cpu")
    want, jtimes = _scheduled(JNode, sig, rate)
    _chaos_gate(got, want, [_scheduled(JNode, x, rate)[0]
                            for x in _nudged(sig)])
    assert times == jtimes and len(times) == 48
    got_b, times_b = _scheduled(StretchNode, sig, rate, batched=True,
                                device="cpu")
    np.testing.assert_array_equal(got_b, got)
    assert times_b == times


def test_live_input_matches_jax(test_signal):
    """Live input at 1.0x: each quantum within -100 dB of JAX's."""
    sig, rate = test_signal

    def run(cls, **kw):
        node = cls(rate, channels=1, quantum=QUANTUM, preset="cheaper", **kw)
        node.start(rate=1.0)
        return node.render(16 * QUANTUM / rate, live_input=sig)

    got, want = run(StretchNode, device="cpu"), run(JNode)
    split = list(range(QUANTUM, got.shape[1], QUANTUM))
    _assert_calls_match(np.split(got, split, 1), np.split(want, split, 1))


def test_node_default_device_is_cuda():
    if torch.cuda.is_available():
        assert StretchNode(8000).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StretchNode(8000)


# ---- the worklet host (tests/test_worklet.py, on the port) -----------------
def test_worklet_host_matches_direct_node(test_signal):
    """Audio pulled through the render thread equals the same schedule
    driven directly on a StretchNode, bit for bit."""
    sig, rate = test_signal
    host = WorkletHost(rate, channels=1, quantum=QUANTUM, preset="cheaper",
                       buffer_quanta=4, device="cpu")
    try:
        host.add_buffers(sig)
        host.start(input=0.0, rate=1.25, output=0.0)
        host.resume()             # AudioContext.resume(): quantum 0 = t 0
        got = host.read(32, timeout=120.0)
        t = host.poll_time()
    finally:
        host.close()

    node = StretchNode(rate, channels=1, quantum=QUANTUM, preset="cheaper",
                       device="cpu")
    node.add_buffers(sig)
    node.start(input=0.0, rate=1.25)
    want = node.render(32 * QUANTUM / rate)
    np.testing.assert_array_equal(got, want)
    assert t is None or t >= 0.0


def test_worklet_control_between_quanta(test_signal):
    """stop() marshalled mid-stream takes effect on a later quantum without
    tearing (quanta are whole)."""
    sig, rate = test_signal
    host = WorkletHost(rate, channels=1, quantum=QUANTUM, preset="cheaper",
                       buffer_quanta=2, device="cpu")
    try:
        host.add_buffers(sig)
        host.start(input=0.0, rate=1.0, output=0.0)
        host.resume()
        first = host.read(8, timeout=120.0)
        host.stop()
        for _ in range(40):
            q = host.read(1, timeout=120.0)
            if not q.any():
                break
        assert not q.any()
        assert first.shape == (1, 8 * QUANTUM)
    finally:
        host.close()


def test_batched_quanta_match_per_quantum(test_signal):
    """process_quanta reproduces the per-quantum loop bit for bit, in
    buffer playback and in live-input mode, and a batched worklet host
    hands out the direct node's quanta."""
    sig, rate = test_signal
    a, _ = _scheduled(StretchNode, sig, rate, device="cpu")
    b, _ = _scheduled(StretchNode, sig, rate, batched=True, device="cpu")
    np.testing.assert_array_equal(a, b)

    def run_live(batched):
        node = StretchNode(rate, channels=1, quantum=QUANTUM,
                           preset="cheaper", device="cpu")
        node.start(rate=1.0)
        return node.render(16 * QUANTUM / rate, live_input=sig,
                           batched=batched)

    np.testing.assert_array_equal(run_live(True), run_live(False))

    host = WorkletHost(rate, channels=1, quantum=QUANTUM, preset="cheaper",
                       buffer_quanta=8, batch_quanta=4, device="cpu")
    try:
        host.add_buffers(sig)
        host.start(input=0.0, rate=1.25, output=0.0)
        host.resume()
        got = host.read(16, timeout=120.0)
    finally:
        host.close()
    node = StretchNode(rate, channels=1, quantum=QUANTUM, preset="cheaper",
                       device="cpu")
    node.add_buffers(sig)
    node.start(input=0.0, rate=1.25)
    np.testing.assert_array_equal(got, node.render(16 * QUANTUM / rate))
