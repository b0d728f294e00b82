"""The port's streaming engine (streaming.py, the library object's streaming
methods) against the JAX package's, call by call, on the CPU.

Each test drives the port and JAX's `StreamingStretch` (or the library
objects) through the same calls on the same inputs and holds each call's
output to JAX's:
- unmapped 1.0x: within -100 dB of JAX's output, call by call: each
  call's error energy against the mean energy of JAX's whole stream
  (measured -120 to -136 dB; both run the same per-block recursion, and
  the stages before the sweep round apart by an ulp here and there:
  tests/test_torch_block.py);
- the silence bypass: bit-equal (a copy of the input);
- a stretch or a pitch map makes the recursion chaotic: that gate is in
  tests/test_torch_streaming_chaos.py.
It also mirrors the five streaming tests of tests/test_streaming.py that
need no oracle (own single call, silence bypass, checkpoint resume,
latencies, output_seek alignment), on the port.

JAX compiles one program per call shape and stream object, so each test
keeps one JAX stream and resets it, and the chunkings repeat shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
import signalsmith_stretch_tpu as jsst  # noqa: E402
from signalsmith_stretch_torch import SignalsmithStretch, convert  # noqa
from signalsmith_stretch_torch import spectral  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.streaming import StreamingStretch  # noqa
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa
from signalsmith_stretch_tpu.streaming import StreamingStretch as JStream  # noqa

f32 = np.float32
IDENTITY_DB = -100.0


def _pair(channels, rate, seed=1, semitones=0.0, tonality=0.0):
    """A port stream on the CPU and a JAX stream, alike (cheaper preset)."""
    cfg = StretchConfig.preset_cheaper(channels, rate, False)
    jcfg = JConfig.preset_cheaper(channels, rate, False)
    mult = f32(2.0 ** (f32(semitones) / f32(12)))
    limit = f32(f32(tonality) / f32(np.sqrt(mult))) if tonality else f32(1)
    mapped = semitones != 0
    port = StreamingStretch(
        cfg, spectral.Controls.make(mult, limit),
        spectral.SpectralFlags(mapped), seed=seed, device="cpu")
    ref = JStream(jcfg, jspectral.Controls.make(mult, limit),
                  jspectral.SpectralFlags(mapped, False, False), seed=seed)
    return port, ref, cfg


def _drive(s, cfg, sig, chunk, time_f=1.0):
    """tests/test_streaming.py's `_stream_render` on a stream object:
    seek(inputLatency), process in chunks, flush.  Returns the calls'
    outputs."""
    in_lat = cfg.input_latency
    L = sig.shape[1]
    Lout = int(round(L * time_f))
    pad = np.concatenate([sig, np.zeros((sig.shape[0], in_lat), f32)], 1)
    s.seek(pad[:, :in_lat], 1.0 / time_f)
    outs, done, in_done = [], 0, 0
    while done < Lout:
        n = min(chunk, Lout - done)
        in_target = min(int(round((done + n) * L / Lout)), L)
        outs.append(s.process(pad[:, in_lat + in_done:in_lat + in_target], n))
        in_done = in_target
        done += n
    outs.append(s.flush(cfg.output_latency + cfg.input_latency))
    return outs


def _assert_calls_match(got, want, gate=IDENTITY_DB):
    """Each call's output within `gate` of JAX's: the error's energy over
    the call against the mean energy of JAX's whole stream (a call in the
    latency or in silence holds only residue, against which a relative
    error means nothing); a stream of zeros must be zeros."""
    assert len(got) == len(want)
    power = np.mean(np.concatenate(want, 1).astype(np.float64) ** 2)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32, (i, g.shape)
        if power == 0:
            np.testing.assert_array_equal(g, w)
            continue
        err = np.mean((g.astype(np.float64) - w) ** 2) if g.size else 0.0
        db = 10 * np.log10(err / power + 1e-30)
        assert db < gate, (i, db)


# ---- the five streaming tests of tests/test_streaming.py without oracle ----
def test_stream_matches_own_single_call(test_signal):
    """Call-splitting invariance within the port (tests/test_streaming.py
    :63), each chunking held to JAX's, call by call."""
    sig, rate = test_signal
    port, ref, cfg = _pair(1, rate)
    L = sig.shape[1]
    outs = {}
    for chunk in (L, 320):
        got = _drive(port, cfg, sig, chunk)
        _assert_calls_match(got, _drive(ref, cfg, sig, chunk))
        outs[chunk] = np.concatenate(got, 1)
        port.reset(1)
        ref.reset(1)
    db = rel_err_db(outs[L][:, :L], outs[320][:, :L])
    assert db < -60, db


def test_silence_bypass(test_signal):
    """>= 2*block of silence switches to passthrough (:73): the probe comes
    back verbatim, bit-equal to JAX's; the calls before it within -100 dB."""
    sig, rate = test_signal
    port, ref, cfg = _pair(1, rate, seed=0)
    silence = np.zeros((1, 2 * cfg.block_samples + 100), f32)
    probe = (np.arange(500, dtype=f32) * f32(1e-12))[None, :]
    outs = []
    for s in (port, ref):
        s.seek(sig[:, :cfg.input_latency], 1.0)
        outs.append([s.process(sig[:, :4000], 4000),
                     s.process(silence, silence.shape[1]),
                     s.process(probe, 700)])
    _assert_calls_match(outs[0][:2], outs[1][:2])
    np.testing.assert_array_equal(outs[0][2], probe[:, np.arange(700) % 500])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_state_checkpoint_resume(test_signal):
    """state_dict/load_state_dict mid-stream continues identically (:92),
    into a stream of another seed; the continuation held to JAX's."""
    sig, rate = test_signal
    port, ref, cfg = _pair(1, rate, seed=3)
    for s in (port, ref):
        s.seek(sig[:, :cfg.input_latency], 1.0)
    first = [s.process(sig[:, :4000], 4000) for s in (port, ref)]
    snap = port.state_dict()
    a = port.process(sig[:, 4000:8000], 4000)
    other = StreamingStretch(port.cfg, port.controls, port.flags, seed=99,
                             device="cpu")
    other.load_state_dict(snap)
    b = other.process(sig[:, 4000:8000], 4000)
    np.testing.assert_array_equal(a, b)
    _assert_calls_match([first[0], a],
                        [first[1], ref.process(sig[:, 4000:8000], 4000)])


def test_latency_semantics(test_signal):
    """After seek(inputLatency) the output is the input delayed by
    outputLatency (:110), and JAX's, call by call."""
    sig, rate = test_signal
    port, ref, cfg = _pair(1, rate)
    got = _drive(port, cfg, sig, 512)
    _assert_calls_match(got, _drive(ref, cfg, sig, 512))
    out = np.concatenate(got, 1)
    lat = cfg.output_latency
    db = rel_err_db(out[:, 8000 + lat:20000 + lat], sig[:, 8000:20000])
    assert db < -55, db


def test_api_output_seek_alignment(test_signal):
    """outputSeek pre-rolls so the next process() aligns with the start of
    the supplied audio (:146), through the library objects."""
    sig, rate = test_signal
    outs = []
    for s in (SignalsmithStretch(seed=1, device="cpu"),
              jsst.SignalsmithStretch(seed=1)):
        s.preset_cheaper(1, rate, False)
        seek_len = s.output_seek_length(1.0)
        s.output_seek(sig[:, :seek_len])
        outs.append(s.process(sig[:, seek_len:seek_len + 4000], 4000))
    _assert_calls_match(outs[:1], outs[1:])
    sl = slice(1000, 3800)
    db = rel_err_db(outs[0][:, sl], sig[:, sl])
    assert db < -40, db


# ---- call by call against JAX -------------------------------------------
def _sequence(s, sig, cfg):
    """A stream's life: output_seek, chunks of 160, 512 and 1024, a seek
    mid-stream, output_seek again, 2*block of silence and sound again, a
    flush at rate 0, a reset, and more sound.  Returns the outputs."""
    block = cfg.block_samples
    seek_len = cfg.output_seek_length(1.0)
    outs = []
    s.output_seek(sig[:, :seek_len])
    at = seek_len
    for n in (160, 512, 1024, 160, 512, 1024):
        outs.append(s.process(sig[:, at:at + n], n))
        at += n
    s.seek(sig[:, 6000:6000 + cfg.seek_length], 1.0)
    at = 6000 + cfg.seek_length
    for n in (512, 512):
        outs.append(s.process(sig[:, at:at + n], n))
        at += n
    s.output_seek(sig[:, at:at + seek_len])
    at += seek_len
    outs.append(s.process(sig[:, at:at + 1024], 1024))
    at += 1024
    silence = np.zeros((sig.shape[0], 2 * block + 100), f32)
    outs.append(s.process(silence, silence.shape[1]))
    outs.append(s.process(silence[:, :160], 160))          # in the bypass
    for n in (1024, 512):                                  # sound again
        outs.append(s.process(sig[:, at:at + n], n))
        at += n
    outs.append(s.flush(cfg.output_latency + cfg.input_latency))
    s.reset()
    s.seek(sig[:, :cfg.input_latency], 1.0)
    outs.append(s.process(sig[:, :1024], 1024))
    return outs


def test_sequence_matches_jax_call_by_call(stereo_signal):
    sig, rate = stereo_signal
    port, ref, cfg = _pair(2, rate)
    _assert_calls_match(_sequence(port, sig, cfg), _sequence(ref, sig, cfg))


def test_jax_state_continues_in_port(stereo_signal):
    """JAX's state_dict() mid-stream, carried into the port by convert, goes
    on as JAX goes on; and the port's state carried back goes on in JAX."""
    sig, rate = stereo_signal
    port, ref, cfg = _pair(2, rate, seed=5)
    ref.seek(sig[:, :cfg.input_latency], 1.0)
    ref.process(sig[:, :3000], 3000)
    port.state = convert.stream_state_from_arrays(ref.state_dict())
    assert port.state.carry.rng == tuple(
        int(w) for w in np.asarray(ref.state.carry.rng))
    calls = [(sig[:, 3000:3512], 512), (sig[:, 3512:5012], 1500)]
    _assert_calls_match([port.process(*c) for c in calls],
                        [ref.process(*c) for c in calls])
    back = port.state_dict()
    back["carry"] = jspectral.SpectralCarry(**back["carry"])
    ref.load_state_dict(back)
    call = (sig[:, 5012:6036], 1024)
    _assert_calls_match([ref.process(*call)], [port.process(*call)])
