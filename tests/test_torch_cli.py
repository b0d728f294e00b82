"""The port's command line and WAV/raw I/O, on the CPU.

The CLI runs in a fresh process with `--device cpu` (the card is the
default); its output has round(n * time) samples and equals the library's
`exact` render of the same input, written the same way: bit for bit in
the raw format, byte for byte as a 16-bit WAV.  The I/O module writes the
files the JAX package's io/wav.py writes, byte for byte.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import SignalsmithStretch  # noqa: E402
from signalsmith_stretch_torch import io as tio  # noqa: E402
from signalsmith_stretch_tpu import io as jio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "signalsmith_stretch_torch.cli",
                        *args, "--device", "cpu"], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "realtime" in r.stdout
    return r


def _exact(sig, rate, time, semitones, seed=0):
    s = SignalsmithStretch(seed=seed, device="cpu")
    s.preset_default(sig.shape[0], rate)
    s.set_transpose_semitones(semitones, 8000 / rate)
    s.set_formant_semitones(0, False)
    s.set_formant_base(0)
    out, ok = s.exact(sig, int(round(sig.shape[1] * time)))
    assert ok
    return out


def test_cli_raw_roundtrip(stereo_signal, tmp_path):
    sig, rate = stereo_signal
    inp, outp = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    tio.write_raw(inp, sig, rate)
    _cli(inp, outp, "--raw", "--time=1.25", "--semitones=3")
    out, orate = tio.read_raw(outp)
    assert orate == rate and out.shape == (2, round(sig.shape[1] * 1.25))
    np.testing.assert_array_equal(out, _exact(sig, rate, 1.25, 3))


def test_cli_wav_roundtrip(stereo_signal, tmp_path):
    """16-bit WAV in and out, at 2.5x (the randomised regime, seed 4): the
    file is the exact render of the WAV's samples, quantised."""
    sig, rate = stereo_signal
    inp, outp = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    ref = str(tmp_path / "ref.wav")
    tio.write_wav(inp, sig, rate)
    _cli(inp, outp, "--time=2.5", "--seed=4")
    pcm, orate = tio.read_wav(inp)
    assert orate == rate
    tio.write_wav(ref, _exact(pcm, rate, 2.5, 0, seed=4), rate)
    with open(outp, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    out, _ = tio.read_wav(outp)
    assert out.shape == (2, round(sig.shape[1] * 2.5))


def test_cli_refuses_missing_input(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "signalsmith_stretch_torch.cli",
                        str(tmp_path / "none.wav"), str(tmp_path / "o.wav"),
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 1 and "cannot read" in r.stderr


def test_io_files_equal_jax(tmp_path):
    """WAV (with samples past full scale, clipped) and raw files: the
    port's bytes are the JAX package's, and each reads the other's."""
    rng = np.random.default_rng(6)
    audio = (rng.standard_normal((3, 1001)) * 0.6).astype(np.float32)
    audio[0, :4] = [1.0, -1.0, 1.5, -1.5]
    for ext, tw, jw in (("wav", tio.write_wav, jio.write_wav),
                        ("raw", tio.write_raw, jio.write_raw)):
        a, b = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        tw(a, audio, 44100)
        jw(b, audio, 44100)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), ext
        tr = tio.read_wav if ext == "wav" else tio.read_raw
        jr = jio.read_wav if ext == "wav" else jio.read_raw
        for got, want in ((tr(b), jr(b)), (tr(a), jr(a))):
            assert got[1] == want[1] == 44100
            np.testing.assert_array_equal(got[0], want[0])
