"""Stream-state checkpoints (utils/checkpoint.py) in the port and across
packages, on the CPU.

Tolerance: bit equality.  A stream continued from a checkpoint file goes
on exactly as the same stream continued from its state_dict; a file one
package writes loads in the other, and the two packages write the same
keys, shapes and dtypes for the same state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_streaming import _pair  # noqa: E402
from signalsmith_stretch_torch import convert  # noqa: E402
from signalsmith_stretch_torch.streaming import StreamingStretch  # noqa
from signalsmith_stretch_torch.utils import checkpoint  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.utils import checkpoint as jcheckpoint  # noqa


def _started(sig, semitones=0.0, seed=4):
    """A port stream and a JAX stream, alike, 4000 samples in."""
    port, ref, cfg = _pair(sig.shape[0], 8000, seed=seed, semitones=semitones,
                           tonality=0.25 if semitones else 0.0)
    for s in (port, ref):
        s.seek(sig[:, :cfg.input_latency], 1.0)
        s.process(sig[:, :4000], 4000)
    return port, ref


def test_checkpoint_save_load(tmp_path, test_signal):
    """A port state survives an npz round trip and resumes identically, in
    a stream of another seed (tests/test_components.py:137)."""
    sig, _ = test_signal
    port, _ = _started(sig)
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, port.state)
    a = port.process(sig[:, 4000:8000], 4000)
    other = StreamingStretch(port.cfg, port.controls, port.flags, seed=9,
                             device="cpu")
    other.state = checkpoint.load(path, other.state)
    np.testing.assert_array_equal(other.process(sig[:, 4000:8000], 4000), a)


@pytest.mark.parametrize("semitones", [0.0, 5.0], ids=["1.0x", "pitch+5"])
def test_jax_file_continues_in_port(tmp_path, stereo_signal, semitones):
    """A file JAX's checkpoint.save wrote loads in the port; the port goes
    on exactly as from JAX's state_dict."""
    sig, _ = stereo_signal
    port, ref = _started(sig, semitones)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, ref.state)
    port.state = checkpoint.load(path, port.state)
    a = port.process(sig[:, 4000:6000], 2000)
    port.state = convert.stream_state_from_arrays(ref.state_dict())
    np.testing.assert_array_equal(port.process(sig[:, 4000:6000], 2000), a)


@pytest.mark.parametrize("semitones", [0.0, 5.0], ids=["1.0x", "pitch+5"])
def test_port_file_continues_in_jax(tmp_path, stereo_signal, semitones):
    """A file the port wrote loads in JAX (checkpoint.load with a JAX
    state as the template); JAX goes on exactly as from the port's
    state_dict."""
    sig, _ = stereo_signal
    port, ref = _started(sig, semitones)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, port.state)
    template = ref.state
    ref.state = jcheckpoint.load(path, template)
    a = ref.process(sig[:, 4000:6000], 2000)
    d = port.state_dict()
    d["carry"] = jspectral.SpectralCarry(**d["carry"])
    ref.load_state_dict(d)
    np.testing.assert_array_equal(ref.process(sig[:, 4000:6000], 2000), a)


def test_files_have_jax_keys_and_dtypes(tmp_path, stereo_signal):
    """The two packages' files of one state (a JAX state, and the port's
    copy of it) hold the same keys, shapes and dtypes, and the same
    values."""
    sig, _ = stereo_signal
    port, ref = _started(sig, 5.0)
    port.state = convert.stream_state_from_arrays(ref.state_dict())
    jcheckpoint.save(str(tmp_path / "j.npz"), ref.state)
    checkpoint.save(str(tmp_path / "p.npz"), port.state)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "p.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
            np.testing.assert_array_equal(j[k], p[k])


def test_load_rejects_another_shape(tmp_path, test_signal, stereo_signal):
    """A mono stream's file does not load into a stereo template."""
    mono, _ = _started(test_signal[0])
    stereo, _ = _started(stereo_signal[0])
    path = str(tmp_path / "mono.npz")
    checkpoint.save(path, mono.state)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, stereo.state)
