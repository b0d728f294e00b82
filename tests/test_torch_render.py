"""Whole renders of the port against the JAX package's, on the CPU, and the
port's entry-point contract.

Tolerances.  At 1.0x the phase recursion is stable and the port's render is
held within -100 dB of the JAX render (measured -129 dB).  A stretch or a
pitch map makes it chaotic: a 1-ulp change of the input already moves the
JAX render by -30 to -40 dB (docs/PARITY.md).  There the gate is
chaos-relative: the port's distance from the JAX render within 6 dB of the
JAX render's own distance from its render of the 1-ulp-nudged input, and
the band energies within 3 dB (measured: the port 2.0 to 3.2 dB further
from the JAX render than the nudge at 1.25x and at +12 semitones, 1.5 dB
closer at both; band energies within 0.22 dB).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_tpu.models import StretchModel as JModel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _band_energy_db(x, nbands=24):
    spec = np.abs(np.fft.rfft(x * np.hanning(x.shape[-1]), axis=-1)) ** 2
    edges = np.linspace(0, spec.shape[-1], nbands + 1, dtype=int)
    e = np.stack([spec[..., a:b].sum(-1) for a, b in zip(edges, edges[1:])],
                 -1)
    return 10 * np.log10(e + 1e-20)


def _models(sig, rate, ratio, **kw):
    n = sig.shape[1]
    out = int(round(n * ratio))
    return (StretchModel.build(sig.shape[0], rate, n, out, device="cpu", **kw),
            JModel.build(sig.shape[0], rate, n, out, **kw))


def _jax_render(jm, *clips):
    """JAX renders of the given clips through one compiled program."""
    fn = jax.jit(jm.__call__)
    outs = [np.asarray(fn(jnp.asarray(c))) for c in clips]
    return outs[0] if len(outs) == 1 else outs


def test_identity_matches_jax(stereo_signal):
    sig, rate = stereo_signal
    model, jm = _models(sig, rate, 1.0)
    got = model(sig).numpy()
    ref = _jax_render(jm, sig)
    assert got.shape == ref.shape == sig.shape
    assert rel_err_db(got, ref) < -100


@pytest.mark.parametrize("ratio,kw", [
    (1.25, {}),
    (1.0, dict(semitones=12, tonality_hz=2000)),
    (1.25, dict(semitones=12, tonality_hz=2000)),
], ids=["1.25x", "pitch+12", "1.25x_pitch+12"])
def test_chaos_relative_to_jax(stereo_signal, ratio, kw):
    sig, rate = stereo_signal
    model, jm = _models(sig, rate, ratio, **kw)
    got = model(sig).numpy()
    nudged = np.nextafter(sig, np.float32(np.inf)).astype(np.float32)
    ref, ref_nudged = _jax_render(jm, sig, nudged)
    sens = rel_err_db(ref_nudged, ref)
    dev = rel_err_db(got, ref)
    assert got.shape == ref.shape
    assert dev < sens + 6.0, (dev, sens)
    assert np.abs(_band_energy_db(got) - _band_energy_db(ref)).max() <= 3.0


def test_mono_cheaper_split_matches_jax(test_signal):
    """Another preset, channel count and latency: the cheaper preset with
    split computation on the 3 s mono fixture, at 1.0x."""
    sig, rate = test_signal
    model, jm = _models(sig, rate, 1.0, cheaper=True, split=True)
    assert model.cfg.split_computation and model.cfg.channels == 1
    assert rel_err_db(model(sig).numpy(), _jax_render(jm, sig)) < -100


def test_invalid_plan_renders_zeros():
    """Shorter than the seek length: exact() refuses and renders zeros."""
    sig = np.ones((2, 500), np.float32)
    model, jm = _models(sig, 8000, 1.2)
    got = model.batched(sig[None]).numpy()
    assert got.shape == (1, 2, 600) and not got.any()
    assert not _jax_render(jm, sig).any()


def test_batch_renders_each_clip(stereo_signal):
    """A batch renders each clip as it renders alone, bit for bit, and
    forward() is batched() of one clip."""
    sig, rate = stereo_signal
    model, _ = _models(sig, rate, 1.25, semitones=12, tonality_hz=2000)
    clips = np.stack([sig, 0.5 * sig[::-1], np.zeros_like(sig)])
    both = model.batched(clips)
    assert both.shape == (3, 2, model.out_samples)
    for i, clip in enumerate(clips):
        assert torch.equal(both[i], model(clip))
    assert not both[2].any()


def test_batched_rejects_wrong_shape(stereo_signal):
    sig, rate = stereo_signal
    model, _ = _models(sig, rate, 1.0)
    with pytest.raises(ValueError):
        model.batched(sig[None, :1])


def test_default_device_is_cuda():
    """Entry points run on the card unless the CPU is asked for: without a
    card, building a model with the default device raises."""
    if torch.cuda.is_available():
        model = StretchModel.build(2, 8000, 16000, 16000)
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StretchModel.build(2, 8000, 16000, 16000)


def test_port_imports_no_jax():
    """Importing every module of the port (the library object, the CLI,
    the dev CLI, the profiling utilities, the I/O, the draws and kernel
    I's wrapper, the streaming engine, the block sweep, the scheduler and
    worklet host, the checkpoints, the evaluation helpers, the corpus
    pipeline and the parallel layer among them) leaves jax and the JAX
    package out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import signalsmith_stretch_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'signalsmith_stretch_tpu')]\n"
        "assert len(names) >= 28, names\n"
        "for n in ('api', 'cli', 'cli_dev', 'io', 'io.wav', 'prng',\n"
        "          'ops.draws',\n"
        "          'utils', 'utils.profiling', 'streaming',\n"
        "          'ops.block_sweep', 'scheduler', 'worklet',\n"
        "          'utils.checkpoint', 'utils.evaluation', 'io.corpus',\n"
        "          'parallel', 'parallel.batch', 'parallel.timechunk',\n"
        "          'parallel.distributed', 'parallel.dryrun'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
