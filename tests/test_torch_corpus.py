"""The port's corpus pipeline (io/corpus.py) and evaluation helpers
(utils/evaluation.py) against the JAX package's, on the CPU.

Tolerances: bit equality for the evaluation helpers (numpy copies), for
the buckets and the padded batches (keys, arrays, names, lengths), and for
a batch rendered through the pipeline against the same padded batch
rendered directly.  A clip's stats are the numpy formula; against JAX's
(its native scan when the extension is built) within 1e-6 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch.io import corpus, write_wav  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.utils import evaluation  # noqa: E402
from signalsmith_stretch_tpu.io import corpus as jcorpus  # noqa: E402
from signalsmith_stretch_tpu.utils import evaluation as jevaluation  # noqa

RATE = 8000


@pytest.mark.parametrize("kind", jevaluation.KINDS)
def test_evaluation_bit_equal_to_jax(kind):
    """synth_clip, band_energies and envelope_db of every kind."""
    assert evaluation.KINDS == jevaluation.KINDS
    assert evaluation.KIND_SEEDS == jevaluation.KIND_SEEDS
    assert evaluation.KINDS_BASIC == jevaluation.KINDS_BASIC
    x = evaluation.synth_clip(kind, RATE, 1.5)
    np.testing.assert_array_equal(x, jevaluation.synth_clip(kind, RATE, 1.5))
    assert x.dtype == np.float32 and x.shape == (1, 12000)
    np.testing.assert_array_equal(
        evaluation.synth_clip(kind, RATE, 0.5, seed=3),
        jevaluation.synth_clip(kind, RATE, 0.5, seed=3))
    ref = evaluation.synth_clip("harmonic", RATE, 1.5)
    np.testing.assert_array_equal(evaluation.band_energies(x, RATE),
                                  jevaluation.band_energies(x, RATE))
    assert (evaluation.envelope_db(x, ref, RATE)
            == jevaluation.envelope_db(x, ref, RATE))


def _corpus(tmp_path, sig, lengths):
    paths = []
    for i, n in enumerate(lengths):
        p = str(tmp_path / f"clip{i}.wav")
        write_wav(p, sig[:, (37 * i) % 500:(37 * i) % 500 + n], RATE)
        paths.append(p)
    return paths


def test_corpus_bucketing(tmp_path, test_signal):
    """tests/test_components.py:58 on the port, and its buckets JAX's."""
    sig, _ = test_signal
    paths = _corpus(tmp_path, sig, [8000, 9000, 16000, 16500])
    items = corpus.load_directory(paths, time_factor=1.25)
    jitems = jcorpus.load_directory(paths, time_factor=1.25)
    b = corpus.bucket(items, granule_seconds=1.0)
    jb = jcorpus.bucket(jitems, granule_seconds=1.0)
    assert len(b) == 3               # pads 8000 / 16000(x2) / 24000
    assert list(b) == list(jb)
    for key in b:
        assert [i.name for i in b[key]] == [i.name for i in jb[key]]
        for i, j in zip(b[key], jb[key]):
            np.testing.assert_array_equal(i.audio, j.audio)
    got = list(corpus.batches(items, batch_size=2, prefetch=0, device="cpu"))
    assert sum(x["audio"].shape[0] for x in got) == 4
    peak, rms, te = items[0].stats()
    assert 0 < rms < peak
    np.testing.assert_allclose((peak, rms, te), jitems[0].stats(), rtol=1e-6)


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_batches_match_jax(tmp_path, test_signal, prefetch):
    """The same batches as JAX's, in order: keys, padded audio (a CPU
    tensor here), names, lengths and settings; two settings' buckets."""
    sig, _ = test_signal
    paths = _corpus(tmp_path, sig, [8000, 7000, 12000, 15999, 16000, 4000])
    items = (corpus.load_directory(paths[:4], time_factor=1.25)
             + corpus.load_directory(paths[4:], semitones=3.0))
    jitems = (jcorpus.load_directory(paths[:4], time_factor=1.25)
              + jcorpus.load_directory(paths[4:], semitones=3.0))
    got = list(corpus.batches(items, batch_size=2, prefetch=prefetch,
                              device="cpu"))
    want = list(jcorpus.batches(jitems, batch_size=2, prefetch=0))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert isinstance(g["audio"], torch.Tensor)
        assert g["audio"].device.type == "cpu"
        np.testing.assert_array_equal(g["audio"].numpy(), w["audio"])
        for k in ("key", "names", "lengths", "time_factor", "semitones"):
            assert g[k] == w[k], k


def test_batches_default_device_is_cuda(test_signal):
    items = [corpus.CorpusItem(test_signal[0][:, :800], RATE)]
    if torch.cuda.is_available():
        assert next(corpus.batches(items, 1))["audio"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            next(corpus.batches(items, 1))


def test_mixed_corpus_end_to_end(tmp_path, test_signal):
    """BASELINE #5's shape (tests/test_components.py:151) on the port: a
    mixed-settings corpus through the bucketed pipeline; each batch equals
    the same padded batch rendered directly, bit for bit."""
    sig, _ = test_signal
    paths = _corpus(tmp_path, sig, [8000] * 4)
    items = (corpus.load_directory(paths[:2], time_factor=1.25)
             + corpus.load_directory(paths[2:], time_factor=1.0,
                                     semitones=3.0))
    rendered = {}
    for b in corpus.batches(items, batch_size=4, prefetch=1, device="cpu"):
        rate_b, ch, in_len, tf, st = b["key"]
        model = StretchModel.build(
            channels=ch, sample_rate=rate_b, in_samples=in_len,
            out_samples=int(round(in_len * tf)), semitones=st,
            tonality_hz=2000 if st else 0, cheaper=True, device="cpu")
        out = model.batched(b["audio"])
        padded = np.stack([np.pad(i.audio, ((0, 0), (0, in_len - 8000)))
                           for i in items if i.name in b["names"]])
        assert torch.equal(out, model.batched(padded))
        for j, name in enumerate(b["names"]):
            rendered[name] = out[j].numpy()
    assert len(rendered) == 4
    assert all(np.isfinite(v).all() and np.abs(v).max() > 0.01
               for v in rendered.values())
