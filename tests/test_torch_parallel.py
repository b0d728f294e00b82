"""The port's parallel layer (parallel/batch.py, timechunk.py,
distributed.py, dryrun.py) against the JAX package's, on the CPU.

Tolerances.
- Splits: bit equality.  A batch or a long clip's chunks split over the
  mesh ("cpu", "cpu") render each clip as the unsplit render does.
- Against JAX, the render gates of tests/test_torch_render.py: unmapped at
  1.0x within -100 dB of JAX's render; a stretch or a pitch map within 6 dB
  of JAX's own response to a 1-ulp change of its input, band energies
  within 3 dB.  The change is taken up and down and the larger response
  counts (as in tests/test_torch_streaming_chaos.py): on the first clip
  of the +3 semitone batch the nudge up moves JAX's render by -84.6 dB and
  the nudge down by -41.7 dB, and the port lies -49.2 dB from it.
- Time chunks against the monolithic render, JAX's own gates
  (tests/test_sharding.py:45-84): short-time envelopes within 1.5 dB away
  from the seams, the first chunk within -19 dB; the chunk levels within
  a factor of 2.
- plan_chunks: equal to JAX's.  The two-process dry run: bit equality
  between the processes' allgathered results and one process's render.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from conftest import rel_err_db  # noqa: E402
from test_torch_render import _band_energy_db  # noqa: E402
from signalsmith_stretch_torch import engine, spectral  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.parallel import batch as pbatch  # noqa: E402
from signalsmith_stretch_torch.parallel import distributed as dist  # noqa
from signalsmith_stretch_torch.parallel import dryrun, timechunk  # noqa
from signalsmith_stretch_tpu import engine as jengine  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa
from signalsmith_stretch_tpu.parallel import batch as jbatch  # noqa: E402
from signalsmith_stretch_tpu.parallel import timechunk as jtimechunk  # noqa

f32 = np.float32
RATE = 8000
CPU2 = ("cpu", "cpu")
# (controls, flags) of both packages: unmapped, and +3 semitones with a
# 2 kHz tonality limit
SETTINGS = {
    "unmapped": (spectral.Controls.make(), spectral.SpectralFlags(False),
                 jspectral.Controls.make(),
                 jspectral.SpectralFlags(False, False, False)),
    "pitch+3": (spectral.Controls.make(1.1892071, 0.25 / 1.0905077),
                spectral.SpectralFlags(True),
                jspectral.Controls.make(1.1892071, 0.25 / 1.0905077),
                jspectral.SpectralFlags(True, False, False)),
}


def _render_gate(got, want, probes, ratio, setting):
    """tests/test_torch_render.py's gates; probes are JAX's renders of the
    input nudged up and down by one ulp."""
    assert got.shape == want.shape and np.isfinite(got).all()
    if ratio == 1.0 and setting == "unmapped":
        assert rel_err_db(got, want) < -100
        return
    dev = rel_err_db(got, want)
    sens = [rel_err_db(p, want) for p in probes]
    assert dev < max(sens) + 6.0, (dev, sens)
    assert np.abs(_band_energy_db(got) - _band_energy_db(want)).max() <= 3.0


def _nudged(x):
    return [np.nextafter(x, f32(way)) for way in (np.inf, -np.inf)]


def _clips(sig, n=4):
    rng = np.random.default_rng(0)
    return (sig[:, :8000][None] + 0.01 * rng.standard_normal((n, 1, 8000))
            ).astype(f32)


def test_plan_chunks_equals_jax():
    cfg = StretchConfig.preset_cheaper(2, RATE, False)
    jcfg = JConfig.preset_cheaper(2, RATE, False)
    for in_s, out_s, n in [(24000, 30000, 4), (24000, 30000, 8),
                           (24001, 29999, 3), (100000, 50000, 7),
                           (48000, 48000, 1), (2880000, 3600000, 8),
                           (12345, 54321, 5)]:
        assert (timechunk.plan_chunks(cfg, in_s, out_s, n)
                == jtimechunk.plan_chunks(jcfg, in_s, out_s, n))


@pytest.mark.parametrize("ratio,setting", [(1.0, "unmapped"),
                                           (1.25, "unmapped"),
                                           (1.0, "pitch+3")])
def test_batch_render_matches_jax_and_splits(test_signal, ratio, setting):
    sig, _ = test_signal
    out_len = int(8000 * ratio)
    cfg = StretchConfig.preset_cheaper(1, RATE, False)
    jcfg = JConfig.preset_cheaper(1, RATE, False)
    controls, flags, jcontrols, jflags = SETTINGS[setting]
    clips = _clips(sig)
    seeds = np.arange(4, dtype=np.int32) + 7
    plan = engine.build_exact_plan(cfg, 8000, out_len)
    whole = pbatch.batch_render(plan, flags, device="cpu")(
        clips, controls, seeds)
    split = pbatch.batch_render(plan, flags, mesh=CPU2)(clips, controls, seeds)
    assert torch.equal(whole, split)
    model = StretchModel(cfg, controls, flags, 8000, out_len, plan=plan,
                         device="cpu")
    assert torch.equal(whole, model.batched(clips, seeds))
    jrun = jbatch.batch_render(jengine.build_exact_plan(jcfg, 8000, out_len),
                               jflags)
    want = np.asarray(jrun(jnp.asarray(clips), jcontrols, jnp.asarray(seeds)))
    probes = [np.asarray(jrun(jnp.asarray(x), jcontrols, jnp.asarray(seeds)))
              for x in _nudged(clips)]
    _render_gate(whole.numpy(), want, probes, ratio, setting)


@pytest.mark.parametrize("ratio,setting", [(1.0, "unmapped"),
                                           (1.25, "unmapped")])
def test_stretch_long_matches_jax_and_splits(test_signal, ratio, setting):
    sig, _ = test_signal
    out = int(sig.shape[1] * ratio)
    cfg = StretchConfig.preset_cheaper(1, RATE, False)
    jcfg = JConfig.preset_cheaper(1, RATE, False)
    controls, flags, jcontrols, jflags = SETTINGS[setting]
    got = timechunk.stretch_long(sig, out, cfg, controls, flags, n_chunks=4,
                                 seed=3, device="cpu")
    split = timechunk.stretch_long(sig, out, cfg, controls, flags,
                                   n_chunks=4, seed=3, mesh=CPU2)
    np.testing.assert_array_equal(got, split)
    want = jtimechunk.stretch_long(sig, out, jcfg, jcontrols, jflags,
                                   n_chunks=4, seed=3)
    probes = [jtimechunk.stretch_long(x, out, jcfg, jcontrols, jflags,
                                      n_chunks=4, seed=3)
              for x in _nudged(sig)]
    _render_gate(got, want, probes, ratio, setting)


def test_timechunk_long_clip(test_signal):
    """tests/test_sharding.py:45 on the port: the chunked render against
    the monolithic one, on envelopes away from the seams and on the first
    chunk's samples; and the levels across the seams."""
    sig, _ = test_signal
    cfg = StretchConfig.preset_cheaper(1, RATE, False)
    out_samples = int(sig.shape[1] * 1.25)
    chunked = timechunk.stretch_long(sig, out_samples, cfg,
                                     spectral.Controls.make(),
                                     spectral.SpectralFlags(False),
                                     n_chunks=4, device="cpu")
    assert chunked.shape == (1, out_samples)
    mono = StretchModel.build(1, RATE, sig.shape[1], out_samples,
                              cheaper=True, device="cpu")(sig).numpy()
    win = RATE // 50
    n = out_samples // win

    def env(x):
        return np.sqrt(np.mean(x[0, :n * win].reshape(n, win) ** 2, axis=1))

    ratio_db = 20 * np.log10((env(chunked) + 1e-9) / (env(mono) + 1e-9))
    per = -(-out_samples // 4)
    seam = {b // win + d for b in (per, 2 * per, 3 * per) for d in (-1, 0, 1)}
    keep = [i for i in range(1, n - 1) if i not in seam]
    assert np.max(np.abs(ratio_db[keep])) < 1.5, ratio_db
    db0 = rel_err_db(chunked[:, 2000:out_samples // 4 - 8],
                     mono[:, 2000:out_samples // 4 - 8])
    assert db0 < -19, db0
    seg = out_samples // 8
    rms = [float(np.sqrt(np.mean(chunked[:, i * seg:(i + 1) * seg] ** 2)))
           for i in range(1, 7)]
    assert min(rms) > 0.5 * max(rms), rms


def test_single_process_fallbacks():
    """Without a coordinator the helpers work on this process alone
    (tests/test_distributed.py:54)."""
    assert dist.initialize(device="cpu") is False
    assert dist.process_count() == 1 and dist.process_index() == 0
    items = list(range(10))
    assert dist.shard_items(items) == items
    assert dist.shard_items(items, 1, 3) == [3, 4, 5]
    mesh = dist.global_mesh("cpu")
    assert mesh == (torch.device("cpu"),)
    x = dist.global_batch(np.arange(24, dtype=f32).reshape(8, 3), mesh)
    assert len(x) == 1 and x[0].shape == (8, 3)
    back = dist.allgather(x)
    assert back.shape == (8, 3)
    np.testing.assert_array_equal(back, np.arange(24, dtype=f32).reshape(8, 3))


def test_dryrun_multichip_two_processes():
    """Two gloo processes: both legs allgathered, bit-equal to one
    process's render (the run's own limit: 120 s)."""
    dryrun.dryrun_multichip(2)


def test_mesh_rules():
    """The mesh defaults to every card and raises without one; a batch must
    split evenly over the mesh, as for a NamedSharding."""
    if torch.cuda.is_available():
        assert len(pbatch.make_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pbatch.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.global_mesh()
    assert pbatch.make_mesh(1, devices=CPU2) == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="evenly"):
        pbatch.shard_batch(np.zeros((3, 1, 4), f32), CPU2)
    parts = pbatch.shard_batch(np.arange(8).reshape(4, 2), CPU2)
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
