"""The benchmark's plain reference above 2x (benchmark/reference/draws.py
and render_random.py) against JAX and the port, on the CPU.

Tolerance: bit equality.  The reference's draws are held to
`jax.random.uniform` and the JAX planner's per-block selects
(signalsmith_stretch_tpu/planner.py:481-490); its whole 3x render to the
port's plain path (`StretchModel.batched(plain=True)`), clip by clip from
the same seeds.  JAX is used here only as the yardstick: the reference
itself loads neither JAX nor the port, which a fresh interpreter shows.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmark.reference import (draws, render, render_random,  # noqa: E402
                                 spectral)
from benchmark.reference.geometry import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402

f32 = np.float32
ROOT = Path(__file__).resolve().parents[1]
RATE = 8000
SEEDS = [0, 1, 31, 2 ** 31, 2 ** 32 + 5]
# time factors per block: one block at 3x; seven blocks below 2x, at 2x,
# just above, at 4x (the lower bound 0) and between
TF_ROWS = {1: [3.0],
           7: [0.5, 2.0, float(np.nextafter(f32(2), f32(3))), 4.0, 1.25,
               3.0, 2.5]}


def _jax_factors(seed, tf, B):
    """The JAX planner's expressions (planner.py:481-490), one clip."""
    tf_j = jnp.asarray(tf)
    random_tf = jnp.asarray(tf > f32(2))
    lo_d = f32(2) * 2 * random_tf.astype(jnp.float32) - tf_j
    d = jax.random.uniform(jax.random.PRNGKey(seed), (2, len(tf), B),
                           jnp.float32, lo_d[None, :, None],
                           tf_j[None, :, None])
    return (np.asarray(jnp.where(random_tf[:, None], d[0], tf_j[:, None])),
            np.asarray(jnp.where(random_tf[:, None], d[1], tf_j[:, None])))


@pytest.mark.parametrize("nB", sorted(TF_ROWS))
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(seed, nB):
    """draws.factors against jax.random.uniform and jnp.where, bit for
    bit, for one clip and as the second clip of two."""
    tf = np.asarray(TF_ROWS[nB], f32)
    B = 37
    want = _jax_factors(seed, tf, B)
    got = draws.factors([seed], tf, B)
    pair = draws.factors([seed + 1, seed], tf, B)
    for g, p, w in zip(got, pair, want):
        assert g.shape == (1, nB, B) and p.shape == (2, nB, B)
        np.testing.assert_array_equal(g[0].numpy().view(np.int32),
                                      w.view(np.int32))
        np.testing.assert_array_equal(p[1].numpy().view(np.int32),
                                      w.view(np.int32))


@pytest.mark.parametrize("seeds", [None, [7, 2 ** 31, 2 ** 32 + 5, 1]],
                         ids=["default", "given"])
def test_render_is_the_ports_plain_path(seeds):
    """4 clips of 1 s at 8 kHz, stereo, at 3x (every block draws), one of
    them half silent: the reference's render from the clips' seeds (the
    port's default 0..3, or given) equals the port's plain render."""
    n_in = RATE
    n_out = 3 * n_in
    rng = np.random.default_rng(11)
    audio = (0.3 * rng.standard_normal((4, 2, n_in))).astype(f32)
    audio[1, :, :n_in // 2] = 0
    port = StretchModel.build(2, RATE, n_in, n_out, device="cpu")
    want = port.batched(audio, seeds, plain=True).numpy()
    plan = render.build_exact_plan(StretchConfig.preset_default(2, RATE),
                                   n_in, n_out)
    assert (plan.arrays["time_factor"] > 2).all()
    ctl = spectral.Controls.of(RATE, 0.0, 0.0)
    got = render_random.render(torch.as_tensor(audio), plan, ctl,
                               seeds or range(4)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0.1


def test_reference_loads_neither_the_port_nor_jax():
    code = ("import sys, torch; import benchmark.reference.draws, "
            "benchmark.reference.render_random; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert "benchmark" in tops
    assert not tops & {"signalsmith_stretch_torch", "jax", "jaxlib", "flax",
                       "signalsmith_stretch_tpu"}
