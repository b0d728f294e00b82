"""Kernel J's plain version, `ops/coefficients.coefficients_plain`, on the CPU.

It is the last phase of the port's planner (signalsmith-stretch.h:722-803),
with every complex product written as separate float32 products and sums.
Held:
- bit for bit to the same phase in torch complex64 arithmetic, as the
  planner wrote it before the kernel (`complex_ops`, below), on the
  planner's own intermediates for the 8 kHz stereo fixture: unmapped,
  mapped, both randomised cells, and a schedule on which not every block
  is new; and at the planner tests' tolerance to JAX's planner there;
- bit for bit to `walk_model`, a numpy model of J's walk (one row a CTA,
  each bin's loudest channel, c1 formed at b+1 and b+LV of that channel
  only, the previous block's energy within each clip and 0 at its first
  block, the four edge masks), on random strided planes of 1 to 3
  channels, LV 4 to 6, rows of 300 bins (not a multiple of J's 256
  threads), some blocks not new, ties and zeros among the energies.
torch's own complex product is not a fixed rounding on the CPU: its
vectorised loop rounds each product, its scalar tail (the bins past the
last full vector: here 296-299 of 300) contracts into fused multiply-adds.
At the fixture's 512 bins every bin is in the vectorised loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from signalsmith_stretch_torch import engine, planner  # noqa: E402
from signalsmith_stretch_torch.config import NOISE_FLOOR  # noqa: E402
from signalsmith_stretch_torch.ops import coefficients  # noqa: E402
from signalsmith_stretch_tpu import engine as jengine  # noqa: E402
from signalsmith_stretch_tpu import planner as jplanner  # noqa: E402
from test_torch_planner import _close, _leaves, _models  # noqa: E402

f32 = np.float32
OUTPUTS = ("a1", "a2", "d1", "d2", "mc")


def complex_ops(pi, prev_i, pe, votes, rotor, new, longv):
    """The phase as plan_spectral wrote it before kernel J: torch's
    complex64 products."""
    sel, shift, where0 = (coefficients._sel, coefficients.shift_up,
                          coefficients.where0)
    B = pi[0].shape[-1]
    pe_prev = [F.pad(x[:, :-1], (0, 0, 1, 0)) for x in pe]
    rotor_eff = rotor if new.all() else torch.where(
        torch.as_tensor(new)[:, None], rotor,
        torch.ones((), dtype=rotor.dtype))
    c1 = [planner._cdivr(rotor_eff * (p * torch.conj(q)),
                         torch.maximum(pp, e) + NOISE_FLOOR)
          for p, q, pp, e in zip(pi, prev_i, pe_prev, pe)]
    mc = torch.argmax(torch.stack(pe, 0), 0).to(torch.int32)
    pi_max = sel(mc, pi)
    b = torch.arange(B)
    sd, ld = votes[:2]
    d1 = where0(b > 0, pi_max * torch.conj(sel(mc, sd)))
    d2 = where0(b >= longv, pi_max * torch.conj(sel(mc, ld)))
    if len(votes) == 4:
        us, ul = sel(mc, votes[2]), sel(mc, votes[3])
    else:
        us = sel(mc, [shift(x, 1) for x in sd])
        ul = sel(mc, [shift(x, longv) for x in ld])
    up = [sel(mc, [shift(x, n) for x in xs]) for n in (1, longv)
          for xs in (pi, c1)]
    a1 = where0(b < B - 1, up[1] * torch.conj(up[0] * torch.conj(us)))
    a2 = where0(b < B - longv, up[3] * torch.conj(up[2] * torch.conj(ul)))
    return a1, a2, d1, d2, mc


def _not_all_new(arrays):
    """The schedule with every third block after the first not new (its
    input and prevInput carried from the last new block) and so not
    re-analysed."""
    arrays = dict(arrays)
    new = arrays["new_spectrum"].copy()
    new[2::3] = False
    arrays["new_spectrum"] = new
    arrays["reanalyse"] = arrays["reanalyse"] & new
    return arrays


# the planner tests' cases (time ratio, semitones, tonality limit), and a
# schedule with blocks that are not new
CASES = {"1.25": "1.25", "pitch+12_1.25": "pitch+12_1.25", "3.0": "3.0",
         "pitch+2_2.5": "pitch+2_2.5", "1.25_not_all_new": "1.25",
         "pitch+12_1.0_not_all_new": "pitch+12_1.0"}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_is_the_planners_phase(stereo_signal, case):
    sig, rate = stereo_signal
    model, jm = _models(sig, rate, CASES[case])
    arrays, jarrays = model.plan.arrays, jm.plan.arrays
    if case.endswith("not_all_new"):
        arrays = engine.plan_tables(_not_all_new(arrays), model.cfg)
        jarrays = _not_all_new(jarrays)
        assert not arrays["new_spectrum"].all()
    js, jp = jengine.analyze_stage(jnp.asarray(sig), jm.plan)
    spectra, prev = (torch.as_tensor(np.array(x))[None] for x in (js, jp))
    got, dbg = planner.plan_spectral(
        spectra, prev, arrays, model.controls, model.flags, model.plan.consts,
        debug=True)
    args = dbg["coefficients"]
    assert len(args[3]) == (4 if case in ("3.0", "pitch+2_2.5") else 2)
    for name, x, y in zip(OUTPUTS, coefficients.coefficients_plain(*args),
                          complex_ops(*args)):
        assert torch.equal(x, y), name
    for name, x in zip(OUTPUTS, coefficients.coefficients(*args)):
        assert torch.equal(x, getattr(got, name)), name
    ref = jplanner.plan_spectral(js, jp, jarrays, jm.controls, jm.flags,
                                 jm.plan.consts, 0)
    g, r = _leaves(got, 0), _leaves(ref)
    np.testing.assert_array_equal(g["mc"], r["mc"])
    for k in OUTPUTS[:4]:
        _close(g[k], r[k], k)


def _cmulc(a, b):
    """a * conj(b) on (re, im) float32 pairs, each op rounded."""
    return a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1]


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def walk_model(pi, prev_i, pe, votes, rotor, new, longv):
    """J's walk in numpy: planes as [ch, batch, nB, B] (re, im) float32
    pairs (pe float32), votes a list of such; one row at a time, each
    bin's loudest channel m, c1 of channel m at b+1 and b+LV only."""
    ch, batch, nB, B = pe.shape
    out = {k: np.zeros((2, batch, nB, B), f32) for k in OUTPUTS[:4]}
    out["mc"] = np.zeros((batch, nB, B), np.int32)
    drawn = len(votes) == 4
    up = votes[2:] if drawn else votes[:2]
    b = np.arange(B)
    for clip in range(batch):
        for k in range(nB):
            def at(x, m, j):
                return x[0][m, clip, k, j], x[1][m, clip, k, j]

            m = np.argmax(pe[:, clip, k], 0)           # first of the largest
            rot = ((rotor[0], rotor[1]) if new[k]
                   else (np.ones(B, f32), np.zeros(B, f32)))

            def c1(j):
                t = _cmulc(at(pi, m, j), at(prev_i, m, j))
                u = _cmul((rot[0][j], rot[1][j]), t)
                pp = (pe[m, clip, k - 1, j] if k > 0
                      else np.zeros(len(j), f32))
                den = np.maximum(pp, pe[m, clip, k, j]) + f32(NOISE_FLOOR)
                return u[0] / den, u[1] / den

            def vote(n, down, drawn_up):
                j = np.minimum(b + n, B - 1)   # masked past B - n
                v = at(drawn_up, m, b) if drawn else at(down, m, j)
                return _cmulc(c1(j), _cmulc(at(pi, m, j), v))

            p = at(pi, m, b)
            rows = {"d1": (_cmulc(p, at(votes[0], m, b)), b > 0),
                    "d2": (_cmulc(p, at(votes[1], m, b)), b >= longv),
                    "a1": (vote(1, votes[0], up[0]), b < B - 1),
                    "a2": (vote(longv, votes[1], up[1]), b < B - longv)}
            for name, (v, keep) in rows.items():
                for part in range(2):
                    out[name][part, clip, k] = np.where(keep, v[part], f32(0))
            out["mc"][clip, k] = m
    return out


def _random_case(ch, longv, drawn, seed):
    """Random planes of 2 clips x 3 blocks x 300 bins, pi and pe as channel
    views of [batch, nB, ch, B] tensors, energies with ties and zeros."""
    rng = np.random.default_rng(seed)
    batch, nB, B = 2, 3, 300

    def cplx(*shape):
        return torch.complex(*(torch.as_tensor(rng.standard_normal(shape)
                                                .astype(f32))
                               for _ in range(2)))

    pe_all = torch.as_tensor(rng.uniform(0, 2, (batch, nB, ch, B)).astype(f32))
    pe_all[:, :, :, ::7] = 0.0                          # silent bins
    pe_all[:, :, :, 3::11] = pe_all[:, :, :1, 3::11]    # ties: first wins
    pi = cplx(batch, nB, ch, B).unbind(2)
    prev_i = [cplx(batch, nB, B) for _ in range(ch)]
    votes = [[cplx(batch, nB, B) for _ in range(ch)]
             for _ in range(4 if drawn else 2)]
    rotor = cplx(B)
    new = np.array([True, False, True])
    return pi, prev_i, pe_all.unbind(2), votes, rotor, new, longv


@pytest.mark.parametrize("drawn", [False, True], ids=["shifted", "drawn"])
@pytest.mark.parametrize("longv", [4, 5, 6])
@pytest.mark.parametrize("ch", [1, 2, 3])
def test_walk_model_matches_plain(ch, longv, drawn):
    args = _random_case(ch, longv, drawn, seed=10 * ch + longv)
    pi, prev_i, pe, votes, rotor, new, _ = args

    def pairs(planes):
        z = torch.stack(list(planes)).numpy()
        return z.real.astype(f32), z.imag.astype(f32)

    want = walk_model(pairs(pi), pairs(prev_i), torch.stack(pe).numpy(),
                      [pairs(v) for v in votes],
                      (rotor.real.numpy(), rotor.imag.numpy()), new, longv)
    got = coefficients.coefficients_plain(*args)
    for name, x in zip(OUTPUTS, got):
        x = x.numpy()
        if name != "mc":
            x = np.stack([x.real, x.imag])
        np.testing.assert_array_equal(x.view(np.int32),
                                      want[name].view(np.int32), name)
