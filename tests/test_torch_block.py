"""The streaming engine's block step against the JAX package's, on the CPU.

- `ops.block_sweep.block_sweep_plain` (the plain version of kernel H)
  against JAX `spectral._sweep_scan`, compiled: bit equality at 1, 2 and
  3 channels, on random inputs with zero energies and weak phases (XLA
  contracts each complex product and squared magnitude of the compiled
  scan into fused multiply-adds, and the plain version rounds at the same
  places).
- `spectral.process_block` against JAX `spectral.process_block`, compiled
  as `_process_impl` reaches it, on the same carry and block inputs (a
  carry that JAX's own blocks built from the stereo fixture): the output
  spectrum and every carry field, the key word for word.  The two round
  apart in the stages before the sweep: JAX's smoothing and envelope are
  associative scans where the port's are the reference's serial passes,
  and XLA contracts products into the following sums (the lerp, the
  twists, the estimate's smoothing, the output map) where eager torch
  rounds twice.  So the gate is relative: each tensor within REL of the
  largest magnitude of JAX's (measured: 5e-8 to 1.2e-7 unmapped, 2e-6 to
  7.3e-6 mapped, on the output; the input and prevInput fields and the
  estimate's two values bit-equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import prng, spectral  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.ops import block_sweep  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu import stft as jstft  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa
from test_torch_cuda import max_ch_pattern  # noqa: E402

f32 = np.float32
LV = 6
REL = 1e-5


def _random_sweep_inputs(ch, B, seed=0):
    rng = np.random.default_rng(seed)

    def c(*s):
        return (rng.standard_normal(s)
                + 1j * rng.standard_normal(s)).astype(np.complex64)

    st, lt, pu, pim = c(B), c(B), c(B), c(B)
    pem = rng.uniform(0, 1, B).astype(f32)
    mc = rng.integers(0, ch, B).astype(np.int32)
    ct, pi = c(ch, B), c(ch, B)
    pe = rng.uniform(0, 1, (ch, B)).astype(f32)
    pe[:, :20] = 0                        # silent bins: zero outputs
    pem[:20] = 0
    for z in (pu, st, lt):                # weak lead phases
        z[100:200] *= f32(1e-9)
    ct[:, 300:400] *= f32(1e-9)           # weak locked phases
    return st, lt, pu, pem, pim, mc, ct, pe, pi


@pytest.mark.parametrize("ch", [1, 2, 3])
def test_block_sweep_plain_matches_jax(ch):
    args = _random_sweep_inputs(ch, 1024, seed=ch)
    fn = jax.jit(lambda *a: jspectral._sweep_scan(*a, ch=ch, longv=LV))
    want = np.asarray(fn(*args))
    x = block_sweep.BlockSweepInputs(*[torch.as_tensor(a) for a in args])
    got = block_sweep.block_sweep(x, LV).numpy()     # CPU: the plain version
    assert got.shape == want.shape == (ch, 1024)
    for part in (np.real, np.imag):
        np.testing.assert_array_equal(part(got).view(np.int32),
                                      part(want).view(np.int32))


# ---------------------------------------------------------------------------
# kernel H's schedule (csrc/block_sweep.cu) replayed on the CPU
# ---------------------------------------------------------------------------
def schedule_model(args, longv, tile=block_sweep.TILE):
    """Kernel H's order of operations in numpy float32: the helpers stage
    each tile's records (the chain's, with the inputs of a lock at a lead
    change, and the early lock's; ones where no lane uses a value); lane 0
    carries the lead across bins and locks in place only where mc[b] !=
    mc[b-1]; lanes 1-31 form the early lock of bin b+2 from the lead of
    b+2-LV (through -0 additions, which keep every bit), which lane 0
    takes by a shuffle a bin later and uses at b+2 (LV >= 4; below that
    lane 0 forms downl in place); every lane keeps the leads in a ring of
    H slots (H the least power of two above LV, zeros at first), written
    and read as the kernel does; the helpers then form every channel's
    outputs of the tile from its leads.  Returns [ch, B] complex64."""
    st, lt, pu, pem, pim, mc, ct, pe, pi = args
    ch, B = pe.shape
    cm, mo = block_sweep._cmul1, block_sweep._make_output1
    zero, nzero = (f32(0), f32(0)), (f32(-0.0), f32(-0.0))
    one = (f32(1), f32(0))
    early = longv >= 4
    H = 2
    while H <= longv:
        H *= 2
    off = 3 - longv if early else 1 - longv

    def c2(z):
        return f32(z.real), f32(z.imag)

    def stage(b):
        m = mc[b]
        chg1 = b > 0 and mc[b - 1] != m
        chgl = not early and b >= longv and mc[b - longv] != m
        rec = dict(tw=c2(st[b]) if b > 0 else zero, pu=c2(pu[b]),
                   f=c2(pim[b]), pe=pem[b],
                   lt=c2(lt[b]) if b >= longv else zero, ctc=one, pic=one,
                   pec=f32(1), flag=int(chg1) | int(chgl) << 1)
        if chg1:
            rec.update(ctc=c2(ct[m, b - 1]), pic=c2(pi[m, b - 1]),
                       pec=pe[m, b - 1])
        erec = dict(tw=one, f=one, pe=f32(1), pu=nzero, same=True)
        k = None
        if early and longv <= b + 2 < B:
            k = (mc[b + 2], b + 2 - longv)
            erec["same"] = mc[b + 2 - longv] == k[0]
        elif not early and b >= longv:
            k = (m, b - longv)
        if k is not None:
            erec.update(tw=c2(ct[k]), f=c2(pi[k]), pe=pe[k])
        return rec, erec

    with np.errstate(all="ignore"):
        # o: lane 0's lead of the previous bin; L: the lanes' ring read (the
        # early lock's lead, or lane 0's lead of b-LV); dlv: lane 1's result
        o, L, dl, dlv = zero, zero, zero, zero
        ring = [zero] * H
        out = np.zeros((ch, B), np.complex64)
        for base in range(0, B, tile):
            n = min(tile, B - base)
            staged = [stage(base + i) for i in range(n)]
            leads = np.zeros(n, np.complex64)
            for i, (r, e) in enumerate(staged):
                b = base + i
                lnew, x = o, dlv                      # the two shuffles
                # lane 0: down1 carried, locked in place at a lead change
                d1 = o
                if r["flag"] & 1:
                    d1 = mo(r["pec"], *r["pic"], *cm(*o, *r["ctc"]))
                if not early:
                    dl = o if longv == 1 else L
                    if r["flag"] & 2:
                        dl = mo(e["pe"], *e["f"], *cm(*dl, *e["tw"]))
                v2 = cm(*dl, *r["lt"])
                v1 = cm(*d1, *r["tw"])
                o0 = mo(r["pe"], *r["f"], (r["pu"][0] + v1[0]) + v2[0],
                        (r["pu"][1] + v1[1]) + v2[1])
                leads[i] = complex(*o0)
                # lanes 1-31: the early lock of bin b+2 from lead b+2-LV
                v1 = cm(*L, *e["tw"])
                o1 = mo(e["pe"], *e["f"], (e["pu"][0] + v1[0]) + nzero[0],
                        (e["pu"][1] + v1[1]) + nzero[1])
                dlv = L if e["same"] else o1
                o = o0
                ring[(b - 1) % H] = lnew
                L = ring[(b + off) % H]
                if early:
                    dl = x
            # the helpers: every channel's outputs of the tile
            sl = slice(base, base + n)
            lr, li = leads.real[None], leads.imag[None]
            tr, ti = block_sweep._cmul(lr, li, ct[:, sl].real, ct[:, sl].imag)
            kr, ki = block_sweep._make_output(pe[:, sl], pi[:, sl].real,
                                              pi[:, sl].imag, tr, ti)
            lead = np.arange(ch)[:, None] == mc[None, sl]
            out.real[:, sl] = np.where(lead, lr, kr)
            out.imag[:, sl] = np.where(lead, li, ki)
    return out


SCHED_B = 600


_JAX_SWEEPS = {}


def _jax_sweep(args, ch, longv):
    if (ch, longv) not in _JAX_SWEEPS:
        _JAX_SWEEPS[ch, longv] = jax.jit(
            lambda *a: jspectral._sweep_scan(*a, ch=ch, longv=longv))
    return np.asarray(_JAX_SWEEPS[ch, longv](*args))


def _signed_zero_inputs(ch, B, seed):
    """_random_sweep_inputs with lone zero components, whose signs reach
    the outputs: pu = (-0, y) at b = 0 and at 40-59; weak leads (b in
    100-199) whose fallback pi_max is real, so the lead is (r, +-0), with
    every third bin's ct and the lock inputs imaginary, so a locked phase
    is (+-0, y)."""
    st, lt, pu, pem, pim, mc, ct, pe, pi = _random_sweep_inputs(ch, B, seed)
    for z in (pu[:1], pu[40:60]):
        z.real = f32(-0.0)
    pim[100:200].imag = 0
    ct[:, 100:200:3].real = 0
    ct[:, 101:200:3].real = f32(-0.0)
    return [st, lt, pu, pem, pim, mc, ct, pe, pi]


SCHED_CASES = ([(p, c, LV) for p in ("constant", "every", "run2", "run5",
                                     "run6", "run7", "run300", "early",
                                     "tile_edge", "random")
                for c in (2, 3)]
               + [("constant", 1, LV), ("random", 33, LV),
                  ("every", 33, LV)]
               + [("random", 3, lv) for lv in (1, 2, 3, 4)]
               + [("early", 2, lv) for lv in (3, 4)])


@pytest.mark.parametrize("pattern,ch,longv", SCHED_CASES,
                         ids=[f"{p}-ch{c}-lv{v}" for p, c, v in SCHED_CASES])
def test_block_sweep_schedule_model(pattern, ch, longv):
    """Kernel H's schedule (`schedule_model`) bit-equal to the plain
    version and to JAX's compiled `_sweep_scan`, over patterns of the
    loudest channel: constant, a change at every bin, runs of 2, 5, 6, 7
    and 300 bins, a change at each of b = 1..LV, changes across tile
    edges, random; 1, 2, 3 and 33 channels; LV 6 (the default preset's),
    4 (the shortest early lead) and 1-3 (downl locked in place)."""
    args = _signed_zero_inputs(ch, SCHED_B, seed=ch + 7 * longv)
    args[5] = max_ch_pattern(pattern, ch, SCHED_B, longv)
    got = schedule_model(args, longv)
    want = _jax_sweep(args, ch, longv)
    x = block_sweep.BlockSweepInputs(*[torch.as_tensor(a) for a in args])
    plain = block_sweep.block_sweep_plain(x, longv).numpy()
    assert got.shape == want.shape == (ch, SCHED_B)
    for part in (np.real, np.imag):
        np.testing.assert_array_equal(part(got).view(np.int32),
                                      part(want).view(np.int32))
        np.testing.assert_array_equal(part(plain).view(np.int32),
                                      part(want).view(np.int32))


def test_fma_helpers_round_once():
    """The plain sweep's two fused multiply-adds, on arrays and on
    scalars, against exact rational arithmetic, with exponents near and
    far apart and exact halfway cases."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.standard_normal(400).astype(f32)
    b = rng.standard_normal(400).astype(f32)
    c = (rng.standard_normal(400) * 10.0 ** rng.integers(-12, 12, 400)
         ).astype(f32)
    # a*b + c exactly halfway between two float32 values: 1 + 2^-24 + tiny
    a[:4], b[:4] = f32(1), f32(1 + 2 ** -23)
    c[:4] = [f32(2 ** -24), f32(-2 ** -24), f32(2 ** -49), f32(-2 ** -49)]
    vec = block_sweep._fma(a, b, c)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        near = f32(float(exact))
        cands = [np.nextafter(near, f32(-np.inf)), near,
                 np.nextafter(near, f32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.int32))
                                         & 1))
        assert vec[i] == best and block_sweep._fma1(a[i], b[i], c[i]) == best


# ---------------------------------------------------------------------------
# process_block against JAX's
# ---------------------------------------------------------------------------
RATE = 8000
CASES = {
    # name: (controls kw, flags kw, time factor, new_spectrum, reanalyse)
    "unmapped": ({}, {}, 1.0, True, True),
    "unmapped_1.25": ({}, {}, 0.8, True, False),
    "mapped": (dict(freq_multiplier=2 ** (5 / 12), freq_tonality_limit=0.12),
               dict(mapped=True), 1.0, True, True),
    "formant_fixed": (dict(freq_multiplier=2 ** (5 / 12),
                           freq_tonality_limit=0.12,
                           formant_multiplier=2 ** (3 / 12),
                           formant_base_freq=220 / RATE),
                      dict(mapped=True, process_formants=True,
                           formant_compensation=True, formant_auto=False),
                      1.0, True, True),
    "formant_auto": (dict(formant_multiplier=2 ** (3 / 12)),
                     dict(process_formants=True), 1.0, True, True),
    "random": ({}, {}, 2.5, True, True),
    "random_mapped": (dict(freq_multiplier=2 ** (2 / 12),
                           freq_tonality_limit=0.12),
                      dict(mapped=True), 2.5, True, True),
    "not_new": (dict(freq_multiplier=2 ** (5 / 12), freq_tonality_limit=0.12),
                dict(mapped=True), 1.0, False, False),
    "custom_map": ({}, dict(mapped=True, custom="poly"), 1.0, True, True),
}


def _poly_torch(f):
    """0.8 f^2 + 0.8 f with the inner multiply-add rounded once, as XLA
    compiles its jnp twin on the CPU."""
    c = torch.full_like(f, float(f32(0.8)))
    return f * prng.fma_f32(c, f, c)


def _poly_jax(f):
    return f * (f32(0.8) * f + f32(0.8))


def _setup(name):
    ckw, fkw, tf, new, re = CASES[name]
    fkw = dict(fkw)
    custom = fkw.pop("custom", None)
    cfg = StretchConfig.preset_default(2, RATE)
    jcfg = JConfig.preset_default(2, RATE)
    jc = jspectral.Controls.make(**ckw)
    flags = dict(mapped=False, process_formants=False,
                 formant_compensation=False) | fkw
    jf = jspectral.SpectralFlags(**flags, custom_map=custom and _poly_jax)
    pc = spectral.Controls(*[f32(np.asarray(v)) for v in jc])
    pf = spectral.SpectralFlags(**flags, custom_map=custom and _poly_torch)
    return cfg, jcfg, jc, jf, pc, pf, f32(tf), new, re


def _jax_blocks(sig, jcfg, jc, jf, tf, new, re, n=6, seed=3):
    """JAX's carry after n-1 blocks of the clip (hop one interval), and the
    n-th block's inputs."""
    basis = jstft.StftBasis.for_config(jcfg)
    consts = jspectral.SpectralConsts.for_config(jcfg)
    block, H = jcfg.block_samples, jcfg.interval_samples
    step = jax.jit(lambda carry, xs: jspectral.process_block(
        carry=carry, xs=xs, controls=jc, flags=jf, consts=consts))
    carry = jspectral.SpectralCarry.initial(consts, seed)
    for k in range(n):
        end = block + H + k * H
        spec = jstft.analyze(jnp.asarray(sig[:, end - block:end]), basis)
        prev = jstft.analyze(jnp.asarray(sig[:, end - H - block:end - H]),
                             basis)
        last = k == n - 1
        xs = jspectral.BlockInputs(
            spectrum=spec, prev_spectrum=prev,
            new_spectrum=jnp.asarray(new if last else True),
            reanalyse=jnp.asarray(re if last else True),
            time_factor=jnp.float32(tf if last else 1.0))
        if last:
            before = carry
        carry, out = step(carry, xs)
    return before, xs, carry, out, consts


def _to_port(jcarry, dev="cpu"):
    t = [torch.as_tensor(np.array(v)) for v in jcarry[:4]]
    s = [torch.as_tensor(np.asarray(v, f32).reshape(1)) for v in jcarry[4:6]]
    rng = tuple(int(w) for w in np.asarray(jcarry.rng))
    return spectral.SpectralCarry(*t, *s, rng)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.astype(np.complex128) - want).max()) / scale


@pytest.mark.parametrize("name", list(CASES))
def test_process_block_matches_jax(stereo_signal, name):
    sig, _ = stereo_signal
    cfg, jcfg, jc, jf, pc, pf, tf, new, re = _setup(name)
    before, xs, jcarry, jout, _ = _jax_blocks(sig, jcfg, jc, jf, tf, new, re)
    pxs = spectral.BlockInputs(torch.as_tensor(np.array(xs.spectrum)),
                               torch.as_tensor(np.array(xs.prev_spectrum)),
                               new, re, tf)
    consts = spectral.SpectralConsts.for_config(cfg)
    carry, out = spectral.process_block(_to_port(before), pxs, pc, pf,
                                        consts)
    errs = {"output": _rel(out.numpy(), jout)}
    for f in ("input", "prev_input", "output", "pred_energy"):
        errs[f] = _rel(getattr(carry, f).numpy(), getattr(jcarry, f))
    for f in ("freq_est_weighted", "freq_est_weight"):
        errs[f] = _rel(getattr(carry, f).numpy()[0], getattr(jcarry, f))
    assert carry.rng == tuple(int(w) for w in np.asarray(jcarry.rng))
    assert max(errs.values()) <= REL, errs


if __name__ == "__main__":       # the measured differences, case by case
    import conftest
    sig = conftest.stereo_signal.__wrapped__()[0]
    for name in CASES:
        cfg, jcfg, jc, jf, pc, pf, tf, new, re = _setup(name)
        before, xs, jcarry, jout, _ = _jax_blocks(sig, jcfg, jc, jf, tf, new,
                                                  re)
        pxs = spectral.BlockInputs(
            torch.as_tensor(np.array(xs.spectrum)),
            torch.as_tensor(np.array(xs.prev_spectrum)), new, re, tf)
        carry, out = spectral.process_block(
            _to_port(before), pxs, pc, pf,
            spectral.SpectralConsts.for_config(cfg))
        print(name, {f: f"{_rel(getattr(carry, f).numpy(), getattr(jcarry, f)):.2e}"
                     for f in ("input", "prev_input", "output",
                               "pred_energy")},
              f"{_rel(carry.freq_est_weighted.numpy()[0], jcarry.freq_est_weighted):.2e}",
              carry.rng == tuple(int(w) for w in np.asarray(jcarry.rng)))
