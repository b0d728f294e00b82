"""Kernels K and L (the synthesis) on the CPU: their tables and algorithms.

Kernel K (csrc/idft.cu) synthesises each block as one complex FFT of half
length M = N/2: a pre-combine of bands b and M-1-b into W = conj(2Z) (Z the
half-length spectrum kernel D post-combines), D's Stockham passes on D's
tables (`dft.RADICES`, the same index maps), and an epilogue that unpacks
the sample pairs, y_2m + i y_2m+1 = conj(X_m pre_m) / N, and applies the
window.  Kernel L (csrc/ola.cu) writes each output sample once from the
blocks over its ring position.  No CPU can run either kernel, so these
tests prove their pieces here:
- K's host tables as K reads them (the window over N; D's pre-twist,
  post-twiddle and pass twiddles conjugated, the inverse's factors) lie
  within half an ulp of their float64 definitions;
- a float64 numpy model of K's algorithm (its pre-combine, its passes'
  index maps and twiddles, its epilogue) agrees with the plain
  `stft.synthesize` (torch.fft) within 3e-6 of the blocks' peak, D's
  tolerance, at the four SHAPES of the DFT tests and at every FFT size D
  is built for;
- a float32 model of L's walk (the grid's samples, the group-order sums,
  the pre-roll term, the WOLA divisions, the tail fold, the bypass
  decisions from the two energies and the restricted-ring tails in block
  order) equals the plain assembly `ola.assemble_plain` bit for bit on
  given blocks, at 1.25x, 1.0x (the +12 st cell's geometry), 3x and 0.2x
  (where the main process bypasses), with loud, silent, sub-noise and
  partially silent clips in one batch;
- both wrappers take their plain versions on a CPU tensor.
The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py): K at 3e-6, L bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import engine, ops, stft  # noqa: E402
from signalsmith_stretch_torch.config import (NOISE_FLOOR,  # noqa: E402
                                              StretchConfig)
from signalsmith_stretch_torch.ops import dft, idft, ola  # noqa: E402

from test_torch_dft import SHAPES, SIZES, TOL  # noqa: E402

f32 = np.float32


def _basis(block, interval):
    return stft.StftBasis.for_config(StretchConfig(2, block, interval))


@pytest.mark.parametrize("block,interval", SHAPES)
def test_tables_match_float64(block, interval):
    """The window over N exact and zero past the block; D's tables,
    conjugated as K applies them, within half an ulp (2^-24 at magnitude
    1) of the inverse's factors: e^{+iπm/M} (the epilogue's twist),
    e^{+2πi(b+0.5)/N} (the pre-combine) and e^{+2πi r k/(NS R)} (the
    passes)."""
    basis = _basis(block, interval)
    N = basis.fft_samples
    M = N // 2
    wn = idft._scaled(basis.window, N)
    assert wn.dtype == np.float32 and wn.shape == (N,)
    assert (wn[:block].astype(np.float64) * N
            == basis.window.astype(np.float64)).all()
    assert not wn[block:].any()
    pre, post, tw = dft.tables(N)
    half_ulp = 2.0 ** -24
    m = np.arange(M)
    assert np.abs(np.conj(pre) - np.exp(1j * np.pi * m / M)).max() <= half_ulp
    b = np.arange(M // 2)
    assert np.abs(np.conj(post)
                  - np.exp(2j * np.pi * (b + 0.5) / N)).max() <= half_ulp
    want, ns = [], 1
    for p, R in enumerate(dft.RADICES[N.bit_length() - 1]):
        if p:
            want += [np.exp(2j * np.pi * r * k / (ns * R))
                     for r in range(1, R) for k in range(ns)]
        ns *= R
    assert np.abs(np.conj(tw) - np.array(want)).max() <= half_ulp


def kernel_model(spectra, basis):
    """Kernel K's algorithm in float64 with its index maps and its float32
    tables: spectra [..., M] complex64 -> blocks [..., block] float64."""
    N, block = basis.fft_samples, basis.block_samples
    M = N // 2
    pre, post, tw = (t.astype(np.complex128) for t in dft.tables(N))
    S = spectra.astype(np.complex128)
    # pre-combine, one pair (b, M-1-b) at a time as a thread forms it
    b = np.arange(M // 2)
    A, C = S[..., b], S[..., M - 1 - b]
    e = np.conj(A) + C
    g = 1j * (post[b] * (np.conj(A) - C))
    X = np.empty_like(S)
    X[..., b] = e - g
    X[..., M - 1 - b] = np.conj(e + g)
    # D's passes: pass p reads X[j + r M/R], twiddles tw[(r-1)*NS + j mod
    # NS] (none at p = 0), writes Y[(j/NS)*NS*R + j mod NS + r*NS]
    ns, off = 1, 0
    for p, R in enumerate(dft.RADICES[N.bit_length() - 1]):
        j = np.arange(M // R)[:, None]
        r = np.arange(R)[None, :]
        k = j % ns
        v = X[..., j + r * (M // R)]
        if p:
            v[..., 1:] *= tw[off + (r[:, 1:] - 1) * ns + k]
            off += (R - 1) * ns
        v = v @ np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        Y = np.empty_like(X)
        Y[..., (j // ns) * ns * R + k + r * ns] = v
        X, ns = Y, ns * R
    # epilogue: samples 2m and 2m+1, the window over N, below `block`
    c = X * pre
    y = np.empty(S.shape[:-1] + (N,))
    y[..., 0::2], y[..., 1::2] = c.real, -c.imag
    wn = idft._scaled(basis.window, N).astype(np.float64)
    return (y * wn)[..., :block]


def _spectra(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _peak_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("block,interval", SHAPES)
def test_kernel_model_matches_plain(block, interval):
    """K's model against the plain synthesis on random spectra, and on the
    analysis of real frames (a spectrum with its usual structure)."""
    basis = _basis(block, interval)
    spec = _spectra((5, 2, basis.bands), 7)
    plain = stft.synthesize(torch.as_tensor(spec), basis).numpy()
    assert _peak_err(kernel_model(spec, basis), plain) < TOL
    frames = np.random.default_rng(8).standard_normal(
        (3, block)).astype(np.float32)
    spec = stft.analyze_plain(torch.as_tensor(frames), basis).numpy()
    plain = stft.synthesize(torch.as_tensor(spec), basis).numpy()
    assert _peak_err(kernel_model(spec, basis), plain) < TOL


@pytest.mark.parametrize("block,interval", SIZES,
                         ids=[f"N{1 << k}" for k in dft.LOG2_FFT])
def test_kernel_model_every_fft_size(block, interval):
    """The plan of every FFT size, on the spectra of a tone over noise."""
    basis = _basis(block, interval)
    n = np.arange(block)
    rng = np.random.default_rng(9)
    frames = (np.sin(2 * np.pi * 0.0371 * n)
              + 0.1 * rng.standard_normal((3, block))).astype(np.float32)
    spec = stft.analyze_plain(torch.as_tensor(frames), basis).numpy()
    plain = stft.synthesize(torch.as_tensor(spec), basis).numpy()
    assert _peak_err(kernel_model(spec, basis), plain) < TOL


# ---------------------------------------------------------------------------
# Kernel L: a float32 model of its walk
# ---------------------------------------------------------------------------
OLA_THREADS, OLA_PER_THREAD = 256, 4      # csrc/ola.cu


def grid_samples(out_samples):
    """The output samples in the order the grid's (CTA, slot, thread) walk
    them, each once: CTA x takes 1024 consecutive samples, thread t the
    samples x*1024 + i*256 + t, i < 4."""
    per = OLA_THREADS * OLA_PER_THREAD
    ctas = -(-out_samples // per)
    s = (np.arange(ctas)[:, None, None] * per
         + np.arange(OLA_PER_THREAD)[None, :, None] * OLA_THREADS
         + np.arange(OLA_THREADS)[None, None, :]).ravel()
    return s[s < out_samples]


class _Walk:
    """L's device functions on one row, vectorised over ring positions;
    every sum, difference and quotient one float32 operation, in L's order."""

    def __init__(self, blocks, w, plan):
        cfg = plan.cfg
        self.b, self.w = blocks, w                 # [nB, block], [ring]
        self.nB, self.block = blocks.shape
        self.H, self.L = cfg.interval_samples, plan.sched.preroll_len
        self.m = -(-self.block // self.H)
        self.first = int(plan.arrays["out_pos"][0])

    def _take(self, ok, k, j):
        return np.where(ok, self.b[np.where(ok, k, 0), np.where(ok, j, 0)],
                        f32(0))

    def ring_sum(self, p):
        rel = p - self.first
        acc = np.zeros(p.shape, f32)
        q = np.maximum(rel, 0) // self.H
        r = q % self.m
        for gi in range(self.m):
            k = q - np.where(r >= gi, r - gi, r - gi + self.m)
            j = rel - k * self.H
            ok = (rel >= 0) & (k >= 0) & (k < self.nB) & (j < self.block)
            acc = np.where(ok, acc + self._take(ok, k, j), acc)
        return acc

    def preroll(self, q):
        return self.ring_sum(q) / self.w[q]

    def _pre_term(self, acc, p):
        L = self.L
        inside = (p >= L) & (p < 2 * L)
        q = np.where(inside, 2 * L - 1 - p, 0)
        return np.where(inside, acc - self.preroll(q), acc)

    def read(self, p):
        return self._pre_term(self.ring_sum(p), p) / self.w[p]

    def restricted(self, wt, w0, x, n_lim):
        P = w0 + x
        rel = P - self.first
        acc = np.zeros(x.shape, f32)
        q = np.maximum(rel, 0) // self.H
        k_hi = np.minimum(q, n_lim - 1)
        k_lo = np.where(rel >= self.block,
                        (rel - self.block) // self.H + 1, 0)
        for step in range(self.m):
            k = k_lo + step
            ok = (rel >= 0) & (k <= k_hi)
            acc = np.where(ok, acc + self._take(ok, k, rel - k * self.H), acc)
        return self._pre_term(acc, P) / wt[x]


def ola_model(blocks, plan, audio=None, energies=None):
    """L's walk over every row: blocks [batch, ch, nB, block] f32 -> out
    [batch, ch, out_samples] f32; audio [batch, ch, in] f32 and its
    energies (pre-roll, main) [batch] f32 turn the bypass on."""
    sch, sil = plan.sched, plan.silence
    batch, ch = blocks.shape[:2]
    L, T = sch.preroll_len, sch.tail_len
    main_out, flush_out = sch.main_out, sch.flush_block_out
    head = L + main_out + flush_out
    n_pre = sch.n_preroll_blocks
    n_pm = n_pre + sch.n_main_blocks
    s = grid_samples(sch.out_samples)
    assert np.array_equal(np.sort(s), np.arange(sch.out_samples))
    out = np.full((batch, ch, sch.out_samples), np.nan, f32)
    floor = f32(NOISE_FLOOR)
    for c in range(batch):
        main_b = flush_b = False
        if energies is not None:
            pre_s, main_s = energies[0][c] < floor, energies[1][c] < floor
            fp, fa = sil.flush_possible_pre, sil.flush_possible_alone
            main_b = bool(sil.main_possible and main_s and pre_s)
            flush_b = bool(main_s and fp if fp == fa
                           else main_s and pre_s and fp)
        tail_pre = main_b and T > 0
        tail_pm = not tail_pre and flush_b and flush_out > 0
        for r in range(ch):
            walk = _Walk(blocks[c, r], plan.weight, plan)
            v = np.empty(s.shape, f32)
            main = s < main_out
            flush = ~main & (s < main_out + flush_out)
            tail = s >= main_out + flush_out
            if main_b:
                v[main] = (audio[c, r, sch.seek_length + s[main]
                                 % sch.main_in]
                           if sch.main_in > 0 else f32(0))
            else:
                v[main] = walk.read(L + s[main])
            v[flush] = f32(0) if flush_b else walk.read(L + s[flush])
            t = s[tail] - main_out - flush_out
            u = 2 * T - 1 - t
            if tail_pre:
                v[tail] = (walk.restricted(sil.pre_weight, L, t, n_pre)
                           - walk.restricted(sil.pre_weight, L, u, n_pre))
            elif tail_pm:
                w0 = L + main_out
                v[tail] = (walk.restricted(sil.pm_weight, w0, t, n_pm)
                           - walk.restricted(sil.pm_weight, w0, u, n_pm))
            else:
                v[tail] = walk.read(head + t) - walk.read(head + u)
            out[c, r, s] = v
    return out


# (ratio, preset, split): 1.25x; 1.0x, the +12 st cell's geometry (pitch
# does not move the schedule); 3x; 0.2x, where the main process bypasses;
# the cheaper preset's strips carry zero padding (block 3 x interval - 1/2)
OLA_CASES = [(1.25, "preset_default", False), (1.25, "preset_cheaper", False),
             (1.0, "preset_default", False), (1.0, "preset_cheaper", True),
             (3.0, "preset_default", False), (0.2, "preset_cheaper", False),
             (0.2, "preset_default", True)]


def _clips(n, ch, seed):
    """Loud, all zeros, sub-noise (1e-10), loud then zeros, zeros then
    loud: the kinds of tests/test_silence_exact.py."""
    rng = np.random.default_rng(seed)
    loud = 0.3 * rng.standard_normal((ch, n))
    half = np.arange(n) < n // 2
    return np.stack([loud, np.zeros((ch, n)),
                     1e-10 * rng.standard_normal((ch, n)),
                     np.where(half, loud, 0.0),
                     np.where(half, 0.0, loud)]).astype(f32)


@pytest.mark.parametrize("ratio,preset,split", OLA_CASES,
                         ids=[f"{r}x-{p[7:]}{'-split' if s else ''}"
                              for r, p, s in OLA_CASES])
def test_ola_model_matches_plain(ratio, preset, split):
    """L's walk on given blocks equals the plain assembly bit for bit, the
    bypass on (every kind of clip) and off."""
    n = 12000
    cfg = getattr(StretchConfig, preset)(2, 8000, split)
    plan = engine.build_exact_plan(cfg, n, int(round(n * ratio)))
    sch = plan.sched
    audio = _clips(n, 2, 21)
    blocks = np.random.default_rng(22).standard_normal(
        (len(audio), 2, len(plan.arrays["out_pos"]),
         cfg.block_samples)).astype(f32)
    bt, at = torch.as_tensor(blocks), torch.as_tensor(audio)
    energies = tuple(ola.energy(at, a, n_).numpy() for a, n_ in (
        (sch.seek_samples, sch.surplus), (sch.seek_length, sch.main_in)))
    got = (ola_model(blocks, plan, audio, energies)
           if plan.silence.possible else ola_model(blocks, plan))
    want = ola.assemble_plain(bt, plan, at).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    got = ola_model(blocks, plan)
    want = ola.assemble_plain(bt, plan).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if ratio == 0.2:
        assert plan.silence.main_possible
    if ratio > 1:
        assert sch.flush_block_out > 0 and plan.silence.possible


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On a CPU tensor K's and L's wrappers run their plain versions, bit
    for bit, and launch nothing; so they do inside ops.plain(); and the
    engine's synthesis stage is the two wrappers."""
    cfg = StretchConfig.preset_default(2, 8000)
    plan = engine.build_exact_plan(cfg, 8000, 10000)
    spec = torch.as_tensor(_spectra(
        (2, 2, len(plan.arrays["out_pos"]), plan.basis.bands), 23))
    audio = torch.as_tensor(_clips(8000, 2, 24)[:2])
    blocks = stft.synthesize(spec, plan.basis)
    want = ola.assemble_plain(blocks, plan, audio)
    for scope in (ops.plain(False), ops.plain()):
        with scope:
            assert torch.equal(idft.synthesize(spec, plan.basis), blocks)
            assert torch.equal(ola.assemble(blocks, plan, audio), want)
            assert torch.equal(engine.synthesis_stage(spec, plan, audio),
                               want)
    assert idft.launches == ola.launches == 0
