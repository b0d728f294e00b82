"""The peaks and output map (spectral._peaks_and_map, kernel G's plain
version) against the JAX package, and a CPU model of kernel G.

Rows of energy and smoothed curve (chip_smoke.peaks_edge_rows: no run, one
run of all B bins, alternating bins, runs at either end, a peak mapped above
B, a run of zero energy, random spectra) go through the port's plain
version and JAX's `_peaks_and_map` (vmapped over rows), under the +12
semitone map with a 2 kHz tonality limit at 8 kHz (B = 512; peaks above
bin ~256 map past B).  Tolerance: bit equality.  Both sum each run
bin-ascending (CPU `index_put_` under deterministic algorithms, and XLA's
scatter-add on the CPU) and round every other operation once, in the same
order.

`peaks_kernel_model` is csrc/peaks.cu phase by phase (its chunked block
scans, run tables, serial run sums, histogram and per-bin map) in float32
numpy, held bit-equal to the plain version at the kernel's 256 threads and
at thread counts that leave ragged chunks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from signalsmith_stretch_torch import spectral  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.ops import peaks  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.models import StretchModel as JModel  # noqa: E402

f32 = np.float32
RATE, N_IN = 8000, 16000
KW = dict(semitones=12, tonality_hz=2000)
EDGE_ROWS = {"no_run": 0, "one_run_of_all_bins": 1, "alternating": 2,
             "run_from_bin_0": 3, "run_to_last_bin": 4,
             "peak_mapped_above_B": 5, "zero_energy_run": 6}


def _models():
    return (StretchModel.build(2, RATE, N_IN, N_IN, device="cpu", **KW),
            JModel.build(2, RATE, N_IN, N_IN, **KW))


def _jax_peaks(e, s, jm):
    fn = jax.vmap(lambda a, b: jspectral._peaks_and_map(
        a, b, jm.controls, jm.flags, jm.plan.consts))
    return [np.asarray(x) for x in fn(jnp.asarray(e), jnp.asarray(s))]


def _assert_bits(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("kind", list(EDGE_ROWS) + ["random"])
def test_peaks_edge_rows_match_jax(kind):
    model, jm = _models()
    B = model.plan.consts.bands
    e, s = chip_smoke.peaks_edge_rows(B)
    rows = [EDGE_ROWS[kind]] if kind in EDGE_ROWS else list(
        range(len(EDGE_ROWS), e.shape[0]))
    e, s = e[rows], s[rows]
    got = spectral._peaks_and_map(torch.as_tensor(e), torch.as_tensor(s),
                                  model.controls, model.plan.consts)
    ref = _jax_peaks(e, s, jm)
    for g, r in zip(got, ref):
        _assert_bits(g.numpy(), r)
    if kind == "peak_mapped_above_B":       # the row is what it says
        above = e[0] > s[0]
        band = (np.arange(B) * e[0])[above].sum() / e[0][above].sum()
        mapped = spectral.map_freq(torch.tensor([(band + 0.5) / 1024]),
                                   model.controls) * 1024 - 0.5
        assert float(mapped) > B


def test_wrapper_on_cpu_takes_the_plain_version():
    model, _ = _models()
    e, s = (torch.as_tensor(a) for a in chip_smoke.peaks_edge_rows(512))
    got = peaks.peaks_and_map(e, s, model.controls, model.plan.consts)
    ref = spectral._peaks_and_map(e, s, model.controls, model.plan.consts)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert peaks.launches == 0


def _block_exclusive_scan(counts):
    return np.concatenate([[0], np.cumsum(counts)[:-1]]), int(np.sum(counts))


def peaks_kernel_model(energy, smoothed, controls, N, threads=256):
    """csrc/peaks.cu on the CPU, row by row: thread t owns the bins [t*C,
    min((t+1)*C, B)) with C = ceil(B/threads); the block scan of the
    chunks' run starts gives each run its id, its first and its last bin;
    each run is summed bin-ascending from 0 in float32; the histogram of
    clamp(ceil(peak_out), 0, B) and a second chunked scan give k; then the
    per-bin map.  Returns (input_bin, freq_grad) float32 numpy."""
    energy = np.asarray(energy, f32)
    R, B = energy.shape
    limit = f32(controls.freq_tonality_limit)
    mult = f32(controls.freq_multiplier)
    above_off = f32(f32(mult - f32(1)) * limit)
    Nf, inf = f32(N), f32(np.inf)
    C = -(-B // threads)
    bounds = [(min(t * C, B), min(t * C + C, B)) for t in range(threads)]
    nseg = B // 2 + 2
    out_bin = np.empty((R, B), f32)
    out_grad = np.empty((R, B), f32)
    for r in range(R):
        E = energy[r]
        above = E > smoothed[r]

        def is_start(b):
            return above[b] and not (b > 0 and above[b - 1])

        base, n = _block_exclusive_scan(
            [sum(is_start(b) for b in range(lo, hi)) for lo, hi in bounds])
        first, last = {}, {}
        for t, (lo, hi) in enumerate(bounds):
            run = base[t]
            for b in range(lo, hi):
                if not above[b]:
                    continue
                if is_start(b):
                    first[run] = b
                    run += 1
                if b == B - 1 or not above[b + 1]:
                    last[run - 1] = b
        peak_in = np.empty(n, f32)
        peak_out = np.empty(n, f32)
        for s in range(n):
            band_sum = energy_sum = f32(0)
            for b in range(first[s], last[s] + 1):
                band_sum = f32(band_sum + f32(f32(b) * E[b]))
                energy_sum = f32(energy_sum + E[b])
            avg = f32(band_sum / (f32(1) if energy_sum == 0 else energy_sum))
            freq = f32(f32(avg + f32(0.5)) / Nf)
            mapped = f32(freq + above_off) if freq > limit else f32(freq * mult)
            peak_in[s], peak_out[s] = avg, f32(f32(mapped * Nf) - f32(0.5))
        hist = np.zeros(B + 1, np.int64)
        for s in range(n):
            hist[int(min(max(np.ceil(peak_out[s]), f32(0)), f32(B)))] += 1
        kbase, _ = _block_exclusive_scan(
            [hist[lo:hi].sum() for lo, hi in bounds])
        k = np.empty(B, np.int64)
        for t, (lo, hi) in enumerate(bounds):
            k[lo:hi] = kbase[t] + np.cumsum(hist[lo:hi])

        def p_in(i):
            return peak_in[i] if i < n else f32(0)

        def p_out(i):
            return peak_out[i] if i < n else inf

        top_start = max(int(peak_out[n - 1]) if n else 0, 0)
        for b in range(B):
            fb, grad = f32(b), f32(1)
            if n == 0:
                ib = fb
            elif b >= top_start:
                ib = f32(fb + f32(p_in(n - 1) - p_out(n - 1)))
            elif k[b] == 0:
                ib = f32(fb + f32(p_in(0) - p_out(0)))
            else:
                pi = min(max(k[b] - 1, 0), nseg - 1)
                ni = min(max(k[b], 0), nseg - 1)
                prev_o, prev_in = p_out(pi), p_in(pi)
                next_o, next_in = p_out(ni), p_in(ni)
                with np.errstate(all="ignore"):
                    rs = f32(f32(1) / f32(next_o - prev_o))
                    offset = f32(prev_in - prev_o)
                    scale = f32(f32(f32(next_in - next_o) - prev_in) + prev_o)
                    gs = f32(scale * rs)
                    x = f32(f32(fb - prev_o) * rs)
                    h = f32(f32(x * x) * f32(f32(3) - f32(f32(2) * x)))
                    ib = f32(f32(fb + offset) + f32(h * scale))
                    grad = f32(f32(1) + f32(f32(f32(f32(6) * x)
                                                * f32(f32(1) - x)) * gs))
            out_bin[r, b], out_grad[r, b] = ib, grad
    return out_bin, out_grad


@pytest.mark.parametrize("threads", [256, 96, 7])
@pytest.mark.parametrize("B", [512, 300])
def test_peaks_kernel_model_matches_plain(threads, B):
    """The kernel's phases at its 256 threads (B = 512: two bins a thread)
    and at 96 and 7 threads (ragged chunks, runs crossing chunk edges), on
    the edge rows and random rows: bit-equal to the plain version."""
    model, _ = _models()
    e, s = chip_smoke.peaks_edge_rows(B, seed=B + threads)
    got = peaks_kernel_model(e, s, model.controls,
                             model.plan.consts.fft_samples, threads)
    ref = spectral._peaks_and_map(torch.as_tensor(e), torch.as_tensor(s),
                                  model.controls, model.plan.consts)
    for g, r in zip(got, ref):
        _assert_bits(g, r.numpy())
