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

`peaks_kernel_model` is csrc/peaks.cu phase by phase (the persistent row
walk, the ballot bitmask of above-flags with its carries, the 8-bin chunks
a lane owns and their run ids, the serial run sums, the histogram's
segment prefixes and the map's lanes on neighbouring bins) in float32
numpy, held bit-equal to the plain version's four planes (the position
sets and the gradient) at the kernel's 512 threads and at fewer, and at
widths that leave every part ragged.  `split_kernel_model` is the same
source's runs and out entries (G split around a custom map), each its own
persistent walk: the runs entry's runs writing their own slots and the
zero fill from n_peaks on, started once flags have given the count; the
out entry's rows claimed from a queue, their valid slots staged a row
ahead in a double buffer, their count read a row ahead and clamped, a
peak counted in its histogram only below bin B.  It is held to the plain
split and the one-launch plain version the same way, also on rows with
no peak, with the most peaks, with more rows than its CTAs walk three
times over, with counts outside [0, (B + 1) / 2] and on planes off 8-byte
alignment.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from signalsmith_stretch_torch import ops, spectral  # noqa: E402
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
    """On a CPU tensor the wrapper is the plain version, launches nothing,
    and its first position set and gradient are the plain peaks map's."""
    model, _ = _models()
    e, s = (torch.as_tensor(a) for a in chip_smoke.peaks_edge_rows(512))
    tf, ltf = (torch.as_tensor(a) for a in _shifts(7))
    args = (e, s, tf, ltf, model.controls, model.plan.consts)
    got = peaks.peaks_positions(*args)
    ref = peaks.peaks_positions_plain(*args)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert got[0].shape == (14, 3, 512) and peaks.launches == 0
    input_bin, freq_grad = spectral._peaks_and_map(e, s, model.controls,
                                                   model.plan.consts)
    assert torch.equal(got[0][:, 0], input_bin)
    assert torch.equal(got[1], freq_grad)
    rows_tf = tf.repeat(2)[:, None]                 # block-major rows
    assert torch.equal(got[0][:, 1], input_bin - rows_tf)


def small_rows(B, seed=0):
    """Energy and smoothed rows [6, B] float32 for widths below the edge
    rows' 64 bins: random rows about half above their curve, every bin
    above, none above, alternating bins, and a run at either end."""
    rng = np.random.default_rng(seed)
    e = rng.exponential(1.0, (6, B))
    sm = e * rng.uniform(0.5, 1.5, (6, B))
    b = np.arange(B)
    sm[2], sm[3] = 0.0, e[3] * 2
    sm[4] = np.where(b % 2, 0.0, e[4] * 2)
    sm[5] = np.where((b == 0) | (b == B - 1), 0.0, e[5] * 2)
    return e.astype(f32), sm.astype(f32)


def _warp_inclusive(v):
    return np.cumsum(np.asarray(v, np.int64))


def _flags(E, S, B, threads):
    """The flags phase of csrc/peaks.cu on one row: a warp takes a segment
    of 256 bins, one ballot a 32-bin word (bit j = bin 32w + j), run starts
    above & ~(above << 1 | carry) with the carry between words and
    segments, the segment's start count.  Returns (above-words with a zero
    word past the last, the segments' start counts)."""
    NW, NS, W = threads // 32, -(-B // 256), -(-B // 32)
    above = np.zeros(W + 1, np.uint64)    # above[W] stays 0
    seg_starts = np.zeros(NS, np.int64)
    for warp in range(NW):
        for s in range(warp, NS, NW):
            carry = int(s > 0 and E[256 * s - 1] > S[256 * s - 1])
            for w in range(8 * s, min(8 * s + 8, W)):
                b = 32 * w + np.arange(32)
                lanes = b < B
                bits = np.zeros(32, bool)
                bits[lanes] = E[b[lanes]] > S[b[lanes]]
                a = int(np.sum(bits.astype(np.uint64)
                               << np.arange(32, dtype=np.uint64)))
                above[w] = a
                starts = a & ~(((a << 1) & 0xffffffff) | carry)
                seg_starts[s] += bin(starts).count("1")
                carry = a >> 31
    return above, seg_starts


def _runs(E, above, seg_starts, B, threads, peak):
    """The runs phase on one row: a thread owns the 8 bins of chunk c
    (segment c // 32 is its warp's), its run ids the earlier segments'
    counts plus a warp prefix of its lanes' counts; it walks the bitmask
    to each run's end and sums the run bin-ascending from 0 in float32,
    then calls peak(run_id, avg).  Returns the row's number of runs."""
    NW, NS = threads // 32, len(seg_starts)
    for c0 in range(0, 32 * NS, threads):
        for warp in range(NW):
            s = c0 // 32 + warp
            if s >= NS:
                break
            base = int(seg_starts[:s].sum())
            chunks = c0 + 32 * warp + np.arange(32)
            assert (chunks // 32 == s).all()
            starts, counts = [], []
            for c in chunks:
                b0 = 8 * int(c)
                st = 0
                if b0 < B:
                    a8 = (int(above[c // 4]) >> (8 * (c % 4))) & 0xff
                    prev = ((int(above[(b0 - 1) // 32])
                             >> ((b0 - 1) % 32)) & 1) if b0 else 0
                    st = a8 & ~((a8 << 1) | prev) & 0xff
                starts.append((b0, st))
                counts.append(bin(st).count("1"))
            excl = _warp_inclusive(counts) - counts
            last = -1
            for (b0, st), ex in zip(starts, excl):
                run_id = base + int(ex)
                assert run_id > last or not st   # ids ascend over the lanes
                for j in range(8):
                    if not st >> j & 1:
                        continue
                    a = b0 + j
                    w = a // 32
                    m = ~int(above[w]) & (0xffffffff << (a % 32)) \
                        & 0xffffffff
                    while not m:
                        w += 1
                        m = ~int(above[w]) & 0xffffffff
                    z = 32 * w + (m & -m).bit_length() - 2
                    band_sum = energy_sum = f32(0)
                    for b in range(a, z + 1):
                        band_sum = f32(band_sum + f32(f32(b) * E[b]))
                        energy_sum = f32(energy_sum + E[b])
                    peak(run_id, f32(band_sum / (f32(1) if energy_sum == 0
                                                 else energy_sum)))
                    last = run_id
                    run_id += 1
    return int(seg_starts.sum())


def _flags_and_runs(E, S, B, threads, peak):
    """The flags and runs phases on one row (_flags, _runs): calls
    peak(run_id, avg) once a run; returns the row's number of runs."""
    above, seg_starts = _flags(E, S, B, threads)
    return _runs(E, above, seg_starts, B, threads, peak)


def _count_peak(hist, peak_in, peak_out, i, avg, mapped, Nf, B):
    """count_peak: the output band mapped * N - 0.5 and its histogram
    cell clamp(ceil(out), 0, B)."""
    out = f32(f32(mapped * Nf) - f32(0.5))
    peak_in[i], peak_out[i] = avg, out
    hist[int(min(max(np.ceil(out), f32(0)), f32(B)))] += 1


def _prefix_and_map(hist, peak_in, peak_out, n, B, threads, vec):
    """The prefix and map phases on one row: a warp prefixes a segment's
    histogram, 8 bins a lane; each pair of neighbouring peaks gets its map
    constants (one division a pair), pair k - 1 between peaks k - 1 and k
    (past the last: input 0, output +inf); the map takes `vec` bins a lane
    (a warp's bins in one segment), k = the prefix plus the earlier
    segments' totals, zeroing the histogram below B as it reads it.
    Returns (input_bin, freq_grad) [B] float32."""
    NW, NS = threads // 32, -(-B // 256)
    nseg = B // 2 + 2
    Bp, M = -(-B // 4) * 4, (B + 1) // 2
    assert 4 * M <= 2 * Bp        # the pair tables fit in a row's buffer
    seg_total = np.zeros(NS, np.int64)
    for warp in range(NW):
        for s in range(warp, NS, NW):
            lanes = hist[256 * s:256 * s + 256].reshape(32, 8)
            local = np.cumsum(lanes, 1)
            incl = _warp_inclusive(local[:, -1])
            hist[256 * s:256 * s + 256] = (
                local + (incl - local[:, -1])[:, None]).reshape(-1)
            seg_total[s] = incl[-1]
    peak_in, peak_out = peak_in[:n], peak_out[:n]
    pad_in = np.concatenate([peak_in, np.zeros(nseg, f32)])
    pad_out = np.concatenate([peak_out, np.full(nseg, np.inf, f32)])
    pk = np.arange(1, n + 1)
    pair_prev_o, prev_in = pad_out[pk - 1], pad_in[pk - 1]
    next_o, next_in = pad_out[pk], pad_in[pk]
    with np.errstate(all="ignore"):
        pair_scale = f32(1) / (next_o - pair_prev_o)
        pair_offset = prev_in - pair_prev_o
        pair_out_scale = ((next_in - next_o) - prev_in) + pair_prev_o
    k = np.empty(B, np.int64)
    nq = -(-B // vec)
    for q0 in range(0, nq, threads):
        for warp in range(NW):
            q = q0 + 32 * warp + np.arange(32)
            s = int(q[0]) * vec // 256
            if s >= NS:
                break
            assert (q * vec // 256 == s).all()
            bins = (q[:, None] * vec + np.arange(vec)).reshape(-1)
            bins = bins[bins < B]
            k[bins] = hist[bins] + seg_total[:s].sum()
            hist[bins] = 0
    fb = np.arange(B, dtype=f32)
    if n == 0:
        return fb, np.ones(B, f32)
    pair = np.maximum(k - 1, 0)        # k = 0: the bottom rule
    prev_o, rs = pair_prev_o[pair], pair_scale[pair]
    offset, scale = pair_offset[pair], pair_out_scale[pair]
    with np.errstate(all="ignore"):
        gs = scale * rs
        x = (fb - prev_o) * rs
        h = (x * x) * (f32(3) - f32(2) * x)
        ib = (fb + offset) + h * scale
        g = f32(1) + ((f32(6) * x) * (f32(1) - x)) * gs
    top_start = max(int(peak_out[n - 1]), 0)
    top = fb >= top_start
    bottom = (k == 0) & ~top
    ib = np.where(top, fb + (peak_in[n - 1] - peak_out[n - 1]),
                  np.where(bottom, fb + (peak_in[0] - peak_out[0]), ib))
    return ib, np.where(top | bottom, f32(1), g)


def _row_walk(R, grid, rows_of_cta):
    """The persistent grid's walk: CTA c takes rows c, c + grid, ... (the
    next row's copy landing in the other buffer); calls rows_of_cta(cta,
    rows) and asserts every row is visited once."""
    visited = np.zeros(R, int)
    for cta in range(min(grid, R)):
        rows = list(range(cta, R, grid))
        buffers = [cta, None]
        for it, row in enumerate(rows):
            assert buffers[it % 2] == row         # the copy of this row
            if row + grid < R:                    # the next one, the other
                buffers[(it + 1) % 2] = row + grid
            visited[row] += 1
        rows_of_cta(cta, rows)
    assert (visited == 1).all()


def _queue_walk(R, grid, rows_of_cta, seed=0):
    """The out entry's walk: grid = min(grid, R) CTAs, CTA c takes row c
    first, then rows past the first grid from a queue shared by the CTAs,
    in the order they come to claim (a seeded random order here: a row's
    cost decides it on the card); calls rows_of_cta(cta, rows) and asserts
    every row is visited once."""
    grid = min(grid, R)
    rows = [[c] for c in range(grid)]
    rng = np.random.default_rng(seed)
    for row in range(grid, R):
        rows[int(rng.integers(grid))].append(row)
    visited = np.zeros(R, int)
    for cta in range(grid):
        visited[rows[cta]] += 1
        rows_of_cta(cta, rows[cta])
    assert (visited == 1).all()


def peaks_kernel_model(energy, smoothed, tf, ltf, controls, N, threads=512,
                       grid=3, vec=4):
    """csrc/peaks.cu's one-launch entry on the CPU, phase by phase, at
    `threads` threads (a multiple of 32) and `grid` CTAs walking the rows
    (_row_walk): flags and runs (_flags_and_runs), each peak mapped with
    its row's constants and counted (_count_peak), prefix and map
    (_prefix_and_map).  The histogram is zeroed once below B; its tail
    past B is zeroed by each row's flags phase, the rest by the last row's
    map: it is all zero when a row's runs start.  Returns (pos [R, 3, B],
    freq_grad [R, B]) float32 numpy."""
    assert threads % 32 == 0
    energy = np.asarray(energy, f32)
    smoothed = np.asarray(smoothed, f32)
    R, B = energy.shape
    nB = len(tf)
    NS = -(-B // 256)
    vec = vec if B % 4 == 0 else 1
    ctl = peaks.map_constants(controls)          # [1 or nB, 3]
    Nf = f32(N)
    inv_n = f32(f32(1) / Nf)
    pos = np.full((R, 3, B), np.nan, f32)
    grad = np.full((R, B), np.nan, f32)

    def cta_rows(cta, rows):
        hist = np.zeros(256 * NS + 4, np.int64)     # zeroed once, below B
        for row in rows:
            limit, mult, above_off = ctl[row % len(ctl)]
            hist[B:] = 0                          # the flags phase
            assert not hist.any()
            peak_in = np.full(B, np.nan, f32)
            peak_out = np.full(B, np.nan, f32)

            def peak(i, avg):
                freq = f32(f32(avg + f32(0.5)) * inv_n)
                mapped = (f32(freq + above_off) if freq > limit
                          else f32(freq * mult))
                _count_peak(hist, peak_in, peak_out, i, avg, mapped, Nf, B)

            n = _flags_and_runs(energy[row], smoothed[row], B, threads, peak)
            assert not np.isnan(peak_in[:n]).any()  # every id written once
            ib, g = _prefix_and_map(hist, peak_in, peak_out, n, B, threads,
                                    vec)
            blk = row % nB
            pos[row] = [ib, ib - tf[blk], ib - ltf[blk]]
            grad[row] = g

    _row_walk(R, grid, cta_rows)
    return pos, grad


def _fill_slots(n0, n1, parity):
    """csrc/peaks.cu zero_slots on a row whose slot 0 lies `parity` floats
    past 8-byte alignment: a 4-byte head store to reach 8 bytes, 8-byte
    pairs, at most one 4-byte tail store.  Returns the slots stored."""
    i, slots = n0, []
    if (parity + i) % 2 and i < n1:
        slots.append(i)
        i += 1
    pairs = (n1 - i) // 2
    assert (parity + i) % 2 == 0 or pairs == 0   # the pairs are 8-byte
    slots += range(i, i + 2 * pairs)
    i += 2 * pairs
    assert n1 - i <= 1
    return slots + list(range(i, n1))


def split_runs_model(energy, smoothed, N, threads=512, grid=3, offset=0):
    """csrc/peaks.cu's runs entry on the CPU, a persistent walk of `grid`
    CTAs (_row_walk) over rows [R, B], its output planes' slot 0 `offset`
    floats past 8-byte alignment: per row the flags phase, then n_peaks
    (the start counts' total) out, the zero fill of slots [n_peaks, nseg)
    (_fill_slots, 8-byte pairs where the slot's address allows) and the
    runs phase, each run's thread writing its own slot i < n_peaks (avg
    and (avg + 0.5) / N) straight to the planes.  Every slot is written
    once: those below n_peaks by their run alone, the others by the fill
    alone.  Returns (peak_in, avg_freq [R, B // 2 + 2], n_peaks [R])."""
    assert threads % 32 == 0
    energy = np.asarray(energy, f32)
    smoothed = np.asarray(smoothed, f32)
    R, B = energy.shape
    nseg = B // 2 + 2
    inv_n = f32(f32(1) / f32(N))
    slots_in = np.full((R, nseg), np.nan, f32)
    slots_freq = np.full((R, nseg), np.nan, f32)
    written = np.zeros((R, nseg), int)
    n_peaks = np.full(R, -1, np.int32)

    def runs_rows(cta, rows):
        for row in rows:
            above, seg_starts = _flags(energy[row], smoothed[row], B, threads)
            n = int(seg_starts.sum())            # after the flags barrier
            n_peaks[row] = n
            for i in _fill_slots(n, nseg, (offset + row * nseg) % 2):
                slots_in[row, i] = slots_freq[row, i] = f32(0)
                written[row, i] += 1

            def peak(i, avg):
                assert i < n and written[row, i] == 0
                slots_in[row, i] = avg
                slots_freq[row, i] = f32(f32(avg + f32(0.5)) * inv_n)
                written[row, i] += 1

            assert _runs(energy[row], above, seg_starts, B, threads,
                         peak) == n

    _row_walk(R, grid, runs_rows)
    assert (written == 1).all()
    return slots_in, slots_freq, n_peaks


def split_out_model(peak_in, mapped, n_peaks, tf, ltf, B, N, threads=512,
                    grid=3, vec=4, offset=0):
    """csrc/peaks.cu's out entry on the CPU, a persistent walk of `grid`
    CTAs (_queue_walk) over the rows of peak_in and mapped [R, B // 2 + 2]
    (their slot 0 `offset` floats past 8-byte alignment) and n_peaks [R].
    A row's count is clamped to [0, (B + 1) / 2] and read a row ahead; its
    valid slots are staged into one half of a double buffer while the
    previous row runs (8-byte copies of ceil(n / 2) pairs where the row
    allows, else n 4-byte copies), and the row reads them there only: the
    peaks phase turns mapped into peak_out = mapped * N - 0.5 in place and
    counts each whose cell clamp(ceil(out), 0, B) is below B in the
    histogram of the segments' bins (zeroed once; the map zeroes the bins
    below B as it reads them, the row's end those past B), then prefix
    and map.  Returns (pos [R, 3, B], freq_grad [R,
    B]) float32 numpy."""
    peak_in = np.asarray(peak_in, f32)
    mapped = np.asarray(mapped, f32)
    R, nseg = peak_in.shape
    assert nseg == B // 2 + 2
    nB = len(tf)
    NS, M = -(-B // 256), (B + 1) // 2
    PR = -(-M // 4) * 4                   # a buffer's slots
    vec = vec if B % 4 == 0 else 1
    Nf = f32(N)
    pos = np.full((R, 3, B), np.nan, f32)
    grad = np.full((R, B), np.nan, f32)

    def count(row):
        return min(max(int(n_peaks[row]), 0), M)

    def stage(row, n):
        if (offset + row * nseg) % 2 == 0:
            copied = 2 * ((n + 1) // 2)          # slot n too when n is odd
        else:
            copied = n
        assert copied <= min(PR, nseg)
        buf = np.full((2, PR), np.nan, f32)
        buf[0, :copied] = peak_in[row, :copied]
        buf[1, :copied] = mapped[row, :copied]
        return row, buf

    def out_rows(cta, rows):
        hist = np.zeros(256 * NS, np.int64)         # zeroed once
        buffers = [stage(rows[0], count(rows[0])), None]
        n = count(rows[0])
        n_next = count(rows[1]) if len(rows) > 1 else 0
        for it, row in enumerate(rows):
            staged, buf = buffers[it % 2]
            assert staged == row                  # this row's slots
            n_after = 0
            if it + 1 < len(rows):                # the next row's, the other
                buffers[(it + 1) % 2] = stage(rows[it + 1], n_next)
                if it + 2 < len(rows):
                    n_after = count(rows[it + 2])
            assert not hist.any()
            pin, pout = buf
            for i in range(n):                    # only the valid slots
                pout[i] = f32(f32(pout[i] * Nf) - f32(0.5))
                cell = int(min(max(np.ceil(pout[i]), f32(0)), f32(B)))
                if cell < B:                      # cell B: in no k[b]
                    hist[cell] += 1
            ib, g = _prefix_and_map(hist, pin, pout, n, B, threads, vec)
            hist[B:] = 0                # the prefix's tail, at the row's end
            blk = row % nB
            pos[row] = [ib, ib - tf[blk], ib - ltf[blk]]
            grad[row] = g
            n, n_next = n_next, n_after

    _queue_walk(R, grid, out_rows, seed=R + 1)
    return pos, grad


def split_kernel_model(energy, smoothed, tf, ltf, custom_map, N, threads=512,
                       grid=3, vec=4, offset=0):
    """csrc/peaks.cu's runs entry and out entry on the CPU around a custom
    map (`custom_map`: float32 numpy in and out): split_runs_model, the
    map on every slot of avg_freq, split_out_model.  Returns (pos,
    freq_grad, (peak_in, avg_freq, n_peaks)) float32 numpy."""
    runs = split_runs_model(energy, smoothed, N, threads, grid, offset)
    mapped = np.asarray(custom_map(runs[1].copy()), f32)
    assert mapped.shape == runs[1].shape
    pos, grad = split_out_model(runs[0], mapped, runs[2], tf, ltf,
                                np.shape(energy)[1], N, threads, grid, vec,
                                offset)
    return pos, grad, runs


def _rows(B, seed):
    return chip_smoke.peaks_edge_rows(B, seed) if B >= 64 else \
        small_rows(B, seed)


def _shifts(nB, longv=6, seed=0):
    tf = np.random.default_rng(seed).uniform(0.5, 2.0, nB).astype(f32)
    return tf, (f32(longv) * tf).astype(f32)


@pytest.mark.parametrize("threads", [512, 256, 96, 64, 32])
@pytest.mark.parametrize("B", [3, 7, 96, 300, 512, 1000, 4096])
def test_peaks_kernel_model_matches_plain(threads, B):
    """The kernel's phases at its 512 threads and at 256, 96, 64 and 32
    (more segments than warps at B = 4096; at 96, three warps that do not
    divide the 2, 4 or 16 segments), at widths that leave a ragged last
    word, chunk, segment and quad (3, 7, 96, 300, 1000) and at the render's
    4096, over the edge rows (B >= 64) or small rows, and random rows, with
    a grid of 3 CTAs walking the rows (two clips of the rows' blocks): pos
    and freq_grad bit-equal to the plain version."""
    model, _ = _models()
    e, s = _rows(B, seed=B + threads)
    R = e.shape[0]
    tf, ltf = _shifts(R // 2, seed=B)
    got = peaks_kernel_model(e, s, tf, ltf, model.controls,
                             model.plan.consts.fft_samples, threads)
    ref = peaks.peaks_positions_plain(
        torch.as_tensor(e), torch.as_tensor(s), torch.as_tensor(tf),
        torch.as_tensor(ltf), model.controls, model.plan.consts)
    for g, r in zip(got, ref):
        _assert_bits(g, r.numpy())


def _block_controls(nB, seed=0):
    """Per-block controls (automation) for nB blocks: pitch factors from
    -7 to +12 semitones, tonality limits from none to 1 kHz at 8 kHz."""
    rng = np.random.default_rng(seed)
    mult = (2.0 ** (rng.uniform(-7, 12, nB) / 12)).astype(f32)
    limit = np.where(rng.uniform(size=nB) < 0.3, f32(1),
                     rng.uniform(0.02, 0.125, nB)).astype(f32)
    fm = np.ones(nB, f32)
    return spectral.Controls(mult, limit, fm, fm, np.zeros(nB, f32))


@pytest.mark.parametrize("seed", [0, 1])
def test_block_controls_match_jax(seed):
    """Per-block controls through the plain peaks map and its position
    sets (peaks_positions_plain), two clips of 7 blocks (rows block-major
    per clip: row r takes block r % 7's controls), bit-equal to JAX's
    _peaks_and_map vmapped over rows with each row's block's controls; and
    constant per-block controls bit-equal to the scalar controls."""
    model, jm = _models()
    consts = model.plan.consts
    e, s = chip_smoke.peaks_edge_rows(consts.bands, seed=seed)
    R, nB = e.shape[0], 7
    ctl = _block_controls(nB, seed=seed)
    tf, ltf = (torch.as_tensor(a) for a in _shifts(nB, seed=seed))
    got = peaks.peaks_positions_plain(torch.as_tensor(e), torch.as_tensor(s),
                                      tf, ltf, ctl, consts)
    rows = ctl.tile(R)
    jctl = jspectral.Controls(*[jnp.asarray(v) for v in rows])
    fn = jax.vmap(lambda a, b, c: jspectral._peaks_and_map(
        a, b, c, jm.flags, consts))
    ref = [np.asarray(x) for x in fn(jnp.asarray(e), jnp.asarray(s), jctl)]
    _assert_bits(got[0][:, 0].numpy(), ref[0])
    _assert_bits(got[1].numpy(), ref[1])
    blk = np.arange(R) % nB
    _assert_bits(got[0][:, 1].numpy(), ref[0] - tf.numpy()[blk][:, None])
    _assert_bits(got[0][:, 2].numpy(), ref[0] - ltf.numpy()[blk][:, None])
    const = spectral.Controls(*[np.full(nB, v, f32) for v in model.controls])
    scalar = peaks.peaks_positions_plain(torch.as_tensor(e),
                                         torch.as_tensor(s), tf, ltf,
                                         model.controls, consts)
    same = peaks.peaks_positions_plain(torch.as_tensor(e), torch.as_tensor(s),
                                       tf, ltf, const, consts)
    for a, b in zip(scalar, same):
        _assert_bits(a.numpy(), b.numpy())


@pytest.mark.parametrize("threads", [512, 64])
@pytest.mark.parametrize("B", [7, 300, 1000])
def test_peaks_kernel_model_block_controls(threads, B):
    """The kernel's phases with per-block map constants (row r reads block
    r % nB's limit, mult and above_off) bit-equal to the plain version
    under the same per-block controls."""
    model, _ = _models()
    e, s = _rows(B, seed=3 * B + threads)
    R = e.shape[0]
    nB = R // 2
    ctl = _block_controls(nB, seed=B)
    tf, ltf = _shifts(nB, seed=B)
    got = peaks_kernel_model(e, s, tf, ltf, ctl,
                             model.plan.consts.fft_samples, threads)
    ref = peaks.peaks_positions_plain(
        torch.as_tensor(e), torch.as_tensor(s), torch.as_tensor(tf),
        torch.as_tensor(ltf), ctl, model.plan.consts)
    for g, r in zip(got, ref):
        _assert_bits(g, r.numpy())


def _tonality_maps(controls, nan_outside=False):
    """The built-in map of scalar controls as a callable, in numpy (for
    split_kernel_model) and in torch (for the plain versions); with
    nan_outside, NaN on the invalid slots (whose frequency is 0)."""
    limit, mult, above_off = peaks.map_constants(controls)[0]

    def np_map(f):
        out = np.where(f > limit, f + above_off, f * mult).astype(f32)
        return np.where(f > 0, out, f32(np.nan)) if nan_outside else out

    def torch_map(f):
        out = torch.where(f > float(limit), f + float(above_off),
                          f * float(mult))
        return torch.where(f > 0, out, torch.full_like(out, float("nan"))) \
            if nan_outside else out
    return np_map, torch_map


@pytest.mark.parametrize("nan_outside", [False, True], ids=["map", "nan"])
@pytest.mark.parametrize("threads", [512, 96, 32])
@pytest.mark.parametrize("B", [7, 300, 1000, 4096])
def test_split_kernel_model_matches_plain(B, threads, nan_outside):
    """G's runs and out entries on the CPU (split_kernel_model) around the
    built-in map written as a callable, with 3 CTAs walking the rows: the
    runs' planes and counts bit-equal to peak_runs_plain, and pos and
    freq_grad bit-equal to the plain split (peaks_positions_custom inside
    ops.plain()) and to the one-launch plain version; NaN in the invalid
    slots changes nothing."""
    model, _ = _models()
    e, s = _rows(B, seed=5 * B + threads)
    R = e.shape[0]
    tf, ltf = _shifts(R // 2, seed=B + 1)
    np_map, torch_map = _tonality_maps(model.controls, nan_outside)
    consts = model.plan.consts
    pos, grad, runs = split_kernel_model(e, s, tf, ltf, np_map,
                                         consts.fft_samples, threads)
    args = [torch.as_tensor(a) for a in (e, s, tf, ltf)]
    for g, w in zip(runs, peaks.peak_runs_plain(*args[:2], consts)):
        _assert_bits(g, w.numpy())
    with ops.plain():
        split = peaks.peaks_positions_custom(*args, torch_map, consts)
    one = peaks.peaks_positions_plain(*args, model.controls, consts)
    for g, w, o in zip((pos, grad), split, one):
        _assert_bits(g, w.numpy())
        _assert_bits(g, o.numpy())


def _walk_rows(case, B):
    """Rows for test_split_kernel_model_walks: "no_peaks" no bin above its
    curve; "most_peaks" every other bin from bin 0 above, (B + 1) // 2
    runs; otherwise _rows."""
    rng = np.random.default_rng(B)
    e = rng.exponential(1.0, (5, B)).astype(f32) + f32(0.1)
    if case == "no_peaks":
        return e, (e * f32(2)).astype(f32)
    if case == "most_peaks":
        odd = np.arange(B) % 2 == 1
        return e, np.where(odd, e * f32(2), f32(0)).astype(f32)
    return _rows(B, seed=B)


@pytest.mark.parametrize("case,B", [
    ("no_peaks", 300), ("no_peaks", 4096), ("most_peaks", 7),
    ("most_peaks", 1000), ("most_peaks", 4096), ("many_rows", 1000),
    ("many_rows", 998), ("n_peaks_outside", 7), ("n_peaks_outside", 1000),
    ("misaligned", 998), ("misaligned", 1000)])
def test_split_kernel_model_walks(case, B):
    """The split's walks on the CPU (split_runs_model, split_out_model) at
    their edges, bit-equal to the plain versions: rows with no peak; rows
    with the most peaks, n_peaks = (B + 1) / 2 (alternating bins); more
    rows than 3 x the modelled CTAs, so each CTA stages its next row
    several times (R = 3 * grid + 1); counts outside [0, (B + 1) / 2] in
    the out entry's input (negative, past the tables, the int32 extremes),
    which it clamps, against the plain output map of the clamped counts;
    and planes whose slot 0 lies 4 bytes off 8-byte alignment (a view one
    float in), at a width whose rows alternate between the two (998:
    nseg odd)."""
    model, _ = _models()
    consts = model.plan.consts
    N, M, grid = consts.fft_samples, (B + 1) // 2, 3
    e, s = _walk_rows(case, B)
    if case == "many_rows":
        reps = -(-(3 * grid + 1) // e.shape[0])
        e, s = (np.tile(a, (reps, 1))[:3 * grid + 1] for a in (e, s))
    R = e.shape[0]
    offset = int(case == "misaligned")
    tf, ltf = _shifts(R, seed=B + 2)
    np_map, torch_map = _tonality_maps(model.controls)
    runs = split_runs_model(e, s, N, grid=grid, offset=offset)
    args = [torch.as_tensor(a) for a in (e, s, tf, ltf)]
    for g, w in zip(runs, peaks.peak_runs_plain(*args[:2], consts)):
        _assert_bits(g, w.numpy())
    if case == "no_peaks":
        assert not runs[2].any()
    if case == "most_peaks":
        assert (runs[2] == M).all()
    mapped = np_map(runs[1].copy())
    n_in = runs[2].copy()
    if case == "n_peaks_outside":
        n_in[:4] = [-5, M + 3, 2 ** 31 - 1, -2 ** 31]
    got = split_out_model(runs[0], mapped, n_in, tf, ltf, B, N, grid=grid,
                          offset=offset)
    want = peaks.output_positions_plain(
        torch.as_tensor(runs[0]), torch.as_tensor(mapped),
        torch.as_tensor(np.clip(n_in, 0, M).astype(np.int32)), *args[2:],
        B, consts)
    for g, w in zip(got, want):
        _assert_bits(g, w.numpy())
    if case != "n_peaks_outside":
        one = peaks.peaks_positions_plain(*args, model.controls, consts)
        with ops.plain():
            split = peaks.peaks_positions_custom(*args, torch_map, consts)
        for g, o, x in zip(got, one, split):
            _assert_bits(g, o.numpy())
            _assert_bits(g, x.numpy())
