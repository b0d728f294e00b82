"""The port's slew scan (ops/scan_ops.py) against the JAX package, on the CPU.

The port runs the recurrence y_b = y_{b-1} + (x_b - y_{b-1}) * slew in the
reference's serial bin order (its card kernel, csrc/scan.cu, is held to the
plain loop bit for bit in tests/test_torch_cuda.py).  The JAX package runs
the same recurrence as a log-depth associative scan, which reassociates the
products and sums.  Tolerance: 1e-6 of each row's largest magnitude
(docs/PARITY.md pins the JAX smoothing to ~3e-7 of the reference's serial
values; on these rows one pass measures up to 1.6e-7, the four-pass chain
up to 4.6e-7, and a pass's final value against its own magnitude up to
7.8e-7).

The chain kernel's walk (ops/scan_ops.chain_walk, the step table that
csrc/chain.cuh follows) is replayed on the CPU by `walk_model`, which
checks every slot and copy hazard and is held bit-equal to the plain
chain; its tile layout's shared-memory bank conflicts are counted in a
model of the warps' accesses.

The top-3 kernel (csrc/top3.cu, kernel F) is modelled by
`top3_merge_model`: its lane partition, each lane's insertion ladder, the
neighbours it takes from the lanes beside it and the butterfly merge of
the lanes' lists, held bit-equal (NaN for NaN, -0.0 for -0.0) to the plain
loop and to JAX at the kernel's lane width and at others.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from signalsmith_stretch_torch import spectral  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.ops import scan_ops  # noqa: E402
from signalsmith_stretch_torch.spectral import SpectralConsts  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.ops import scan_ops as jscan  # noqa: E402

RTOL = 1e-6


def _energy(rows, bins, seed):
    """Spectral-energy-like rows: a few sharp peaks over a noise floor."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(0.01, (rows, bins))
    for r in range(rows):
        x[r, rng.integers(0, bins, 6)] += rng.uniform(1, 50, 6)
    return x.astype(np.float32)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    err = np.abs(got - ref).max(axis=-1, keepdims=True)
    assert (err <= RTOL * scale).all(), float((err / scale).max())


def _slew(sample_rate):
    return SpectralConsts.for_config(
        StretchConfig.preset_default(2, sample_rate)).slew


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("rate", [8000, 48000])
def test_iir_matches_jax(backward, rate):
    slew = _slew(rate)
    x = _energy(6, 512, rate)
    init = np.random.default_rng(1).uniform(0, 1, 6).astype(np.float32)
    fn = scan_ops.iir_backward if backward else scan_ops.iir_forward
    jfn = jscan.iir_backward if backward else jscan.iir_forward
    y, fin = fn(torch.as_tensor(x), torch.as_tensor(init), slew)
    ry, rfin = jfn(jnp.asarray(x), jnp.asarray(init), np.float32(slew))
    _close(y.numpy(), ry)
    _close(fin.numpy()[:, None], np.asarray(rfin)[:, None])


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_iir_final_is_the_last_value(backward):
    x = torch.as_tensor(_energy(3, 100, 5))
    init = torch.zeros(3)
    y, fin = scan_ops.iir(x, init, 0.3, backward=backward)
    assert torch.equal(fin, y[:, 0] if backward else y[:, -1])
    assert scan_ops.launches == 0         # CPU tensors take the plain loop


def test_iir_is_the_serial_recurrence():
    """The plain loop against a float32 numpy loop in the reference order:
    bit for bit."""
    x = _energy(4, 64, 6)
    slew = np.float32(_slew(8000))
    y, _ = scan_ops.iir_plain(torch.as_tensor(x), torch.zeros(4), float(slew))
    v = np.zeros(4, np.float32)
    want = np.empty_like(x)
    for b in range(x.shape[1]):
        v = (v + (x[:, b] - v) * slew).astype(np.float32)
        want[:, b] = v
    np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("rate", [8000, 48000])
def test_smoothing_chain_matches_jax(rate):
    """The planner's four passes (down, up, down, up, each pass starting
    from the previous pass's last value) against the JAX smoothing."""
    consts = SpectralConsts.for_config(StretchConfig.preset_default(2, rate))
    x = _energy(5, consts.bands, rate + 1)
    sm = torch.as_tensor(x)
    e = torch.zeros(5)
    for _ in range(2):
        sm, e = scan_ops.iir_backward(sm, e, consts.slew)
        sm, e = scan_ops.iir_forward(sm, e, consts.slew)
    ref = np.stack([np.asarray(jspectral._smooth_energy(jnp.asarray(row),
                                                        consts))
                    for row in x])
    _close(sm.numpy(), ref)


@pytest.mark.parametrize("directions", [
    (True, False, True, False), (False,), (True,), (False, False, True)],
    ids=["smoothing", "forward", "backward", "mixed"])
def test_iir_chain_plain_matches_jax(directions):
    """iir_chain_plain against the loop of JAX iir_backward/iir_forward
    passes, each from the previous pass's last value."""
    consts = SpectralConsts.for_config(StretchConfig.preset_default(2, 8000))
    x = _energy(7, consts.bands, 17)
    init = np.random.default_rng(2).uniform(0, 1, 7).astype(np.float32)
    y, fin = scan_ops.iir_chain_plain(torch.as_tensor(x),
                                      torch.as_tensor(init), consts.slew,
                                      directions)
    ry, rfin = jnp.asarray(x), jnp.asarray(init)
    for backward in directions:
        fn = jscan.iir_backward if backward else jscan.iir_forward
        ry, rfin = fn(ry, rfin, np.float32(consts.slew))
    _close(y.numpy(), ry)
    _close(fin.numpy()[:, None], np.asarray(rfin)[:, None])
    # on the CPU the wrapper is the plain chain, bit for bit
    y2, fin2 = scan_ops.iir_chain(torch.as_tensor(x), torch.as_tensor(init),
                                  consts.slew, directions)
    assert torch.equal(y2, y) and torch.equal(fin2, fin)
    assert scan_ops.launches == 0


def walk_model(x, init, flags, step, tile):
    """The chain kernel (csrc/chain.cuh) as it follows chain_walk's table:
    a ring of slots [slots, R, tile], copies that land CHAIN_LEAD steps
    after they start, computes in place, stores to the output.  Asserts that no
    step touches a slot twice, that no copy is read before it lands or
    overwrites a tile not yet stored, that no store changes a tile a copy
    in flight reads, and that each pass visits every bin of every row once,
    in its order.  step(p, v, column) is pass p's update.  Returns (y,
    final, slots)."""
    R, B = x.shape
    lead = scan_ops.CHAIN_LEAD
    table, slots = scan_ops.chain_walk(B, flags, tile)
    nt, P = -(-B // tile), len(flags)
    expected = [(p, t) for p in range(P) for t in
                (range(nt - 1, -1, -1) if flags[p] & 1 else range(nt))]
    data = torch.zeros(slots, R, tile)
    held = [None] * slots            # (tile, passes applied - 1)
    flight = {}                      # slot -> (landing step, tile, source)
    y = torch.full_like(x, float("nan"))
    y_ver = {}                       # tile -> the pass its stored output has
    visits = [[] for _ in range(P)]  # bins in visit order, per pass
    v = init.clone()
    done = 0
    for j, (cs, ct, cf, ss, st, ls, lt, src) in enumerate(table.tolist()):
        used = [s for s in (cs, ss, ls) if s >= 0]
        assert len(set(used)) == len(used), (j, used)
        for s in [s for s, (land, _, _) in flight.items() if land <= j]:
            land, t, (sv, snap) = flight.pop(s)
            if sv >= 0:              # the source did not change in flight
                assert y_ver[t] == sv, (j, t)
            data[s], held[s] = snap, (t, sv)
        if cs >= 0:
            p, t = expected[done]
            done += 1
            assert (ct, cf) == (t, flags[p]) and cs not in flight, j
            assert held[cs] == (t, p - 1), (j, held[cs], t, p)
            w = min(tile, B - t * tile)
            for i in (range(w - 1, -1, -1) if cf & 1 else range(w)):
                v = step(p, v, data[cs, :, i])
                data[cs, :, i] = v
                visits[p].append(t * tile + i)
            held[cs] = (t, p)
        if ls >= 0:
            assert ls not in flight and ls < slots, j
            if held[ls] is not None:     # its tile was stored already
                assert y_ver.get(held[ls][0]) == held[ls][1], (j, held[ls])
            snap = torch.zeros(R, tile)
            w = min(tile, B - lt * tile)
            if src == 0:
                sv = -1
                snap[:, :w] = x[:, lt * tile:lt * tile + w]
            else:
                sv = y_ver[lt]
                snap[:, :w] = y[:, lt * tile:lt * tile + w]
            flight[ls] = (j + lead, lt, (sv, snap))
            held[ls] = None
        if ss >= 0:
            assert ss not in flight and held[ss][0] == st, j
            assert not any(t == st for _, t, (sv, _) in flight.values()
                           if sv >= 0), j
            w = min(tile, B - st * tile)
            y[:, st * tile:st * tile + w] = data[ss, :, :w]
            y_ver[st] = held[ss][1]
    assert done == len(expected) and not flight
    assert all(y_ver.get(t) == P - 1 for t in range(nt))
    for p in range(P):
        assert visits[p] == (list(range(B - 1, -1, -1)) if flags[p] & 1
                             else list(range(B)))
    return y, v, slots


@pytest.mark.parametrize("R,B,tile,P", [
    (37, 335, 128, 4), (37, 4096, 96, 4), (37, 4096, 128, 1),
    (5, 300, 128, 8), (3, 100, 128, 3), (33, 1000, 128, 2)],
    ids=["ragged_B", "tile_not_dividing", "one_pass", "eight_passes",
         "all_resident", "two_passes"])
def test_iir_chain_walk_model_matches_plain(R, B, tile, P):
    """The kernel's walk at ragged R and B, modelled on the CPU, is bit-equal
    to the plain chain of alternating passes (backward first)."""
    rng = np.random.default_rng(R + B + P)
    x = torch.as_tensor(_energy(R, B, B))
    init = torch.as_tensor(rng.uniform(0, 1, R).astype(np.float32))
    slew = _slew(8000)
    directions = [p % 2 == 0 for p in range(P)]

    def step(p, v, col):
        return v + (col - v) * slew

    y, fin, slots = walk_model(x, init, [int(d) for d in directions], step,
                               tile)
    yp, finp = scan_ops.iir_chain_plain(x, init, slew, directions)
    assert torch.equal(y, yp) and torch.equal(fin, finp)
    assert slots <= scan_ops.CHAIN_MAX_SLOTS


@pytest.mark.parametrize("flags", [(0, 0), (1, 1, 0), (0, 0, 0, 1, 1)],
                         ids=["forward_twice", "backward_twice", "runs"])
@pytest.mark.parametrize("B", [60, 1000])
def test_chain_walk_same_direction_passes(flags, B):
    """Passes that do not reverse keep nothing resident: every tile is
    reloaded, after its store, with bubbles where a short row forces them."""
    x = torch.as_tensor(_energy(4, B, 3))
    init = torch.zeros(4)
    slew = 0.3

    def step(p, v, col):
        return v + (col - v) * slew

    y, fin, _ = walk_model(x, init, flags, step, 32)
    yp, finp = scan_ops.iir_chain_plain(x, init, slew,
                                        [bool(f & 1) for f in flags])
    assert torch.equal(y, yp) and torch.equal(fin, finp)


def _wavefronts(lane_words, width):
    """Shared-memory wavefronts of one warp request: lanes' word addresses,
    `width` words (1 or 4) each.  16-byte requests go in four phases of 8
    lanes, 4-byte ones in one of 32; within a phase, distinct 16-byte (or
    4-byte) units on one bank group serialise."""
    per_phase = 8 if width == 4 else 32
    total = 0
    for ph in range(0, 32, per_phase):
        banks = {}
        for a in lane_words[ph:ph + per_phase]:
            for bank in range(a % 32, a % 32 + width):
                banks.setdefault(bank % 32, set()).add(a // width)
        total += max(len(u) for u in banks.values())
    return total


def test_chain_tile_layout_is_conflict_free():
    """The tile layout of csrc/chain.cuh, row pitch CHAIN_TILE + 4 floats:
    the computing lanes' 16-byte reads of one bin column (lane r, row r) and
    the copying threads' 16-byte copies along rows take one wavefront a
    phase (four a warp); the scalar copies of rows that are not 16-byte
    aligned take one.  Only the ragged last tile's scalar reads down a
    column conflict (4-way: 4 wavefronts, not 1)."""
    pitch, T = scan_ops.CHAIN_PITCH, scan_ops.CHAIN_TILE
    for q in range(0, T, 4):
        assert _wavefronts([r * pitch + q for r in range(32)], 4) == 4
    for c0 in range(0, 32 * T // 4, 32):      # a warp of copying threads
        words = [(c // (T // 4)) * pitch + 4 * (c % (T // 4))
                 for c in range(c0, c0 + 32)]
        assert _wavefronts(words, 4) == 4
    for c0 in range(0, 32 * T, 32):
        words = [(c // T) * pitch + c % T for c in range(c0, c0 + 32)]
        assert _wavefronts(words, 1) == 1
    assert _wavefronts([r * pitch + 5 for r in range(32)], 1) == 4


def _better(a, b):
    """(value, bin) a ranks above b: larger value, then earlier bin."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge3(a, b):
    """The top three of two best-first lists of three, as the kernel's
    merge step takes them: b's head only when it ranks above a's."""
    a, b, out = list(a), list(b), []
    for _ in range(3):
        out.append(b.pop(0) if _better(b[0], a[0]) else a.pop(0))
    return out


def top3_merge_model(m, lanes=32, width=4, group=4):
    """Kernel F (csrc/top3.cu) on the CPU: per row, lane L holds `width`
    consecutive bins of each chunk of lanes*width, `group` chunks a step;
    loads past the row read 0; a bin's left neighbour across a lane edge is
    the previous lane's last (lane 0: the previous chunk's last bin), its
    right neighbour the next lane's first (the last lane: the next chunk's
    first); each lane runs the insertion ladder over its bins in ascending
    order from (0, m[0]), then a butterfly over lane offsets lanes/2 .. 1
    merges the lists.  m [R, B] float32 -> (i0, v0, i1, v1, i2, v2) numpy."""
    m = np.asarray(m, np.float32)
    R, B = m.shape
    chunk = lanes * width
    span = group * chunk
    padded = np.zeros((R, -(-B // span) * span + span), np.float32)
    padded[:, :B] = m
    out = [np.zeros(R, t) for t in (np.int32, np.float32) * 3]
    for r in range(R):
        row = padded[r]
        m0 = row[0]
        state = [[(m0, 0)] * 3 for _ in range(lanes)]    # worst first
        carry = np.float32(0)
        for base in range(0, B, span):
            for g in range(group):
                c0 = base + g * chunk
                vals = row[c0:c0 + chunk].reshape(lanes, width)
                after = row[c0 + chunk]        # lane 0's first of the next
                for lane in range(lanes):
                    left = vals[lane - 1, -1] if lane else carry
                    right = vals[lane + 1, 0] if lane < lanes - 1 else after
                    (v0, i0), (v1, i1), (v2, i2) = state[lane]
                    for j in range(width):
                        b = c0 + lane * width + j
                        e = vals[lane, j]
                        ep = vals[lane, j - 1] if j else left
                        en = vals[lane, j + 1] if j + 1 < width else right
                        is_max = (1 <= b <= B - 2 and not e < ep
                                  and not e <= en)
                        s0 = is_max and e > v0
                        s1 = s0 and e > v1
                        s2 = s1 and e > v2
                        n0 = (v1, i1) if s1 else (e, b) if s0 else (v0, i0)
                        n1 = (v2, i2) if s2 else (e, b) if s1 else (v1, i1)
                        v2, i2 = (e, b) if s2 else (v2, i2)
                        (v0, i0), (v1, i1) = n0, n1
                    state[lane] = [(v0, i0), (v1, i1), (v2, i2)]
                carry = vals[-1, -1]
        lists = [s[::-1] for s in state]                 # best first
        o = lanes // 2
        while o:
            lists = [_merge3(lists[L], lists[L ^ o]) for L in range(lanes)]
            o //= 2
        assert all(lst == lists[0] for lst in lists)     # every lane agrees
        for k, (v, i) in enumerate(lists[0][::-1]):
            out[2 * k][r], out[2 * k + 1][r] = i, v
    return tuple(out)


def _top3_sets(name):
    from test_torch_formant import _metric_rows
    if name == "metric_rows":
        return [_metric_rows(5), _metric_rows(11, rows=6, bins=517)]
    if name == "corner_rows":
        return chip_smoke.top3_corner_rows()
    rng = np.random.default_rng(12)             # random rows, ragged B
    sets = []
    for B in (3, 4, 129, 255, 1000):
        m = rng.exponential(1.0, (5, B)).astype(np.float32)
        m[1] = np.round(m[1] * 2) / 2             # ties
        sets.append(m)
    return sets


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("data", ["metric_rows", "corner_rows", "random"])
@pytest.mark.parametrize("lanes,width,group", [
    (32, 4, 4), (32, 1, 4), (16, 4, 2), (8, 2, 3), (1, 1, 1)],
    ids=["kernel_vec", "kernel_scalar", "l16w4g2", "l8w2g3", "serial"])
def test_top3_merge_model_matches_plain_and_jax(data, lanes, width, group):
    """The kernel's lane partition and merge (csrc/top3.cu at 32 lanes,
    float4 or scalar loads; other partitions; one lane, the serial loop)
    against the plain loop and JAX's lax.scan, bit for bit, on the formant
    tests' metric rows, the corner rows of chip_smoke.top3_corner_rows and
    random rows at ragged B."""
    for m in _top3_sets(data):
        got = top3_merge_model(m, lanes, width, group)
        plain = spectral._top3_local_maxima(torch.as_tensor(m))
        ref = jspectral._top3_local_maxima(jnp.asarray(m))
        for g, p, r in zip(got, plain, ref):
            np.testing.assert_array_equal(_bits(g), _bits(p.numpy()))
            np.testing.assert_array_equal(_bits(g), _bits(r))
