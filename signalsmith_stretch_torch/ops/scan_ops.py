"""Serial scans along bins: kernels C, E and F.

- C (csrc/scan.cu), the energy slew smoothing
  y_b = y_{b-1} + (x_b - y_{b-1}) * slew (signalsmith-stretch.h:816-848);
- E (csrc/decay.cu), the formant envelope's decay passes
  y_b = op(x_b, d * y_{b-1}) with op the C++ std::max / std::min, which
  keeps x_b when the product is NaN (:984-1007);
- F (csrc/top3.cu), the pitch estimator's top-3 local-maximum insertion
  (:931-948; plain version `spectral._top3_local_maxima`).

Each runs serially in the reference's order.  C and E run a chain of passes
in one launch (`iir_chain`, `decay_chain`): each pass starts from the
previous pass's last value and runs over the previous pass's output, as the
planner's smoothing and envelope do.  Their kernel (csrc/chain.cuh) streams
tiles of 32 rows x CHAIN_TILE bins through a ring of shared-memory slots;
the order of computes, loads and stores is the walk of `chain_walk`, which
the kernel follows step by step from a table.  On a CPU tensor, or inside
ops.plain(), the wrappers run the plain PyTorch loops; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, runs_plain
from .. import spectral

launches = 0          # kernel launches of iir_chain and its one-pass forms (C)
decay_launches = 0    # kernel launches of decay_chain and decay (E)
top3_launches = 0     # kernel launches of top3_local_maxima (F)

# the chain kernels' walk (csrc/chain.cuh holds the same constants)
CHAIN_TILE = 128      # bins a tile
CHAIN_LEAD = 3        # steps between a tile's load and its compute
CHAIN_KEEP = 2        # tiles kept in shared memory across a reversal
CHAIN_PITCH = CHAIN_TILE + 4   # floats a tile row takes in shared memory
CHAIN_MAX_SLOTS = 13  # slots of 32 x CHAIN_PITCH floats in 227 KB
# pass flags: bit 0 backward; E adds bit 1 min (else max), bit 2 the
# second coefficient row
BACKWARD, MIN, COEF1 = 1, 2, 4


def chain_walk(B: int, flags, tile: int = CHAIN_TILE):
    """The step table of one chain of passes over rows of B bins, cut in
    tiles of `tile` bins (CHAIN_TILE, the kernel's; the tests take
    others).  flags: one int per pass (bit 0 backward).

    Step j of the kernel: the computing warp runs tile `comp_tile` of its
    pass in ring slot `comp_slot`, in place; meanwhile the copying warps
    store slot `store_slot` to the output's tile `store_tile` and start an
    asynchronous copy of tile `load_tile` of the input (`load_src` 0) or of
    the output (1) into slot `load_slot`; a barrier ends the step.  A copy
    started at step j has landed by step j + CHAIN_LEAD.  The last
    CHAIN_KEEP tiles of a pass stay in their slots when the next pass runs
    the other way, whose first tiles they are.  Returns (steps int32
    [n, 8] with columns comp_slot, comp_tile, comp_flags, store_slot,
    store_tile, load_slot, load_tile, load_src, -1 where a step has no such
    part; slots)."""
    flags = tuple(int(f) for f in flags)
    if B < 1 or not flags or tile < 1:
        raise ValueError(f"chain_walk: B={B}, {len(flags)} passes, tile "
                         f"{tile}")
    lead, keep = CHAIN_LEAD, CHAIN_KEEP
    nt = -(-B // tile)
    P = len(flags)

    def order(p):
        return list(range(nt - 1, -1, -1)) if flags[p] & BACKWARD \
            else list(range(nt))

    def reverses(p):      # pass p runs the other way from pass p - 1
        return 0 < p < P and (flags[p] ^ flags[p - 1]) & BACKWARD

    steps = {}            # step -> [8 ints]

    def at(j):
        return steps.setdefault(j, [-1] * 8)

    free_from = []        # per slot: the first step a copy may fill it
    slot_of = {}          # tile -> slot while kept across a reversal
    stored = {}           # tile -> step its last store ran
    j = -1                # the last compute step
    for p in range(P):
        for i, t in enumerate(order(p)):
            if reverses(p) and i < keep:
                slot = slot_of.pop(t)             # resident: no copy
                j += 1
            else:
                ready = 0 if p == 0 else stored[t] + 1
                j = max(j + 1, ready + lead)
                ld = j - lead
                slot = next((s for s, f in enumerate(free_from) if f <= ld),
                            None)
                if slot is None:
                    slot = len(free_from)
                    free_from.append(0)
                e = at(ld)
                e[5], e[6], e[7] = slot, t, int(p > 0)
                free_from[slot] = 1 << 62          # busy until released
            e = at(j)
            e[0], e[1], e[2] = slot, t, flags[p]
            if reverses(p + 1) and i >= nt - keep:
                slot_of[t] = slot                 # kept for pass p + 1
            else:
                e = at(j + 1)
                e[3], e[4] = slot, t
                stored[t] = j + 1
                free_from[slot] = j + 2
    n = max(steps) + 1
    table = np.full((n, 8), -1, np.int32)
    for s, e in steps.items():
        table[s] = e
    return table, len(free_from)


@functools.lru_cache(maxsize=32)
def _walk_table(B: int, flags: tuple, device: torch.device):
    """chain_walk's table on the card, once per (B, passes, device)."""
    table, slots = chain_walk(B, flags)
    if slots > CHAIN_MAX_SLOTS:
        raise ValueError(f"chain: the walk needs {slots} shared-memory slots, "
                         f"the kernel has room for {CHAIN_MAX_SLOTS}")
    return torch.as_tensor(table).to(device), table.shape[0], slots


def _check_rows(what, x, *rows):
    _build.require_cuda(x, *rows)
    if any(t.dtype != torch.float32 for t in (x, *rows)):
        raise TypeError(f"{what}: float32 tensors expected")
    if x.dim() != 2 or any(t.shape != x.shape[:1] for t in rows):
        raise ValueError(f"{what}: x [R, B] and rows [R] expected, got "
                         f"{tuple(x.shape)} and "
                         f"{[tuple(t.shape) for t in rows]}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: {tuple(x.shape)} exceeds 32-bit indexing")


def iir_plain(x: torch.Tensor, init: torch.Tensor, slew: float,
              backward: bool = False):
    """Plain version: a loop over bins.  x [..., B], init [...] ->
    (y [..., B], final [...]) where final is the last value computed."""
    B = x.shape[-1]
    y = torch.empty_like(x)
    v = init
    for b in (range(B - 1, -1, -1) if backward else range(B)):
        v = v + (x[..., b] - v) * slew
        y[..., b] = v
    return y, v


def iir_chain_plain(x: torch.Tensor, init: torch.Tensor, slew: float,
                    directions):
    """Plain version of `iir_chain`: the passes of `iir_plain` in order,
    each over the previous pass's output from its last value."""
    if not len(directions):
        raise ValueError("iir_chain: no passes")
    y, v = x, init
    for backward in directions:
        y, v = iir_plain(y, v, slew, bool(backward))
    return y, v


def iir_chain(x: torch.Tensor, init: torch.Tensor, slew: float, directions):
    """Kernel wrapper (C): x [R, B] f32, init [R] f32, directions one bool
    per pass (True for a backward pass) -> (y, final), every pass in one
    launch."""
    global launches
    directions = tuple(bool(d) for d in directions)
    if runs_plain(x):
        return iir_chain_plain(x, init, slew, directions)
    if not directions:
        raise ValueError("iir_chain: no passes")
    _check_rows("iir_chain", x, init)
    R, B = x.shape
    y = torch.empty_like(x)
    fin = torch.empty_like(init)
    walk, nsteps, slots = _walk_table(B, directions, x.device)
    rc = _build.entry("scan")(
        x.data_ptr(), init.data_ptr(), y.data_ptr(), fin.data_ptr(), R, B,
        slew, walk.data_ptr(), nsteps, slots, CHAIN_TILE, CHAIN_LEAD,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sst_iir_chain")
    launches += 1
    return y, fin


def iir(x: torch.Tensor, init: torch.Tensor, slew: float,
        backward: bool = False):
    """One pass: x [R, B] f32, init [R] f32 -> (y, final)."""
    return iir_chain(x, init, slew, (backward,))


def iir_forward(x: torch.Tensor, init: torch.Tensor, slew: float):
    """Forward along the last axis -> (y, y[..., -1])."""
    return iir(x, init, slew)


def iir_backward(x: torch.Tensor, init: torch.Tensor, slew: float):
    """Backward along the last axis -> (y, y[..., 0])."""
    return iir(x, init, slew, backward=True)


def decay_plain(x: torch.Tensor, init: torch.Tensor, coef: torch.Tensor,
                is_min: bool, backward: bool = False):
    """Plain version of the decay scans: a loop over bins.  x [R, B], init
    and the per-row coefficient coef [R] -> (y [R, B], final [R])."""
    B = x.shape[-1]
    y = torch.empty_like(x)
    v = init
    for b in (range(B - 1, -1, -1) if backward else range(B)):
        a, t = x[:, b], coef * v
        v = torch.where(t < a, t, a) if is_min else torch.where(a < t, t, a)
        y[:, b] = v
    return y, v


def decay_chain_plain(x: torch.Tensor, init: torch.Tensor, passes):
    """Plain version of `decay_chain`: the passes of `decay_plain` in order,
    each over the previous pass's output from its last value."""
    if not len(passes):
        raise ValueError("decay_chain: no passes")
    y, v = x, init
    for coef, is_min, backward in passes:
        y, v = decay_plain(y, v, coef, is_min, backward)
    return y, v


def decay_chain(x: torch.Tensor, init: torch.Tensor, passes):
    """Kernel wrapper (E): x [R, B] f32, init [R] f32, passes the ordered
    (coef [R] f32, is_min, backward) of each pass -> (y, final), every pass
    in one launch, y_b = min or max(x_b, coef * y_{b-1}) along the last
    axis (backward: from the last bin down).  The passes may use at most
    two distinct coefficient tensors."""
    global decay_launches
    passes = list(passes)
    if runs_plain(x):
        return decay_chain_plain(x, init, passes)
    if not passes:
        raise ValueError("decay_chain: no passes")
    coefs, flags = [], []
    for coef, is_min, backward in passes:
        idx = next((i for i, c in enumerate(coefs) if c is coef), len(coefs))
        if idx == len(coefs):
            coefs.append(coef)
        flags.append(BACKWARD * bool(backward) + MIN * bool(is_min)
                     + COEF1 * idx)
    if len(coefs) > 2:
        raise ValueError(f"decay_chain: {len(coefs)} coefficient tensors, "
                         f"the kernel takes two")
    _check_rows("decay_chain", x, init, *coefs)
    R, B = x.shape
    y = torch.empty_like(x)
    fin = torch.empty_like(init)
    walk, nsteps, slots = _walk_table(B, tuple(flags), x.device)
    rc = _build.entry("decay")(
        x.data_ptr(), init.data_ptr(), coefs[0].data_ptr(),
        coefs[-1].data_ptr(), y.data_ptr(), fin.data_ptr(), R, B,
        walk.data_ptr(), nsteps, slots, CHAIN_TILE, CHAIN_LEAD,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sst_decay_chain")
    decay_launches += 1
    return y, fin


def decay(x: torch.Tensor, init: torch.Tensor, coef: torch.Tensor,
          is_min: bool, backward: bool = False):
    """One decay pass: x [R, B] f32, init and coef [R] f32 -> (y, final)."""
    return decay_chain(x, init, [(coef, is_min, backward)])


def top3_local_maxima(metric: torch.Tensor):
    """Kernel wrapper (F): metric [R, B] f32 -> (i0, v0, i1, v1, i2, v2),
    each [R], indices int32 and values f32."""
    global top3_launches
    if runs_plain(metric):
        return spectral._top3_local_maxima(metric)
    _build.require_cuda(metric)
    if metric.dtype != torch.float32 or metric.dim() != 2:
        raise TypeError("top3_local_maxima: a float32 [R, B] metric expected")
    R, B = metric.shape
    if B < 3:
        raise ValueError(f"top3_local_maxima: {B} bins, at least 3 expected")
    idx = torch.empty((3, R), dtype=torch.int32, device=metric.device)
    val = torch.empty((3, R), dtype=torch.float32, device=metric.device)
    rc = _build.entry("top3")(
        metric.data_ptr(), idx.data_ptr(), val.data_ptr(), R, B,
        torch.cuda.current_stream(metric.device).cuda_stream)
    _build.check(rc, "sst_top3")
    top3_launches += 1
    return idx[0], val[0], idx[1], val[1], idx[2], val[2]
