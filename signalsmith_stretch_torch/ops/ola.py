"""The synthesis's assembly (kernel L, csrc/ola.cu).

`assemble` turns a render's windowed blocks [batch, ch, nB, block] (kernel
K's, or `stft.synthesize`'s) into its output [batch, ch, out_samples]: the
overlap-add into the output ring, the WOLA normalisation, the outputSeek
pre-roll cancellation (signalsmith-stretch.h:198-203), the reversed-tail
subtraction of the flush (:444-454) and the silence bypass (:240-278).  It
replaces no Pallas kernel: the JAX package assembles in plain jnp
(signalsmith_stretch_tpu/engine.py: _overlap_add, synthesis_stage).  On a
CPU tensor, or inside ops.plain(), it runs the plain version,
`assemble_plain` (a ring, its group strips, the divisions and the selects
as tensor ops); on a CUDA tensor it sums the two energies the bypass tests
(four operations, the plain version's) and launches the kernel, or raises.
The kernel is held to the plain version bit for bit on the same blocks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, runs_plain
from ..config import NOISE_FLOOR
from ..tables import on_device

launches = 0          # kernel launches of assemble
# the bypasses a plan can reach, as csrc/ola.cu's `modes` bits
MAIN_POSSIBLE, FLUSH_PRE, FLUSH_ALONE = 1, 2, 4


def overlap_add(blocks_t: torch.Tensor, out_pos: np.ndarray,
                ring_len: int, block: int, interval: int) -> torch.Tensor:
    """blocks_t [batch, ch, nB, block] -> ring [batch, ch, ring_len].

    Blocks sit every `interval` samples.  Blocks k = g, g+m, g+2m, ... (with
    m = ceil(block/interval)) never overlap, so each group is its blocks laid
    end to end (a reshape), and the ring is the sum of the m group strips,
    added in group order."""
    batch, ch, n_b, _ = blocks_t.shape
    first = int(out_pos[0])
    m = -(-block // interval)
    pad = m * interval - block
    total = blocks_t.new_zeros((batch, ch, ring_len))
    for g in range(m):
        grp = blocks_t[:, :, g::m]
        n_g = grp.shape[2]
        if not n_g:
            continue
        flat = F.pad(grp, (0, pad)).reshape(batch, ch, n_g * m * interval)
        ofs = first + g * interval
        seg = max(0, min(n_g * m * interval, ring_len - ofs))
        if seg:
            total[..., ofs:ofs + seg] += flat[..., :seg]
    return total


def bypass_tail(blocks_t, spans, weight, w0: int, T: int, L: int, preroll):
    """Flush tail (:444-454) read at an un-advanced head `w0` from a ring
    holding only the given block spans (bypassed stages never ran their
    synthesis).  The outputSeek pre-roll cancellation (:198-203) lives at
    ring [L, 2L) and is included where the window overlaps it."""
    buf = blocks_t.new_zeros(blocks_t.shape[:2] + (2 * T,))
    for k, a, b, off in spans:
        buf[..., a - w0:b - w0] += blocks_t[:, :, k, off:off + (b - a)]
    lo, hi = max(w0, L), min(w0 + 2 * T, 2 * L)
    if lo < hi:   # -preroll[L-1-(j-L)] at ring position j
        buf[..., lo - w0:hi - w0] -= preroll[..., 2 * L - hi:2 * L - lo].flip(-1)
    t = buf / on_device(weight, buf.device)
    return t[..., :T] - t[..., T:].flip(-1)


def energy(audio: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """Each clip's total energy over input samples [start, start+length)
    (the reference's scans, :231-238): [batch] float32."""
    seg = audio[..., start:start + max(length, 0)]
    return (seg * seg).sum((1, 2))


def assemble_plain(blocks_t: torch.Tensor, plan,
                   audio: torch.Tensor = None) -> torch.Tensor:
    """Plain version of the assembly: blocks_t [batch, ch, nB, block] ->
    [batch, ch, out_samples].  With `audio` given, the silence bypass
    selects, per clip, between the normal assembly and passthrough/zeros
    with restricted-ring tails; without it the bypass is off."""
    cfg, sch = plan.cfg, plan.sched
    ring = overlap_add(blocks_t, plan.arrays["out_pos"], sch.ring_len,
                       cfg.block_samples, cfg.interval_samples)
    w = on_device(plan.weight, ring.device)
    L = sch.preroll_len
    preroll = ring[..., :L] / w[:L]
    # outputSeek: negate + reverse the pre-roll into the ring (:198-203)
    ring[..., L:2 * L] -= preroll.flip(-1)

    def read(a, n):
        return ring[..., a:a + n] / w[a:a + n]

    main = read(L, sch.main_out)
    fz0 = L + sch.main_out
    flush_zero = read(fz0, sch.flush_block_out)
    head = fz0 + sch.flush_block_out
    T = sch.tail_len
    tail = read(head, T) - read(head + T, T).flip(-1)

    sil = plan.silence
    if audio is not None and sil is not None and sil.possible:
        # total-energy scans (:231-238), per clip
        def silent(start, length):
            return (energy(audio, start, length) < NOISE_FLOOR)[:, None, None]

        pre_silent = silent(sch.seek_samples, sch.surplus)
        main_silent = silent(sch.seek_length, sch.main_in)
        no = torch.zeros_like(main_silent)
        main_b = (main_silent & pre_silent) if sil.main_possible else no
        fp, fa = sil.flush_possible_pre, sil.flush_possible_alone
        if fp == fa:
            flush_b = main_silent & fp
        else:   # only reachable when the pre-roll was silent too (fp, not fa)
            flush_b = main_silent & pre_silent & fp
        if sil.pass_idx is not None:
            passthrough = audio[..., on_device(sil.pass_idx, audio.device,
                                               np.asarray, np.int64)]
        else:
            passthrough = torch.zeros_like(main)
        main = torch.where(main_b, passthrough, main)
        if sch.flush_block_out > 0:
            flush_zero = torch.where(flush_b, torch.zeros_like(flush_zero),
                                     flush_zero)
            tail_pm = bypass_tail(blocks_t, sil.pm_spans, sil.pm_weight,
                                  L + sch.main_out, T, L, preroll)
            tail = torch.where(flush_b, tail_pm, tail)
        if sil.main_possible and T > 0:
            tail_pre = bypass_tail(blocks_t, sil.pre_spans, sil.pre_weight,
                                   L, T, L, preroll)
            tail = torch.where(main_b, tail_pre, tail)
    return torch.cat([main, flush_zero, tail], -1)


def assemble(blocks_t: torch.Tensor, plan,
             audio: torch.Tensor = None) -> torch.Tensor:
    """Kernel wrapper: blocks_t [batch, ch, nB, block] f32 -> [batch, ch,
    out_samples] f32; `audio` [batch, ch, in_samples] f32 turns the silence
    bypass on, as in assemble_plain."""
    global launches
    if runs_plain(blocks_t):
        return assemble_plain(blocks_t, plan, audio)
    cfg, sch, sil = plan.cfg, plan.sched, plan.silence
    batch, ch, nB, block = blocks_t.shape
    H, L, T = cfg.interval_samples, sch.preroll_len, sch.tail_len
    out_pos = plan.arrays["out_pos"]
    if (blocks_t.dtype != torch.float32 or block != cfg.block_samples
            or nB != len(out_pos)):
        raise TypeError(f"assemble: float32 blocks [batch, ch, {len(out_pos)}"
                        f", {cfg.block_samples}] expected, got "
                        f"{blocks_t.dtype} {tuple(blocks_t.shape)}")
    reach = max(2 * L, L + sch.main_out + sch.flush_block_out + 2 * T)
    if reach > sch.ring_len:
        raise ValueError("assemble: the output reads past the ring")
    dev = blocks_t.device
    x = blocks_t.contiguous()
    w = on_device(plan.weight, dev)
    out = torch.empty((batch, ch, sch.out_samples), dtype=torch.float32,
                      device=dev)
    tensors, modes, ptrs = [x, w, out], 0, [None] * 5
    if audio is not None and sil is not None and sil.possible:
        want = (batch, ch, sch.in_samples)
        if audio.dtype != torch.float32 or tuple(audio.shape) != want:
            raise TypeError(f"assemble: float32 audio {list(want)} expected, "
                            f"got {audio.dtype} {tuple(audio.shape)}")
        a = audio.contiguous()
        pre_e = energy(a, sch.seek_samples, sch.surplus)
        main_e = energy(a, sch.seek_length, sch.main_in)
        pre_wt = on_device(sil.pre_weight, dev)
        pm_wt = on_device(sil.pm_weight, dev)
        tensors += [a, pre_e, main_e, pre_wt, pm_wt]
        modes = (MAIN_POSSIBLE * sil.main_possible
                 + FLUSH_PRE * sil.flush_possible_pre
                 + FLUSH_ALONE * sil.flush_possible_alone)
        ptrs = [t.data_ptr() if t.numel() else None
                for t in (a, pre_e, main_e, pre_wt, pm_wt)]
    _build.require_cuda(*tensors)
    rc = _build.entry("ola")(
        x.data_ptr(), w.data_ptr(), *ptrs, out.data_ptr(), batch * ch, ch,
        nB, block, H, int(out_pos[0]), L, sch.main_out, sch.flush_block_out,
        T, sch.in_samples, sch.seek_length, sch.main_in,
        sch.n_preroll_blocks, sch.n_preroll_blocks + sch.n_main_blocks,
        modes, float(np.float32(NOISE_FLOOR)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sst_ola")
    launches += 1
    return out
