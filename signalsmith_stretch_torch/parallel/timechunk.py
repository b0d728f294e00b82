"""Sequence-parallel long-clip rendering: time chunks with input halos (the
port of signalsmith_stretch_tpu/parallel/timechunk.py).

The reference's block-to-block phase recursion (Band.output feeding the next
block, signalsmith-stretch.h:715-716, 788) makes time exactly-sequential, but
the reference itself ships a re-anchoring mechanism for jumping into the
middle of a stream: `outputSeek` (:172-204), which rebuilds latency-aligned
output from a window of surrounding input.  Long clips reuse exactly that:
split the *output* into chunks, give each chunk its input range plus an
`outputSeekLength` left halo, render each chunk independently (the phase state
re-anchors from the halo), and concatenate, sample-aligned by construction.

Per-chunk outputs differ from a monolithic render only through the chaotic
phase microstructure near chunk starts (docs/PARITY.md); band-energy
structure is preserved.  The chunks go through one engine.render_exact per
device, on that device's contiguous run of chunks, so a split over devices
renders every chunk as the unsplit render does.
"""
from __future__ import annotations

import numpy as np

from .. import engine, spectral
from ..config import StretchConfig
from .batch import batch_render

f32 = np.float32


def plan_chunks(cfg: StretchConfig, in_samples: int, out_samples: int,
                n_chunks: int):
    """Split the output into n_chunks uniform windows and compute input
    windows at the *global* rate.

    exact() maps its whole input buffer onto its whole output buffer
    (output[0] <-> buffer[0]), so each chunk's in/out lengths must keep the
    global ratio: the chunk input window is round(out_len * rate) samples
    starting at round(out_edge * rate); drift against the monolithic time
    map stays below one sample per chunk.
    """
    rate = float(np.float32(in_samples) / np.float32(out_samples))
    out_len = -(-out_samples // n_chunks)
    out_edges = [min(i * out_len, out_samples) for i in range(n_chunks + 1)]
    in_len = int(round(out_len * rate))
    starts = [int(round(out_edges[i] * rate)) for i in range(n_chunks)]
    return out_edges, starts, in_len, out_len


def chunk_windows(audio: np.ndarray, starts, in_len: int) -> np.ndarray:
    """[n_chunks, ch, in_len] input windows, zero-padded outside the clip."""
    ch, in_samples = audio.shape
    pad = in_len + 8
    padded = np.zeros((ch, in_samples + 2 * pad), f32)
    padded[:, pad:pad + in_samples] = audio
    return np.stack([padded[:, pad + s:pad + s + in_len] for s in starts])


def assemble(outs: np.ndarray, out_edges, out_samples: int) -> np.ndarray:
    """The chunks' outputs [n_chunks, ch, out_len] as one [ch, out_samples]."""
    result = np.zeros((outs.shape[1], out_samples), f32)
    for i in range(len(out_edges) - 1):
        a, b = out_edges[i], out_edges[i + 1]
        if b > a:
            result[:, a:b] = outs[i][:, :b - a]
    return result


def stretch_long(audio: np.ndarray, out_samples: int, cfg: StretchConfig,
                 controls: spectral.Controls, flags: spectral.SpectralFlags,
                 n_chunks: int, seed: int = 0, mesh=None,
                 device="cuda") -> np.ndarray:
    """Render a long clip as n_chunks independent re-anchored chunks.

    audio [ch, in_samples] -> [ch, out_samples] float32 numpy.  The chunks
    are one batch (seeds arange(n_chunks) + seed), split over `mesh` (a
    tuple of devices, parallel.batch.make_mesh; n_chunks must divide
    evenly) or rendered on `device` when mesh is None.  Each chunk
    re-anchors through exact()'s outputSeek, so chunk outputs are
    sample-aligned; they differ from a monolithic render only in phase
    microstructure near chunk starts (fresh phase state; docs/PARITY.md).
    """
    audio = np.asarray(audio, f32)
    out_edges, starts, in_len, out_len = plan_chunks(
        cfg, audio.shape[1], out_samples, n_chunks)
    windows = chunk_windows(audio, starts, in_len)
    plan = engine.build_exact_plan(cfg, in_len, out_len)
    run = batch_render(plan, flags, mesh=mesh, device=device)
    seeds = np.arange(n_chunks, dtype=np.int32) + seed
    outs = run(windows, controls, seeds).cpu().numpy()
    return assemble(outs, out_edges, out_samples)
