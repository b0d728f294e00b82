"""Stream-state checkpointing: save a stream's state to an npz file and
load it back (the port of signalsmith_stretch_tpu/utils/checkpoint.py).

The file is the one the JAX package's `checkpoint.save` writes for the same
state, so it crosses between the packages both ways: the state's leaves in
JAX's flatten order (the spectral carry's fields, then StreamState's
buffers and scalars), keyed "0", "1", ...; a complex leaf as float32
"{i}_re" and "{i}_im"; every leaf in its JAX dtype (the PRNG key uint32[2],
the counters int32, the latches bool, the seek time factor float32).

There is no orbax variant: the port keeps to torch and numpy.
"""
from __future__ import annotations

import numpy as np

from .. import convert

CARRY_FIELDS = ("input", "prev_input", "output", "pred_energy",
                "freq_est_weighted", "freq_est_weight", "rng")
STATE_FIELDS = ("in_hist", "out_tail", "weight_tail", "samples_since_last",
                "prev_input_offset", "did_seek", "seek_time_factor",
                "silence_counter", "silence_first")


def save(path: str, state) -> None:
    """Write a StreamState to `path` (npz)."""
    d = convert.stream_state_to_arrays(state)
    leaves = ([d["carry"][f] for f in CARRY_FIELDS]
              + [d[f] for f in STATE_FIELDS])
    out = {}
    for i, leaf in enumerate(leaves):
        if np.iscomplexobj(leaf):
            out[f"{i}_re"] = leaf.real.astype(np.float32)
            out[f"{i}_im"] = leaf.imag.astype(np.float32)
        else:
            out[str(i)] = leaf
    np.savez(path, **out)


def load(path: str, template):
    """Restore a state saved by save() (of either package) on the device of
    `template`, a StreamState of the same configuration (e.g. a fresh
    stream's)."""
    n = len(CARRY_FIELDS) + len(STATE_FIELDS)
    with np.load(path) as z:
        leaves = []
        for i in range(n):
            if f"{i}_re" in z:
                leaves.append((z[f"{i}_re"] + 1j * z[f"{i}_im"])
                              .astype(np.complex64))
            else:
                leaves.append(z[str(i)])
        if len(z.files) != n + sum(np.iscomplexobj(v) for v in leaves):
            raise ValueError(f"{path}: not a stream state of {n} leaves")
    nc = len(CARRY_FIELDS)
    d = dict(zip(STATE_FIELDS, leaves[nc:]))
    d["carry"] = dict(zip(CARRY_FIELDS, leaves[:nc]))
    state = convert.stream_state_from_arrays(d, template.in_hist.device)
    for f in ("in_hist", "out_tail", "weight_tail"):
        if getattr(state, f).shape != getattr(template, f).shape:
            raise ValueError(f"{path}: {f} has shape "
                             f"{tuple(getattr(state, f).shape)}, the "
                             f"template {tuple(getattr(template, f).shape)}")
    return state
