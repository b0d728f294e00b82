"""Data-parallel corpus rendering over several devices (the port of
signalsmith_stretch_tpu/parallel/batch.py).

Rendering is embarrassingly parallel per clip, so the batch axis is split
across devices and nothing crosses between them but the final gather.  The
port's "mesh" is an ordered tuple of torch.devices; a batch on a mesh is
split contiguously along its batch axis, one equal block a device, as the
JAX package's NamedSharding(mesh, P("data")) splits it.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

from .. import engine, spectral
from ..config import device_for

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """`devices` in order (default: every CUDA device), the first
    `n_devices` of them."""
    if devices is None:
        device_for("cuda", "make_mesh")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    return tuple(devs)


def on_device(dev: torch.device):
    """The context that makes `dev` the current card (nothing for the CPU):
    the kernels launch on the current card's streams."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def shard_batch(batch, mesh: Mesh) -> List[torch.Tensor]:
    """[batch, ...] (numpy or a tensor) as one contiguous block a device of
    the mesh, each block on its device.  The batch must divide evenly, as
    for a NamedSharding."""
    n, k = len(batch), len(mesh)
    if n % k:
        raise ValueError(f"shard_batch: a batch of {n} does not split "
                         f"evenly over {k} devices")
    per = n // k
    return [torch.as_tensor(batch[i * per:(i + 1) * per], device=dev)
            for i, dev in enumerate(mesh)]


def _host_seeds(seeds, n: int) -> List[int]:
    if seeds is None:
        return list(range(n))
    seeds = [int(s) for s in torch.as_tensor(seeds).cpu().reshape(-1)]
    if len(seeds) != n:
        raise ValueError(f"{len(seeds)} seeds for {n} clips")
    return seeds


def batch_render(plan: engine.ExactPlan, flags: spectral.SpectralFlags,
                 mesh: Optional[Sequence] = None, device="cuda"):
    """A batched exact() renderer run(audio_batch, controls, seeds=None):
    [batch, ch, in] -> [batch, ch, out], a float32 tensor on the mesh's
    first device.

    audio_batch is numpy or a tensor (split over the mesh by shard_batch),
    or already a list of per-device blocks (shard_batch's or
    distributed.global_batch's).  seeds: one integer a clip for the
    randomised regime above 2x (default 0, 1, ...), a clip's seed whatever
    device renders it.  run issues every device's block through
    engine.render_exact before it waits on any of them, then gathers the
    results in order; a clip's output does not depend on the split.
    mesh None: one device, `device`."""
    mesh = (tuple(torch.device(d) for d in mesh) if mesh is not None
            else (device_for(device, "batch_render"),))

    def run(audio_batch, controls: spectral.Controls, seeds=None):
        parts = (list(audio_batch) if isinstance(audio_batch, (list, tuple))
                 else shard_batch(audio_batch, mesh))
        if len(parts) != len(mesh):
            raise ValueError(f"{len(parts)} blocks for {len(mesh)} devices")
        seeds = _host_seeds(seeds, sum(len(p) for p in parts))
        outs, at = [], 0
        for dev, part in zip(mesh, parts):
            with on_device(dev):
                part = torch.as_tensor(part, dtype=torch.float32, device=dev)
                k = part.shape[0]
                outs.append(engine.render_exact(part, plan, controls, flags,
                                                seeds=seeds[at:at + k]))
            at += k
        return torch.cat([o.to(mesh[0]) for o in outs])

    return run
