"""Multi-process data parallelism on torch.distributed (the port of
signalsmith_stretch_tpu/parallel/distributed.py).

The reference engine is strictly single-stream (SURVEY.md §2.4); scaling to
a corpus is left to the caller.  Every process runs the same program,
joins one process group, and renders its own slice of the corpus on its
own devices.  Clip rendering is embarrassingly parallel, so the render
itself communicates nothing; the group carries only

  * the handshake (torch.distributed's TCP store),
  * the optional final `allgather` of rendered audio (debug or small
    corpora; production writes each process's outputs where it runs).

Each process loads only its own slice of the corpus (`shard_items`), so
input audio never crosses between processes.

Usage (the same program in every process):

    from signalsmith_stretch_torch.parallel import batch, distributed as dist
    dist.initialize()                      # env-driven; False single-process
    mesh = dist.global_mesh()              # this process's devices
    mine = dist.shard_items(all_items)     # this process's corpus slice
    fn = batch.batch_render(plan, flags, mesh=mesh)
    x = dist.global_batch(local_audio, mesh)     # this process's block
    out = fn(x, controls, local_seeds)           # this process's outputs
    everything = dist.allgather(out)             # every process's, in order
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from ..config import device_for
from .batch import Mesh, make_mesh, shard_batch

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> bool:
    """Join this process to the multi-process job.

    Arguments fall back to SST_COORDINATOR ("host:port") /
    SST_NUM_PROCESSES / SST_PROCESS_ID.  With no coordinator this returns
    False and the session stays single-process (every helper below then
    works on this process alone).  `backend` defaults to "nccl" when
    `device` is a CUDA device and to "gloo" for the CPU.

    Returns True iff a multi-process group is (now) active.
    """
    global _initialized
    if _initialized:
        return process_count() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("SST_COORDINATOR"))
    if num_processes is None:
        env = os.environ.get("SST_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("SST_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address is None:
        return False  # single-process session
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs the number of "
                         "processes and this process's id")
    if backend is None:
        backend = "nccl" if device_for(device, "initialize").type == "cuda" \
            else "gloo"
    tdist.init_process_group(backend, init_method=f"tcp://"
                             f"{coordinator_address}",
                             world_size=int(num_processes),
                             rank=int(process_id))
    _initialized = True
    return process_count() > 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def global_mesh(device="cuda") -> Mesh:
    """This process's devices: every CUDA device it sees (give each process
    its own cards with CUDA_VISIBLE_DEVICES), or the CPU.  Processes in
    rank order, each with its devices in order, make the global device
    order, matching `shard_items`' contiguous split."""
    dev = device_for(device, "global_mesh")
    return make_mesh() if dev.type == "cuda" else (dev,)


def shard_items(items: Sequence, index: Optional[int] = None,
                count: Optional[int] = None) -> List:
    """Contiguous per-process slice of a corpus list.

    Every process calls this on the SAME logically-ordered listing (e.g.
    sorted filenames) and loads only its own share; clip audio therefore
    never crosses between processes.  Contiguous (not round-robin), so that
    the blocks `allgather` returns in rank order are the listing's order.
    """
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    n = len(items)
    lo = (n * index) // count
    hi = (n * (index + 1)) // count
    return list(items[lo:hi])


def global_batch(local, mesh: Mesh) -> List[torch.Tensor]:
    """This process's block [local_batch, ...] of the global batch, placed
    on its devices (parallel.batch.shard_batch: one contiguous block a
    device).  torch has no global array: the global batch is every
    process's block in rank order, and each process holds only its own."""
    return shard_batch(local, mesh)


def allgather(x) -> np.ndarray:
    """Every process's block of a result, concatenated in rank order, on
    every process as numpy (debug / small corpora only: this is the one
    audio-sized transfer between processes).  x is a tensor or a list of
    per-device blocks; the blocks must be of equal size in every process."""
    if isinstance(x, (list, tuple)):
        x = torch.cat([torch.as_tensor(b).to(torch.as_tensor(x[0]).device)
                       for b in x])
    x = torch.as_tensor(x)
    if process_count() == 1:
        return x.cpu().numpy()
    if tdist.get_backend() == "nccl":
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        x = x.cpu()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(process_count())]
    tdist.all_gather(parts, x)
    return torch.cat(parts).cpu().numpy()
