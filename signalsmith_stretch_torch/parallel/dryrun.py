"""Multi-process dry run of the parallel layer, on the CPU (the twin of the
JAX package's `__graft_entry__.dryrun_multichip`).

torch has no virtual devices, so `dryrun_multichip(n)` starts n processes,
joined in one gloo group on localhost, each with the CPU as its one device.
Both parallel axes run at tiny shapes (cheaper preset, stereo 4 kHz):

  * data parallel: a batch of 2n clips, each process rendering its
    `shard_items` slice through `batch.batch_render`;
  * time chunks: one long clip as n chunks (`timechunk.plan_chunks`), each
    process rendering its slice of the chunks.

Each process allgathers both results and holds them bit-equal to one
process rendering everything (`batch_render` on the whole batch,
`stretch_long` on the whole clip), then prints DRYRUN_OK and its rank.

    python -m signalsmith_stretch_torch.parallel.dryrun 2
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMEOUT = 120.0       # seconds for the whole run


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _setup(n: int):
    """The run's tiny shapes and inputs (__graft_entry__.py:82-98)."""
    from .. import engine, spectral
    from ..config import StretchConfig
    cfg = StretchConfig.preset_cheaper(2, 4000, False)
    in_len, out_len = 4000, 5000
    plan = engine.build_exact_plan(cfg, in_len, out_len)
    controls = spectral.Controls.make(freq_multiplier=1.1)
    flags = spectral.SpectralFlags(mapped=True)
    rng = np.random.default_rng(0)
    clips = rng.standard_normal((2 * n, 2, in_len)).astype(np.float32)
    clips *= 0.1
    long_in = rng.standard_normal((2, 4 * in_len)).astype(np.float32) * 0.1
    return cfg, plan, controls, flags, clips, long_in, 5 * in_len


def worker(port: int, rank: int, n: int) -> None:
    import torch
    from .. import engine
    from . import batch, distributed as dist, timechunk
    torch.set_num_threads(1)
    assert dist.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=n, process_id=rank, device="cpu")
    assert dist.process_count() == n and dist.process_index() == rank
    cfg, plan, controls, flags, clips, long_in, long_out_len = _setup(n)
    mesh = dist.global_mesh("cpu")

    # data parallel: this process's clips, allgathered in rank order
    mine = dist.shard_items(list(range(len(clips))))
    fn = batch.batch_render(plan, flags, mesh=mesh)
    out = fn(dist.global_batch(clips[mine], mesh), controls, mine)
    got = dist.allgather(out)
    want = batch.batch_render(plan, flags, device="cpu")(
        clips, controls).numpy()
    assert got.shape == want.shape and np.array_equal(got, want), "DP leg"

    # time chunks: this process's chunks of one long clip
    edges, starts, in_len, out_len = timechunk.plan_chunks(
        cfg, long_in.shape[1], long_out_len, n)
    windows = timechunk.chunk_windows(long_in, starts, in_len)
    chunks = dist.shard_items(list(range(n)))
    cplan = engine.build_exact_plan(cfg, in_len, out_len)
    outs = batch.batch_render(cplan, flags, mesh=mesh)(
        windows[chunks], controls, chunks)
    long_out = timechunk.assemble(dist.allgather(outs), edges, long_out_len)
    mono = timechunk.stretch_long(long_in, long_out_len, cfg, controls,
                                  flags, n_chunks=n, device="cpu")
    assert np.array_equal(long_out, mono), "time-chunk leg"
    assert float(np.max(np.abs(long_out))) > 0.0
    torch.distributed.destroy_process_group()
    print(f"DRYRUN_OK {rank}: DP {got.shape}, time chunks {long_out.shape}",
          flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """Run the dry run in n_devices processes; raises if any process fails
    or the run outlasts TIMEOUT seconds."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "signalsmith_stretch_torch.parallel.dryrun",
         "--worker", str(port), str(rank), str(n_devices)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for rank in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DRYRUN_OK {rank}" not in out:
            raise RuntimeError(f"dryrun process {rank}: rc {p.returncode}\n"
                               f"{out[-3000:]}")
    print(f"dryrun_multichip({n_devices}): ok, {n_devices} gloo processes; "
          + outs[0].strip().splitlines()[-1].split(": ", 1)[1])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(*[int(a) for a in sys.argv[2:5]])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
