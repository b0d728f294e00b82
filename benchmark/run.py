#!/usr/bin/env python3
"""The benchmark of signalsmith_stretch_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout: builds the
cell's system under test from its configuration (benchmark/configs/,
whose `controls` go to the program's builders as they stand) with the
loop that its traffic mix (benchmark/traffic/<mix>.json) names
(benchmark/loops/<loop>.py), warms up, measures for --seconds (with
--trace 1, a traced window and the per-layer readers of
benchmark/metrics/ instead), then checks the timed path's outputs against
the plain reference (benchmark/reference/) with the limits of
benchmark/limits/<cell>.json.  The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device, and with --trace
1 the breakdown; the compared numbers last); the last lines of standard
error give each compared number beside its limit.  Without a CUDA card,
or with fewer than the cell asks for, it exits with 3 and prints no
result; a run that finds JAX or the JAX package loaded exits with 4.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels under build/torch_kernels/ itself;
    PyTorch keeps the kernels it compiles at run time, its jiterator's,
    under PYTORCH_KERNEL_CACHE_PATH)."""
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)


def _fail(code: int, why: str):
    print(why, file=sys.stderr)
    sys.exit(code)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    _caches()
    from benchmark.harness import common, runner
    bench = common.benchmark()
    cell = common.cell(bench, args.workload)
    cfg = common.config(bench, cell["config"])
    traffic = common.traffic(cell["traffic"])
    limits = common.limits(cell["name"])
    import torch
    if not torch.cuda.is_available():
        _fail(3, "torch.cuda.is_available() is false: the benchmark needs "
                 "an NVIDIA GPU")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(3, f"{cell['name']} needs {cell['chips']} GPUs, found "
                 f"{torch.cuda.device_count()}")
    try:
        line = runner.measure(bench, cell, cfg, traffic, limits, args.seed,
                              args.seconds, bool(args.trace), T0)
    except runner.Forbidden as e:
        _fail(4, str(e))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
