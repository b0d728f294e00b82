"""Build the hand-written CUDA kernels of csrc/ and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own with nvcc into a shared library
with a plain C interface under `build/torch_kernels/` at the root of the
checkout; the file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited kernel is rebuilt and an
unchanged one is reused.  Nothing is
compiled when a module is imported: the first wrapper call on a CUDA tensor
(or an explicit `build()`) does it.

Flags: sm_90a (Hopper), -O3, and --fmad=false so that `a*b + c` rounds twice
exactly as the plain PyTorch versions do (IEEE division and square root are
nvcc's default; no fast math).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# each C entry point by name: its source csrc/<source>.cu, its symbol and its
# argument types; every entry point returns the cudaError_t of its launch
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY = {
    "interp": ("interp", "sst_interp_multi", [_P] * 4 + [_I] * 6 + [_P]),
    "sweep": ("sweep", "sst_sweep", [_P] * 4 + [_I] * 7 + [_P]),
    "scan": ("scan", "sst_iir_chain",
             [_P] * 4 + [_I, _I, ctypes.c_float, _P] + [_I] * 4 + [_P]),
    "dft": ("dft", "sst_dft", [_P] * 6 + [_I] * 4 + [_P]),
    "decay": ("decay", "sst_decay_chain",
              [_P] * 6 + [_I, _I, _P] + [_I] * 4 + [_P]),
    "top3": ("top3", "sst_top3", [_P] * 3 + [_I] * 2 + [_P]),
    "peaks": ("peaks", "sst_peaks_map", [_P] * 6 + [_I] * 4 + [_P, _I, _P]),
    "peaks_timed": ("peaks", "sst_peaks_map_timed",
                    [_P] * 6 + [_I] * 4 + [_P, _I, _P, _P]),
    "peaks_runs": ("peaks", "sst_peaks_runs", [_P] * 5 + [_I] * 3 + [_P]),
    "peaks_runs_timed": ("peaks", "sst_peaks_runs_timed",
                         [_P] * 5 + [_I] * 3 + [_P, _P]),
    "peaks_out": ("peaks", "sst_peaks_out", [_P] * 7 + [_I] * 4 + [_P] * 2),
    "peaks_out_timed": ("peaks", "sst_peaks_out_timed",
                        [_P] * 7 + [_I] * 4 + [_P] * 3),
    "peaks_occupancy": ("peaks", "sst_peaks_split_occupancy", [_I, _P]),
    "block_sweep": ("block_sweep", "sst_block_sweep", [_P] * 10 + [_I] * 5
                    + [_P]),
    "block_sweep_timed": ("block_sweep", "sst_block_sweep_timed",
                          [_P] * 10 + [_I] * 5 + [_P, _P]),
    "block_sweep_floor": ("block_sweep", "sst_block_sweep_floor",
                          [_P] * 5 + [_I] * 2 + [_P] * 3),
    "draws": ("draws", "sst_draws_factors", [_P] * 6 + [_I] * 3 + [_P]),
    # key words unsigned (a seed of 2**31 or more), bounds as float32
    "draws_block": ("draws", "sst_draws_block", [ctypes.c_uint32] * 2
                    + [ctypes.c_float] * 2 + [_P, _I, _P]),
    "coefficients": ("coefficients", "sst_coefficients",
                     [_P] * 8 + [_I] * 6 + [_P]),
    "idft": ("idft", "sst_idft", [_P] * 6 + [_I] * 4 + [_P]),
    "ola": ("ola", "sst_ola", [_P] * 8 + [_I] * 16 + [ctypes.c_float, _P]),
}
SOURCES = tuple(dict.fromkeys(source for source, _, _ in ENTRY.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_entries: dict = {}
builds = 0            # sources compiled by nvcc (utils/profiling's guard)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str):
    """The source and its library, named by a hash of the source, the
    headers of csrc/ it may include, and the flags."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{key.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named kernel source that is not built yet, one nvcc
    process per source, all started together.  Returns {name: (seconds,
    ptxas report)} for the sources compiled by this call."""
    global builds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, so, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, so, t0) in running.items():   # wait for every one
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
        builds += 1
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def entry(name: str):
    """The C entry point `name` of ENTRY, built and loaded on first use."""
    if name not in _entries:
        source, symbol, argtypes = ENTRY[name]
        build([source])
        fn = getattr(ctypes.CDLL(str(_target(source)[1])), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require_cuda(*tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, got "
                             f"{t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
