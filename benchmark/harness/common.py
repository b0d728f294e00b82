"""Loading BENCHMARK.json and the files it names, by name; the result line;
the statistics the end-to-end metrics use."""
from __future__ import annotations

import importlib.util
import json
import os
import re
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")
# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "signalsmith_stretch_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(workload: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "limits", f"{workload}.json"))


def metrics_for(bench: dict, workload: str, kind: str) -> list:
    """The cell's end_to_end or per_layer metrics: those that list it under
    `workloads`, and those without the key that move (or, end to end, are)
    a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load(kind: str, name: str):
    """benchmark/<kind>/<name>.py, loaded by its path (once a process)."""
    key = "benchmark_" + re.sub(r"\W", "_", f"{kind}_{name}")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(BENCH_DIR, kind, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod


def loop(name: str):
    """The traffic mix's loop, benchmark/loops/<name>.py: its class Loop,
    built as Loop(config, traffic, seed, device)."""
    return load("loops", name).Loop


def reader(name: str):
    """The per-layer metric's reader, benchmark/metrics/<name>.py: its
    read(record) -> a number, or None where it finds nothing to read."""
    return load("metrics", name).read


def patcher():
    """(patch, undo): a setattr that records what it replaced (for a
    loop's FAULTS outside pytest), and the function that puts it back."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo():
        while saved:
            owner, name, value = saved.pop()
            setattr(owner, name, value)

    return patch, undo


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) of all values, linear between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values) -> float:
    """Interquartile distance as a share of the median (Python's
    statistics.quantiles, exclusive method)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def forbidden_loaded() -> list:
    """The forbidden top-level names in sys.modules (compared whole)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def power_limit() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
