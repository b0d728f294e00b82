"""Profiling utilities: program spans, timing on the card, stage
breakdowns, SVG reports.

The port of signalsmith_stretch_tpu/utils/profiling.py.  The reference's
dev harness wraps each processing step in stopwatches and renders an SVG
(cmd/main-dev.cpp:165-208).  Here:

  - `span()`: a named program span on the profiler's clock, recorded only
    while torch.profiler records (the `sst.*` spans of the hot paths);
  - `sync()`: wait for the card (torch.cuda.synchronize on the device of a
    tensor, or of the device given); nothing on the CPU;
  - `timed()`: best-of-reps time of a call, between CUDA events on the card
    (after a synchronise), on the host's clock on the CPU;
  - `stage_breakdown()`: analysis, plan, sweep, synthesis and the full
    render of a StretchModel, each stage timed alone;
  - `write_svg_bars()`: a dependency-free SVG bar chart (profile.svg);
  - `trace()`: torch.profiler around a block, its Chrome trace written out
    (the `sst.*` spans among the CPU operations);
  - `AllocationGuard`: the reference's "no allocation on the audio path"
    (cmd/main-dev.cpp:160) for a call repeated on the same inputs.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch

try:
    from torch._C._autograd import _profiler_enabled
    from torch._C._profiler import _RecordFunctionFast
except ImportError:           # a PyTorch without them: spans are off
    _profiler_enabled = _RecordFunctionFast = None

_OFF = contextlib.nullcontext()


def span(name: str):
    """A program span: `with span("sst.stream.block"): ...`.

    While torch.profiler records, the block is one CPU operation event
    named `name`, nested under the span that encloses it on the calling
    thread; otherwise nothing is recorded and the cost is this call and
    one check.  Every span of the port is named `sst.<layer>.<phase>`,
    and a count of spans by name in a traced window is the counter at
    that boundary (`sst.stream.block`: blocks run).  A span is not a
    user annotation, so the profiler puts no mirror of it on the device's
    timeline.  Where this PyTorch lacks the fast record function, a span
    records nothing."""
    if _RecordFunctionFast is not None and _profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


def _device_of(value) -> Optional[torch.device]:
    """The device of a tensor, or of the first tensor in a tuple or list."""
    if isinstance(value, torch.Tensor):
        return value.device
    if isinstance(value, (tuple, list)):
        for v in value:
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


def sync(value=None, device=None) -> None:
    """Wait until the card has finished the work queued before: on the
    device of `value` (a tensor, or a tuple or list holding one), or on
    `device`.  Nothing to wait for on the CPU."""
    dev = torch.device(device) if device is not None else _device_of(value)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, reps: int = 3, warmup: int = 1,
          device=None) -> float:
    """Best-of-reps seconds of fn(*args).  On the card (the device given,
    else that of fn's first result) each call runs alone between two CUDA
    events after a synchronise; on the CPU, the host's clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = torch.device(device) if device is not None else _device_of(out)
    sync(device=dev)
    best = float("inf")
    for _ in range(reps):
        if dev is not None and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            sync(out)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best


def write_svg_bars(path: str, values: Dict[str, float], unit: str = "ms",
                   title: str = "stage timing"):
    """Minimal SVG horizontal bar chart (the profile.svg analogue)."""
    width, row, pad = 640, 26, 140
    items = list(values.items())
    height = row * len(items) + 50
    vmax = max(values.values()) or 1.0
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="12">',
        f'<text x="8" y="18" font-size="14">{title}</text>',
    ]
    for i, (name, v) in enumerate(items):
        y = 36 + i * row
        w = int((width - pad - 80) * v / vmax)
        parts.append(f'<text x="8" y="{y + 13}">{name[:20]}</text>')
        parts.append(f'<rect x="{pad}" y="{y}" width="{max(w, 1)}" '
                     f'height="{row - 8}" fill="#4a90d9"/>')
        parts.append(f'<text x="{pad + w + 6}" y="{y + 13}">'
                     f'{v:.2f} {unit}</text>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def stage_fns(model, clips: torch.Tensor, seeds=None) -> Dict[str, Callable]:
    """The exact() pipeline of a StretchModel on clips [batch, ch, in] as
    closures, one a stage: analysis (engine.analyze_stage), plan
    (planner.plan_spectral), sweep (wavefront.sweep), synthesis
    (engine.synthesis_stage) and the full render.  The port runs its
    stages eagerly, so each stage closure runs that stage alone on the
    previous stage's outputs, computed once here; the JAX package instead
    times cumulative jitted prefixes, because XLA fuses across stages."""
    from .. import engine, planner, wavefront

    plan, controls, flags = model.plan, model.controls, model.flags
    longv = plan.consts.long_vertical_step
    spectra, prev = engine.analyze_stage(clips, plan)
    inputs = planner.plan_spectral(spectra, prev, plan.arrays, controls,
                                   flags, plan.consts, seeds=seeds)
    out_specs = wavefront.sweep(inputs, longv)
    return {
        "analysis": lambda: engine.analyze_stage(clips, plan),
        "plan": lambda: planner.plan_spectral(spectra, prev, plan.arrays,
                                              controls, flags, plan.consts,
                                              seeds=seeds),
        "sweep": lambda: wavefront.sweep(inputs, longv),
        "synthesis": lambda: engine.synthesis_stage(out_specs, plan,
                                                    audio=clips),
        "full": lambda: model.batched(clips, seeds),
    }


def stage_breakdown(model, clips: torch.Tensor, seeds=None,
                    reps: int = 3) -> Dict[str, float]:
    """Seconds of each stage of one render of clips by model, each stage
    timed alone between two synchronises (stage_fns), and of the full
    render: {analysis, plan, sweep, synthesis, full}.  The stages' sum may
    differ from the full render by the host time between stages."""
    dev = clips.device
    return {name: timed(fn, reps=reps, device=dev)
            for name, fn in stage_fns(model, clips, seeds).items()}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around the block, the card's activity too where there
    is one; the Chrome trace goes to <log_dir>/trace.json (chrome://tracing
    or Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class AllocationGuard:
    """The reference's "no allocation on the audio path" (cmd/main-dev.cpp:
    160): wraps fn, and `check()` asserts that the calls after the first
    allocated and built nothing: no new device memory from the driver
    (torch.cuda.memory_stats()["num_device_alloc"], the caching
    allocator's cudaMalloc calls; on the card only), no kernel source
    compiled (ops/_build) and no plan built (engine.build_exact_plan).
    The device count cannot tell the path's own allocation from an
    output the caller keeps alive into the next call, so the caller
    drops each output first (cli_dev does)."""

    def __init__(self, fn: Callable, device="cuda"):
        self._fn = fn
        self.device = torch.device(device)
        self.calls = 0
        self._after_first = None

    def counts(self) -> Dict[str, int]:
        from .. import engine
        from ..ops import _build
        out = {"kernel builds": _build.builds,
               "plans built": engine.plans_built}
        if self.device.type == "cuda":
            sync(device=self.device)
            out["device allocations"] = torch.cuda.memory_stats(
                self.device).get("num_device_alloc", 0)
        return out

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self.calls += 1
        if self.calls == 1:
            self._after_first = self.counts()
        return out

    def check(self) -> Dict[str, int]:
        """Raise RuntimeError if anything counted grew after the first
        call; returns the counts."""
        if self._after_first is None:
            raise RuntimeError("AllocationGuard: no call to check")
        now = self.counts()
        grew = {k: now[k] - v for k, v in self._after_first.items()
                if now[k] != v}
        if grew:
            raise RuntimeError(
                f"the audio path allocated or built after its first call "
                f"({self.calls} calls): "
                + ", ".join(f"{k} +{v}" for k, v in grew.items()))
        return now
