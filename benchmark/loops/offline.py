"""The offline loop: one caller renders batches of clips through
StretchModel.batched, numpy in and numpy out, in a closed loop.

Set-up builds the model, makes a pool of distinct batches from the seed
and renders each of the first `warm_requests` once (the kernels build or
load, the caches fill).  The window then renders pool entries in turn
until `seconds` have passed; the last request runs to its end and the
window ends with it.  After the window, the program's state is freed and
the check renders a sample of one request's clips with the plain
reference (check.chaos_gap)."""
from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.harness import check, clips, roofline, trace

STAGES = ("analysis", "plan", "sweep", "synthesis")


# faults a cell of this loop can have, planted in the program underneath
# the timed path; each takes patch(owner, name, value) (pytest's
# monkeypatch.setattr, or common.patcher()'s)
def half_batch_left_out(patch):
    """The second half of each batch's answers zeroed."""
    from signalsmith_stretch_torch.models.stretch import StretchModel
    real = StretchModel.batched

    def batched(self, audio, seeds=None, plain=False):
        out = real(self, audio, seeds, plain)
        out[out.shape[0] // 2:] = 0
        return out

    patch(StretchModel, "batched", batched)


def render_altered(patch):
    """Each clip's answer is its neighbour's, where the render is made (a
    gain error below the float32 drift of a chaotic render would be no
    wrong answer: check.py)."""
    import torch
    from signalsmith_stretch_torch import engine
    real = engine.synthesis_stage
    patch(engine, "synthesis_stage",
          lambda *a, **k: torch.roll(real(*a, **k), 1, 0))


FAULTS = (half_batch_left_out, render_altered)


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda"):
        import torch
        from signalsmith_stretch_torch.models.stretch import StretchModel
        self.torch = torch
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        sr, ch = cfg["sample_rate"], cfg["channels"]
        self.rate = sr
        self.n_in = int(round(traffic["clip_seconds"] * sr))
        self.n_out = int(round(self.n_in * cfg["time_factor"]))
        self.model = StretchModel.build(ch, sr, self.n_in, self.n_out,
                                        device=device, **cfg["controls"])
        ss = np.random.SeedSequence(seed % 2 ** 64)
        s_bank, s_pool, self.s_check = ss.spawn(3)
        bank = clips.kind_bank(sr, traffic["clip_seconds"],
                               int(s_bank.generate_state(1)[0]))
        rng = np.random.default_rng(s_pool)
        self.pool = [clips.batch(bank, rng, traffic["batch"], self.n_in, ch,
                                 sr, traffic["silent_every"])
                     for _ in range(traffic["pool"])]
        self.kept = {}
        for i in range(traffic["warm_requests"]):
            self.request(i % len(self.pool))

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def request(self, p: int) -> np.ndarray:
        """One request: the pool's batch p in, its render back in host
        memory (kept as the pool entry's latest answer)."""
        out = self.model.batched(self.pool[p]).cpu().numpy()
        self.kept[p] = out
        return out

    def window(self, seconds: float) -> dict:
        lat, failed, i = [], 0, 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            t0 = time.perf_counter()
            try:
                self.request(i % len(self.pool))
            except RuntimeError:
                failed += 1
            lat.append(time.perf_counter() - t0)
            i += 1
        wall = time.perf_counter() - t_start
        return dict(latencies=lat, attempted=i, failed=failed, wall=wall)

    def end_to_end(self, w: dict) -> dict:
        from benchmark.harness.common import quantile
        audio_s = (w["attempted"] - w["failed"]) * self.traffic["batch"] \
            * self.traffic["clip_seconds"]
        return {"render_rtf": audio_s / w["wall"],
                "render_p95_ms": 1e3 * quantile(w["latencies"], 0.95)}

    def notes(self, w: dict) -> str:
        lat = sorted(w["latencies"])
        return (f"requests {w['attempted']} ({w['failed']} failed) in "
                f"{w['wall']:.3f} s; latency median "
                f"{1e3 * lat[len(lat) // 2]:.3f} ms, max {1e3 * lat[-1]:.3f}"
                f" ms")

    def traced(self) -> dict:
        """The per-layer record: `trace_requests` requests under the
        profiler, then each stage alone between synchronises (timed
        untraced over `stage_reps` reps, then once traced for its device
        time)."""
        from torch.profiler import ProfilerActivity, profile, record_function
        n = self.traffic["trace_requests"]
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                with record_function("request"):
                    self.request(i % len(self.pool))
            wall = time.perf_counter() - t0
        host, device = trace.events(prof, ("request",))
        del prof
        spans = trace.spans(host, "request")
        rec = dict(host=host, device=device, spans=spans, window_s=wall)
        rec.update(self.stages())
        return rec

    def stages(self) -> dict:
        """Each stage alone on the previous stage's outputs (the pattern
        of the port's utils/profiling.stage_fns): host ms between
        synchronises over the reps, device busy ns of one traced rep,
        and the byte bound of its arguments and result."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from signalsmith_stretch_torch import engine, planner, wavefront
        m = self.model
        plan, controls, flags = m.plan, m.controls, m.flags
        longv = plan.consts.long_vertical_step
        audio = torch.as_tensor(self.pool[0], device=self.device)
        spectra, prev = engine.analyze_stage(audio, plan)
        inputs = planner.plan_spectral(spectra, prev, plan.arrays, controls,
                                       flags, plan.consts)
        out_specs = wavefront.sweep(inputs, longv)
        calls = {
            "analysis": ((audio,), lambda: engine.analyze_stage(audio, plan)),
            "plan": ((spectra, prev), lambda: planner.plan_spectral(
                spectra, prev, plan.arrays, controls, flags, plan.consts)),
            "sweep": ((inputs,), lambda: wavefront.sweep(inputs, longv)),
            "synthesis": ((out_specs, audio), lambda: engine.synthesis_stage(
                out_specs, plan, audio=audio)),
        }
        ms, dev_ns, bound = {}, {}, {}
        for name in STAGES:
            args, fn = calls[name]
            reps = []
            for _ in range(self.traffic["stage_reps"]):
                self.sync()
                t0 = time.perf_counter()
                out = fn()
                self.sync()
                reps.append(1e3 * (time.perf_counter() - t0))
            ms[name] = reps
            bound[name] = roofline.stage_bound_ms(args, out)
            del out
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                self.sync()
            _, device = trace.events(prof)
            dev_ns[name] = trace.union_ns([(s, e) for _, s, e in device])
        return dict(stage_ms=ms, stage_device_ns=dev_ns, stage_bound_ms=bound)

    def free(self):
        """Drop the program's state before the reference runs."""
        self.model = None
        gc.collect()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def sample(self):
        """The compared sample: one kept request drawn from the seed and
        `check_clips` of its clips, half from each half of the batch."""
        rng = np.random.default_rng(self.s_check)
        keys = sorted(self.kept)
        p = keys[int(rng.integers(0, len(keys)))]
        b = self.traffic["batch"]
        k = self.traffic["check_clips"]
        idx = np.sort(np.concatenate([
            rng.choice(b // 2, k // 2, replace=False),
            b // 2 + rng.choice(b - b // 2, k - k // 2, replace=False)]))
        return p, idx, rng

    def reference(self, audio: np.ndarray, q=None) -> np.ndarray:
        """The plain reference's render of audio [n, ch, in] on the
        device, in blocks of `check_block` clips."""
        import torch
        from benchmark.reference import render, spectral
        from benchmark.reference.geometry import StretchConfig
        cfg = self.cfg
        rc = StretchConfig.preset_default(cfg["channels"], cfg["sample_rate"])
        plan = render.build_exact_plan(rc, self.n_in, self.n_out)
        ctl = spectral.Controls.of(cfg["sample_rate"], **cfg["controls"])
        q = q or spectral.identity
        blk = self.traffic["check_block"]
        outs = []
        with torch.no_grad():
            for i in range(0, len(audio), blk):
                x = torch.as_tensor(audio[i:i + blk], device=self.device)
                outs.append(render.render(x, plan, ctl, q).cpu().numpy())
                del x
        return np.concatenate(outs)

    def numbers(self, control: bool = False) -> dict:
        """The compared numbers; with control=True the reference in
        bfloat16 stands in the program's place."""
        from benchmark.reference import spectral
        p, idx, rng = self.sample()
        audio = self.pool[p][idx]
        both = self.reference(np.concatenate([audio, check.probe(audio,
                                                                 rng)]))
        ref, ref_probe = both[:len(idx)], both[len(idx):]
        prog = (self.reference(audio, spectral.round_bf16) if control
                else self.kept[p][idx])
        return {"chaos_gap": check.chaos_gap(prog, ref, ref_probe,
                                             self.rate)}
