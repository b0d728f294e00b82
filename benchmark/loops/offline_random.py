"""The offline loop above 2x: the offline loop (benchmark/loops/offline.py)
with the check's reference made for the randomised regime.

Above 2x each clip's per-bin time factors are drawn from its seed; the
program's default seeds are the clips' indices in the batch, so the check
renders each sampled clip, and its probe, with its index as its seed
(reference/render_random.py).  The traced record also carries the
request's shapes, which harness/roofline_random.py turns into the bounds
of kernel I's draws and kernel A's lookups on the four per-bin sets."""
from __future__ import annotations

import functools

import numpy as np

from benchmark.harness import check, common

offline = common.load("loops", "offline")


def draws_left_out(patch):
    """The per-bin draws left out: tf in every bin, a 3x render without
    the randomisation."""
    import torch
    from signalsmith_stretch_torch import planner

    def factors(tf, seeds, B, flags, device, plain=False):
        t = torch.as_tensor(np.asarray(tf, np.float32), device=device)
        full = t.view(1, -1, 1).expand(len(seeds), len(tf), B)
        return full.contiguous(), full.contiguous()

    patch(planner, "_random_time_factors", factors)


FAULTS = offline.FAULTS + (draws_left_out,)


class Loop(offline.Loop):
    @functools.cached_property
    def _plan(self):
        """The reference's static plan of the cell's render shape."""
        from benchmark.reference import render
        from benchmark.reference.geometry import StretchConfig
        cfg = self.cfg
        rc = StretchConfig.preset_default(cfg["channels"], cfg["sample_rate"])
        return render.build_exact_plan(rc, self.n_in, self.n_out)

    def traced(self) -> dict:
        """The offline loop's traced record, and `shapes`: a request's
        rows R (clips x blocks), bands B, channels, the vote position sets
        and the draws (two a bin of every block above 2x)."""
        from benchmark.reference import draws
        rec = super().traced()
        plan = self._plan
        _, _, drawn = draws.bounds(plan.arrays["time_factor"])
        batch = self.traffic["batch"]
        rec["shapes"] = dict(
            R=batch * len(drawn), B=plan.consts.bands,
            channels=self.cfg["channels"], sets=4,
            draws=2 * batch * int(drawn.sum()) * plan.consts.bands)
        return rec

    def reference(self, audio: np.ndarray, seeds, q=None) -> np.ndarray:
        """The plain reference's render of audio [n, ch, in] above 2x, clip
        i from seeds[i], on the device, in blocks of `check_block` clips."""
        import torch
        from benchmark.reference import render_random, spectral
        cfg = self.cfg
        plan = self._plan
        ctl = spectral.Controls.of(cfg["sample_rate"], **cfg["controls"])
        q = q or spectral.identity
        blk = self.traffic["check_block"]
        outs = []
        with torch.no_grad():
            for i in range(0, len(audio), blk):
                x = torch.as_tensor(audio[i:i + blk], device=self.device)
                outs.append(render_random.render(
                    x, plan, ctl, seeds[i:i + blk], q).cpu().numpy())
                del x
        return np.concatenate(outs)

    def numbers(self, control: bool = False) -> dict:
        """The compared numbers, each sampled clip drawn from its index in
        the batch; with control=True the reference in bfloat16 stands in
        the program's place."""
        from benchmark.reference import spectral
        p, idx, rng = self.sample()
        audio = self.pool[p][idx]
        seeds = [int(i) for i in idx]
        both = self.reference(np.concatenate([audio, check.probe(audio,
                                                                 rng)]),
                              seeds + seeds)
        ref, ref_probe = both[:len(idx)], both[len(idx):]
        prog = (self.reference(audio, seeds, spectral.round_bf16) if control
                else self.kept[p][idx])
        return {"chaos_gap": check.chaos_gap(prog, ref, ref_probe,
                                             self.rate)}
