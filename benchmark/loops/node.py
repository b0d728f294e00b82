"""The paced node: one StretchNode in buffer playback, asked for one
128-sample quantum at a time on the audio clock.

Set-up builds the node (preset "default", the configuration's channels
and rate), gives it a long buffer made from the seed, starts one segment
at the configuration's node rate, pitch and tonality limit, and renders
the first `warm_quanta` quanta (the kernels build or load; the start
check compares the first `start_check_quanta` of them).  In the window,
quantum k is due `k * quantum / rate` seconds after the window starts: the loop waits for it (spinning on
the clock: a sleep on that machine overshot by up to 10 ms) and calls process_quantum(); a
quantum's latency runs from its due time to its return, so the wait that
a late quantum imposes on the next counts in the next's latency.  The
node re-seeks every quantum, as web-wrapper.js does, and runs a block
about every interval / quantum quanta.

For the check, the program's stream state is copied, into device
storage made before the window, before and after each quantum of
`check_runs` runs of `check_run_quanta` consecutive quanta drawn from the
seed; during the warm-up the states themselves (tuples of tensors that
the engine replaces, never edits) are held around its first
`start_check_quanta` quanta.  The reference steps each of those quanta
from the program's state before it (the node's very first quantum from
the reference's own initial state)."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from benchmark.harness import check, clips, trace


CARRY = ("input", "prev_input", "output", "pred_energy")
BUFFERS = ("in_hist", "out_tail", "weight_tail")
SCALARS = ("samples_since_last", "prev_input_offset", "did_seek",
           "seek_time_factor", "silence_counter", "silence_first")
GAIN = 1 + 2 ** -7


# faults a cell of this loop can have, planted in the program underneath
# the timed path; each takes patch(owner, name, value) (pytest's
# monkeypatch.setattr, or common.patcher()'s)
def state_unchanged(patch):
    """A stream block that returns its carry unchanged."""
    from signalsmith_stretch_torch import spectral
    real = spectral.process_block

    def block(carry, *a, **k):
        _, out = real(carry, *a, **k)
        return carry, out

    patch(spectral, "process_block", block)


def quantum_altered(patch):
    """Each quantum scaled by 1 + 2^-7 where the stream produces it."""
    from signalsmith_stretch_torch.streaming import StreamingStretch
    real = StreamingStretch._process
    patch(StreamingStretch, "_process",
          lambda self, *a: real(self, *a) * GAIN)


FAULTS = (state_unchanged, quantum_altered)


def _blank(st):
    """Device storage shaped as a stream state's tensors, made before the
    window: copying a state into it during the window allocates nothing
    (holding the program's own tensors would make the caching allocator
    grow, and call cudaMalloc, inside the window)."""
    return SimpleNamespace(
        carry=SimpleNamespace(**{k: getattr(st.carry, k).clone()
                                 for k in CARRY}),
        **{k: getattr(st, k).clone() for k in BUFFERS},
        **{k: getattr(st, k) for k in SCALARS})


def _copy_into(snap, st):
    for k in CARRY:
        getattr(snap.carry, k).copy_(getattr(st.carry, k))
    for k in BUFFERS:
        getattr(snap, k).copy_(getattr(st, k))
    for k in SCALARS:
        setattr(snap, k, getattr(st, k))


def _state_arrays(st) -> dict:
    """The fields of a stream state that the reference also carries."""
    c = st.carry
    out = {k: getattr(c, k).detach().cpu().numpy()
           for k in ("input", "prev_input", "output", "pred_energy")}
    for k in ("in_hist", "out_tail", "weight_tail"):
        out[k] = getattr(st, k).detach().cpu().numpy()
    for k in ("samples_since_last", "prev_input_offset", "did_seek",
              "silence_counter", "silence_first"):
        out[k] = getattr(st, k)
    out["seek_time_factor"] = np.float32(st.seek_time_factor)
    return out


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda"):
        from signalsmith_stretch_torch.scheduler import StretchNode
        self.cfg, self.traffic, self.device = cfg, traffic, device
        sr, ch = cfg["sample_rate"], cfg["channels"]
        self.rate, self.quantum = sr, traffic["quantum"]
        ss = np.random.SeedSequence(seed % 2 ** 64)
        s_bank, s_buf, self.s_check = ss.spawn(3)
        bank = clips.kind_bank(sr, traffic["bank_seconds"],
                               int(s_bank.generate_state(1)[0]))
        self.buffer = clips.tiles(bank, np.random.default_rng(s_buf),
                                  traffic["buffer_seconds"],
                                  traffic["tile_seconds"], ch, sr,
                                  traffic["silent_every"])
        self.level = float(np.sqrt(np.mean(
            self.buffer.astype(np.float64) ** 2)))
        self.node = StretchNode(sr, ch, self.quantum, preset="default",
                                device=device)
        self.node.add_buffers(self.buffer)
        self.node.start(input=0.0, rate=cfg["node_rate"], **cfg["controls"])
        # the warm-up; the states around its first start_check_quanta
        # quanta are held for the start check (the engine is made by the
        # first quantum, so the first starts from the initial state)
        n_start = traffic["start_check_quanta"]
        self.start_out, self.start_before, self.start_after = [], {}, {}
        self.engine = None
        for j in range(traffic["warm_quanta"]):
            if 0 < j < n_start:
                self.start_before[j] = self.engine.state
            out = self.node.process_quantum()
            if self.engine is None:
                engines = list(self.node._engine_cache.values())
                if len(engines) != 1:
                    raise RuntimeError(f"expected one stream engine, found "
                                       f"{len(engines)}")
                self.engine = engines[0]
            if j < n_start:
                self.start_out.append(out)
                self.start_after[j] = self.engine.state
        self.done = traffic["warm_quanta"]     # quanta rendered before the window

    def _runs(self, n: int, rng: np.random.Generator) -> dict:
        """{window index: (snapshot before, snapshot after, first of its
        run)}: the check's runs, drawn apart from each other inside the
        first n quanta; a run of L quanta takes L + 1 snapshots."""
        L, runs = self.traffic["check_run_quanta"], self.traffic["check_runs"]
        runs = min(runs, max(1, n // L))
        starts = sorted(int(s) * L for s in
                        rng.choice(n // L, runs, replace=False))
        return {s + j: (r * (L + 1) + j, r * (L + 1) + j + 1, j == 0)
                for r, s in enumerate(starts) for j in range(L)}

    def window(self, seconds: float, profile: bool = False) -> dict:
        """The paced loop over the quanta due in `seconds`; with profile,
        under torch.profiler, each quantum in a record_function span."""
        import contextlib
        torch_ctx = contextlib.nullcontext()
        span = None
        if profile:
            from torch.profiler import (ProfilerActivity, profile as prof_,
                                        record_function)
            torch_ctx = prof_(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
            span = record_function
        period = self.quantum / self.rate
        n = int(seconds / period)
        rng = np.random.default_rng(self.s_check)
        sampled = self._runs(n, rng)
        self.check_rng = rng
        lat = np.empty(n)
        blocks = np.zeros(n, np.int64)
        pacer = []
        eng, node = self.engine, self.node
        snaps = [_blank(eng.state) for _ in range(
            max((a for _, a, _ in sampled.values()), default=-1) + 1)]
        self.before = {k: snaps[b] for k, (b, _, _) in sampled.items()}
        self.after = {k: snaps[a] for k, (_, a, _) in sampled.items()}
        self.outs = {}
        clock = time.perf_counter
        with torch_ctx as prof:
            t_start = clock() + 0.002
            for k in range(n):
                due = t_start + k * period
                now = clock()
                if now < due:
                    while clock() < due:
                        pass
                    pacer.append(clock() - due)
                take = sampled.get(k)
                if take is not None and take[2]:
                    _copy_into(snaps[take[0]], eng.state)
                b0 = eng.blocks
                if span is not None:
                    with span("quantum"):
                        out = node.process_quantum()
                else:
                    out = node.process_quantum()
                lat[k] = clock() - due
                blocks[k] = eng.blocks - b0
                if take is not None:
                    _copy_into(snaps[take[1]], eng.state)
                    self.outs[k] = out
            wall = clock() - t_start
        self.window_start = self.done
        self.done += n
        w = dict(latencies=lat, blocks=blocks, pacer=np.array(pacer),
                 attempted=n, failed=0, wall=wall, period=period)
        if profile:
            host, device = trace.events(prof, ("quantum",))
            spans = trace.spans(host, "quantum")
            w.update(host=host, device=device, spans=spans, window_s=wall)
        return w

    def end_to_end(self, w: dict) -> dict:
        """The latency's tails over all quanta (the runner reports those
        the cell lists)."""
        from benchmark.harness.common import quantile
        lat = w["latencies"]
        return {"quantum_p50_ms": 1e3 * quantile(lat, 0.5),
                "quantum_p99_ms": 1e3 * quantile(lat, 0.99)}

    def notes(self, w: dict) -> str:
        """The late share and how late the pacer ran (an earlier line)."""
        deadline = w["period"]
        late = float(np.mean(w["latencies"] > deadline))
        p = w["pacer"]
        pacer = (f"pacer late median {1e3 * np.median(p):.4f} ms, max "
                 f"{1e3 * p.max():.4f} ms over {len(p)} waits"
                 if len(p) else "pacer never waited")
        lat = w["latencies"]
        return (f"quanta {w['attempted']}, blocks {int(w['blocks'].sum())}, "
                f"late (over {1e3 * deadline:.3f} ms) {100 * late:.3f}%, "
                f"p50 {1e3 * np.quantile(lat, 0.5):.4f} ms, p95 "
                f"{1e3 * np.quantile(lat, 0.95):.4f} ms, over 20 ms "
                f"{int((lat > 0.02).sum())}, max {1e3 * lat.max():.3f} ms; "
                f"{pacer}")

    def traced(self) -> dict:
        return self.window(self.traffic["trace_seconds"], profile=True)

    def free(self):
        """The node's state stays: the check reads the held states."""

    # ---- the check --------------------------------------------------------
    def _history(self, j: int) -> np.ndarray:
        """Quantum j's history window, worked out as web-wrapper.js does:
        the output clock after j quanta (summed quantum by quantum, as the
        node sums it), plus the output latency, through the segment's
        rate."""
        cfg = self._ref_cfg
        sr = self.rate
        t = 0.0
        for _ in range(j):
            t += self.quantum / sr
        t = t + cfg.output_latency / sr
        in_t = 0.0 + (t - 0.0) * self.cfg["node_rate"]
        end = int(round(in_t * sr))
        buf_len = cfg.input_latency + cfg.output_latency
        out = np.zeros((self.cfg["channels"], buf_len), np.float32)
        a, b = max(0, end - buf_len), min(self.buffer.shape[1], end)
        if b > a:
            out[:, a - (end - buf_len):b - (end - buf_len)] = \
                self.buffer[:, a:b]
        return out

    def _ref(self):
        import torch
        from benchmark.reference import spectral, stream
        from benchmark.reference.geometry import StretchConfig
        cfg = self.cfg
        self._ref_cfg = StretchConfig.preset_default(cfg["channels"],
                                                     cfg["sample_rate"])
        ctl = spectral.Controls.of(cfg["sample_rate"], **cfg["controls"])
        consts = spectral.SpectralConsts.for_config(self._ref_cfg)
        return torch, stream, spectral, ctl, consts

    def _step(self, st, j: int, q):
        torch, stream, spectral, ctl, consts = self._refs
        st = stream.seek(st, self._ref_cfg, self._history(j),
                         self.cfg["node_rate"])
        st, out = stream.process(st, self._ref_cfg,
                                 np.zeros((self.cfg["channels"], 0),
                                          np.float32),
                                 self.quantum, ctl, consts, q)
        return st, out.numpy()

    def _to_ref(self, st):
        """The program's state before a quantum, as the reference's."""
        torch, stream, spectral, _, _ = self._refs

        def t(x):
            return x.detach().cpu().clone()

        c = st.carry
        return stream.StreamState(
            spectral.Carry(t(c.input), t(c.prev_input), t(c.output),
                           t(c.pred_energy)),
            t(st.in_hist), t(st.out_tail), t(st.weight_tail),
            int(st.samples_since_last), int(st.prev_input_offset),
            bool(st.did_seek), np.float32(st.seek_time_factor),
            int(st.silence_counter), bool(st.silence_first))

    def numbers(self, control: bool = False) -> dict:
        """The compared numbers; with control=True the reference in
        bfloat16 stands in the program's place."""
        self._refs = self._ref()
        torch, stream, spectral, _, _ = self._refs
        q = spectral.round_bf16 if control else spectral.identity
        with torch.no_grad():
            start_gap = quantum_gap = 0.0
            pairs = []
            steps = [(j, self.start_before.get(j), self.start_out[j],
                      self.start_after[j], True)
                     for j in range(len(self.start_out))]
            steps += [(self.window_start + k, self.before[k], self.outs[k],
                       self.after[k], False) for k in sorted(self.before)]
            for j, before, out, after, start in steps:
                # the first quantum from the reference's own initial
                # state, every other from the program's state before it
                st0 = (stream.initial_state(self._ref_cfg) if before is None
                       else self._to_ref(before))
                st1, ref = self._step(st0, j, spectral.identity)
                if control:
                    stc, prog = self._step(st0, j, q)
                    prog_state = _state_arrays(stc)
                else:
                    prog, prog_state = out, _state_arrays(after)
                gap = check.rel_gap(prog, ref, self.level)
                if start:
                    start_gap = max(start_gap, gap)
                else:
                    quantum_gap = max(quantum_gap, gap)
                pairs.append((prog_state, _state_arrays(st1)))
        fields = check.state_gaps(pairs)
        # the fields' own maxima go with the numbers (unlimited, for the
        # readings)
        out = {"start_gap": start_gap, "quantum_gap": quantum_gap,
               "state_gap": max(fields.values(), default=0.0)}
        out.update({f"_state.{k}": g for k, g in fields.items()})
        return out
