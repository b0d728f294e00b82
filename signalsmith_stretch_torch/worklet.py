"""Cross-thread node host: the AudioWorklet MessagePort RPC analogue (the
port of signalsmith_stretch_tpu/worklet.py).

The reference splits its real-time wrapper across two threads: the engine
lives on the audio-render thread, and the main thread drives it through a
MessagePort RPC (web-wrapper.js:159-176 remoteMethods, :381-415 node facade)
with transferable buffers.  This module is the same topology in Python:

  - `WorkletHost` owns a `scheduler.StretchNode` on a dedicated render
    thread that pre-renders quanta into a bounded ring (the audio-callback
    consumer pulls from it with `read()` — never blocked by control work);
  - control methods (configure/schedule/start/stop/add_buffers/...) are
    marshalled to the render thread through a command queue and applied
    between quanta, exactly like postMessage'd RPC landing between
    process() calls;
  - the host starts suspended (AudioContext semantics): wire everything up,
    then `resume()` releases the render thread, so output quantum 0 is the
    schedule's output time 0;
  - `time` feedback flows back the other way (web-wrapper.js:104-105): the
    node's update callback posts [input_time] events onto a feedback queue
    drained by `poll_time()`.

Same-thread users should keep using `scheduler.StretchNode` directly; this
wrapper exists for hosts with a real-time consumer thread (sound-card
callback, network push) that must never run Python control code.

The node renders on its `device` ("cuda" by default), and the render thread
makes that card its current device.  Every wait is bounded: `read` takes a
timeout, the ring's put retries every 0.05 s until close(), a control call
waits at most 10 s, and close() joins for at most 5 s.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from .scheduler import StretchNode


class WorkletHost:
    def __init__(self, sample_rate: int, channels: int = 2,
                 quantum: int = 128, preset: str = "default",
                 buffer_quanta: int = 8, seed: int = 0,
                 batch_quanta: int = 1, device="cuda"):
        """batch_quanta > 1 renders that many quanta at a time on the render
        thread (scheduler.process_quanta: one copy to the card and one back
        for a run of quanta); the ring still hands out single quanta.  Size
        buffer_quanta >= batch_quanta so a full batch fits the ring.
        `device` goes to the node (scheduler.StretchNode)."""
        self._node = StretchNode(sample_rate, channels=channels,
                                 quantum=quantum, preset=preset, seed=seed,
                                 device=device)
        dev = self._node.device
        # the card the node's tensors go to, as the constructing thread
        # resolves "cuda"
        self._card = None if dev.type != "cuda" else (
            dev.index if dev.index is not None else torch.cuda.current_device())
        self.channels = channels
        self.quantum = quantum
        self.batch_quanta = max(1, int(batch_quanta))
        self._cmds: "queue.Queue[tuple]" = queue.Queue()
        self._ring: "queue.Queue[np.ndarray]" = queue.Queue(
            maxsize=buffer_quanta)
        self._times: "queue.Queue[float]" = queue.Queue()
        self._stop = threading.Event()
        self._running = threading.Event()
        self._node.set_update_interval(
            0.05, lambda t: self._times.put_nowait(t))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- render thread -----------------------------------------------------
    def _run(self):
        if self._card is not None:
            torch.cuda.set_device(self._card)
        while not self._stop.is_set():
            if not self._running.wait(timeout=0.05):
                # suspended: still drain control messages (wiring happens
                # before resume(), like an un-resumed AudioContext)
                self._drain_cmds()
                continue
            self._drain_cmds()
            if self.batch_quanta > 1:
                out = self._node.process_quanta(self.batch_quanta)
                quanta = [out[:, i * self.quantum:(i + 1) * self.quantum]
                          for i in range(self.batch_quanta)]
            else:
                quanta = [self._node.process_quantum()]
            for out in quanta:
                while not self._stop.is_set():
                    try:
                        self._ring.put(out, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    break

    def _drain_cmds(self):
        # apply queued control messages between quanta (the RPC landing
        # between process() calls)
        while True:
            try:
                name, args, kwargs, done = self._cmds.get_nowait()
            except queue.Empty:
                break
            try:
                getattr(self._node, name)(*args, **kwargs)
            finally:
                if done is not None:
                    done.set()

    # ---- consumer side (audio callback) -------------------------------------
    def read(self, n_quanta: int = 1, timeout: float = 5.0) -> np.ndarray:
        """Pull rendered quanta (blocks until available)."""
        outs: List[np.ndarray] = [self._ring.get(timeout=timeout)
                                  for _ in range(n_quanta)]
        return np.concatenate(outs, axis=1)

    def poll_time(self) -> Optional[float]:
        """Latest input-time feedback event, or None (['time', t] posts)."""
        t = None
        while True:
            try:
                t = self._times.get_nowait()
            except queue.Empty:
                return t

    # ---- control side (main thread) -----------------------------------------
    def _call(self, name, *args, wait: bool = False, **kwargs):
        done = threading.Event() if wait else None
        self._cmds.put((name, args, kwargs, done))
        if done is not None:
            done.wait(timeout=10.0)

    def resume(self):
        """Release the render thread (AudioContext.resume())."""
        self._running.set()

    def suspend(self):
        self._running.clear()

    def configure(self, **kwargs):
        self._call("configure", wait=True, **kwargs)

    def add_buffers(self, audio: np.ndarray):
        self._call("add_buffers", np.asarray(audio, np.float32), wait=True)

    def drop_buffers(self):
        self._call("drop_buffers", wait=True)

    def schedule(self, **kwargs):
        self._call("schedule", **kwargs)

    def start(self, **kwargs):
        self._call("start", **kwargs)

    def stop(self):
        self._call("stop")

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        assert not self._thread.is_alive()
