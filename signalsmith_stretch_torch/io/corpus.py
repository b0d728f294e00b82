"""Corpus pipeline: bucketing, padding and prefetch for batch rendering (the
port of signalsmith_stretch_tpu/io/corpus.py).

A render plan is built per (in_len, out_len, config), so the pipeline:

  1. loads clips (through io/wav.py),
  2. buckets them by (render settings, padded input length),
  3. yields batches already on the device, from a background prefetch
     thread, so that the copy of batch k+1 to the card overlaps the render
     of batch k.  On a card the thread copies each batch from pinned host
     memory on a side CUDA stream and records an event there; the consumer
     side makes its current stream wait on that event before it yields the
     batch, so no batch is handed out while its copy may be in flight.

Multi-process: pass the full (deterministically ordered) item list through
`parallel.distributed.shard_items` before `batches()`, so that each process
loads and pads only its own slice of the corpus.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import device_for
from .wav import read_wav


@dataclasses.dataclass
class CorpusItem:
    audio: np.ndarray          # [ch, n] float32
    sample_rate: int
    name: str = ""
    time_factor: float = 1.0
    semitones: float = 0.0

    @property
    def seconds(self) -> float:
        return self.audio.shape[1] / self.sample_rate

    def stats(self) -> Tuple[float, float, float]:
        """(peak, rms, total_energy)."""
        a = self.audio
        return (float(np.abs(a).max(initial=0.0)),
                float(np.sqrt(np.mean(a ** 2))) if a.size else 0.0,
                float(np.sum(a.astype(np.float64) ** 2)))


def load_directory(paths: Sequence[str], time_factor: float = 1.0,
                   semitones: float = 0.0) -> List[CorpusItem]:
    items = []
    for p in paths:
        audio, rate = read_wav(p)
        items.append(CorpusItem(audio=audio, sample_rate=rate, name=p,
                                time_factor=time_factor, semitones=semitones))
    return items


def _pad_len(n: int, granule: int) -> int:
    return -(-n // granule) * granule


def bucket(items: Sequence[CorpusItem], granule_seconds: float = 1.0
           ) -> Dict[tuple, List[CorpusItem]]:
    """Group by (rate, channels, padded length, time factor, semitones), so
    that each bucket shares one render plan."""
    buckets: Dict[tuple, List[CorpusItem]] = {}
    for it in items:
        granule = int(it.sample_rate * granule_seconds)
        key = (it.sample_rate, it.audio.shape[0],
               _pad_len(it.audio.shape[1], granule),
               round(it.time_factor, 6), round(it.semitones, 6))
        buckets.setdefault(key, []).append(it)
    return buckets


def _work(items, batch_size: int, granule_seconds: float) -> List[dict]:
    work = []
    for key, group in bucket(items, granule_seconds).items():
        pad_n = key[2]
        for i in range(0, len(group), batch_size):
            chunk = group[i:i + batch_size]
            arr = np.zeros((len(chunk), key[1], pad_n), np.float32)
            for j, it in enumerate(chunk):
                arr[j, :, :it.audio.shape[1]] = it.audio
            work.append(dict(key=key, audio=arr,
                             names=[c.name for c in chunk],
                             lengths=[c.audio.shape[1] for c in chunk],
                             time_factor=key[3], semitones=key[4]))
    return work


def batches(items: Sequence[CorpusItem], batch_size: int,
            granule_seconds: float = 1.0, prefetch: int = 2,
            device="cuda") -> Iterator[dict]:
    """Yield padded batches {key, audio [b, ch, n] float32 tensor on
    `device`, names, lengths, time_factor, semitones}.  prefetch > 0 copies
    up to that many batches ahead on a background thread; prefetch <= 0
    copies each batch when it is asked for."""
    dev = device_for(device, "batches")
    if dev.type == "cuda" and dev.index is None:     # the same card on the
        dev = torch.device("cuda", torch.cuda.current_device())   # thread
    work = _work(items, batch_size, granule_seconds)
    if prefetch <= 0:
        for w in work:
            yield dict(w, audio=torch.as_tensor(w["audio"], device=dev))
        return

    q: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    failed: List[BaseException] = []

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def producer():
        try:
            side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            for w in work:
                if stop.is_set():
                    break
                if side is None:
                    put((dict(w, audio=torch.from_numpy(w["audio"])), None))
                    continue
                pinned = torch.from_numpy(w["audio"]).pin_memory()
                with torch.cuda.stream(side):
                    audio = pinned.to(dev, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(side)
                put((dict(w, audio=audio), ready))
        except BaseException as e:        # re-raised on the consumer's side
            failed.append(e)
        finally:
            put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if failed:
                    raise failed[0]
                break
            w, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                # allocated on the side stream, used on this one
                w["audio"].record_stream(stream)
            yield w
    finally:
        stop.set()
        t.join(timeout=5.0)
