"""A frozen copy of signalsmith_stretch_torch/schedule.py, the benchmark's
plain reference (it imports nothing of the port).

Static block scheduling: the reference's per-sample streaming loop, inverted.

The reference engine (signalsmith-stretch.h:209-423) runs a per-output-sample
loop that triggers a block every `interval` samples, maps it to an input
position with float32 arithmetic, and overlap-adds synthesis output into a
ring.  For fixed call lengths all of that control flow is static, so the
offline engine precomputes the whole block schedule on the host (this module)
and the device only runs the batched stages that consume it.

Everything here replicates the C++ integer/float32 semantics bit for bit:
  - input position   round(outputIndex * float(inputSamples) / outputSamples)
                     with float32 ops and round-half-away-from-zero (:288)
  - time factors     interval / max(1, inputInterval) in float32 (:312)
  - seek arithmetic  signalsmith-stretch.h:139-207
  - flush tail       signalsmith-stretch.h:426-464
  - exact() plumbing signalsmith-stretch.h:467-491

The virtual input timeline is a concatenation of segments (zero padding, input
slices, flush zeros); analysis frames are windows at static offsets.  Extreme
time-compression engages the reference's copy cap (block+interval per block,
copyInput :215-229): the dropped history is omitted from the timeline, which
stays frame-accurate because no frame reaches past one cap window.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .geometry import StretchConfig

f32 = np.float32


def cpp_round_f32(x: f32) -> int:
    """std::round on a float32 value: half away from zero, exact."""
    x64 = float(x)
    return int(np.floor(x64 + 0.5)) if x64 >= 0 else int(np.ceil(x64 - 0.5))


@dataclasses.dataclass
class TimelineSegment:
    kind: str          # "zeros" | "input"
    length: int
    src_offset: int = 0  # for kind == "input": offset into the user input


@dataclasses.dataclass
class BlockRecord:
    analysis_end: int      # timeline index one past the analysis frame
    out_pos: int           # output-ring index where synthesis is placed
    new_spectrum: bool
    reanalyse: bool
    time_factor: f32       # blockProcess.timeFactor (pre-clamp)


@dataclasses.dataclass
class ExactSchedule:
    cfg: StretchConfig
    in_samples: int
    out_samples: int
    valid: bool                      # False => exact() returns false + zeros
    segments: List[TimelineSegment] = dataclasses.field(default_factory=list)
    blocks: List[BlockRecord] = dataclasses.field(default_factory=list)
    timeline_len: int = 0
    ring_len: int = 0
    preroll_len: int = 0             # outputLatency() at seek rate
    main_out: int = 0                # samples produced by the main process()
    flush_block_out: int = 0         # zero-input process() samples inside flush
    tail_len: int = 0                # reversed-subtraction tail samples
    playback_rate: f32 = f32(0)
    seek_length: int = 0
    # silence-bypass bookkeeping (signalsmith-stretch.h:240-278)
    surplus: int = 0                 # pre-roll process() input samples
    seek_samples: int = 0            # input samples consumed by seek()
    main_in: int = 0                 # main process() input samples
    n_preroll_blocks: int = 0        # blocks fired by the pre-roll process()
    n_main_blocks: int = 0           # blocks fired by the main process()


class _SimState:
    """Persistent scheduling state across process() calls (reference members)."""

    def __init__(self, cfg: StretchConfig):
        self.cfg = cfg
        self.samples_since_last = 1 << 62   # size_t max analogue
        self.prev_input_offset = -1
        self.did_seek = False
        self.seek_time_factor = f32(1)
        self.timeline_len = 0
        self.out_read = 0
        self.segments: List[TimelineSegment] = []
        self.blocks: List[BlockRecord] = []

    def append_segment(self, kind: str, length: int, src_offset: int = 0):
        if length <= 0:
            return
        if (self.segments and kind == "input"
                and self.segments[-1].kind == "input"
                and self.segments[-1].src_offset + self.segments[-1].length == src_offset):
            self.segments[-1].length += length
        elif self.segments and kind == "zeros" and self.segments[-1].kind == "zeros":
            self.segments[-1].length += length
        else:
            self.segments.append(TimelineSegment(kind, length, src_offset))
        self.timeline_len += length

    # seek (signalsmith-stretch.h:139-165)
    def seek(self, input_len_supplied: int, src_base: int, playback_rate: f32):
        cfg = self.cfg
        buf = cfg.block_samples + cfg.interval_samples
        start_index = max(0, input_len_supplied - buf)
        pad_start = buf + start_index - input_len_supplied
        self.append_segment("zeros", pad_start)
        self.append_segment("input", input_len_supplied - start_index,
                            src_base + start_index)
        self.did_seek = True
        h = f32(cfg.interval_samples)
        self.seek_time_factor = (f32(1) / playback_rate
                                 if float(playback_rate * h) > 1
                                 else h)

    # process (signalsmith-stretch.h:209-423, minus the silence branch)
    def process(self, in_samples: int, out_samples: int, src_base: Optional[int]):
        """src_base None => zero input (flush's Zeros proxy)."""
        cfg = self.cfg
        H = cfg.interval_samples
        cap = cfg.block_samples + H
        prev_copied = 0

        def copy_input(to_index: int):
            nonlocal prev_copied
            delta = to_index - prev_copied
            if delta <= 0:
                prev_copied = to_index
                return
            # the reference copies at most block+interval per block (:215-229)
            length = min(cap, delta)
            if src_base is None:
                self.append_segment("zeros", length)
            else:
                self.append_segment("input", length,
                                    src_base + to_index - length)
            prev_copied = to_index

        split_shift = H if cfg.split_computation else 0
        o = 0
        while o < out_samples:
            if self.samples_since_last >= H:
                input_offset = cpp_round_f32(
                    f32(f32(o) * f32(in_samples) / f32(out_samples)))
                input_interval = input_offset - self.prev_input_offset
                self.prev_input_offset = input_offset
                copy_input(input_offset)

                new_spectrum = self.did_seek or (input_interval > 0)
                reanalyse = new_spectrum and (
                    self.did_seek or abs(input_interval - H) > 1)
                if self.did_seek:
                    time_factor = self.seek_time_factor
                else:
                    time_factor = f32(f32(H) / f32(max(1, input_interval)))
                self.did_seek = False

                self.blocks.append(BlockRecord(
                    analysis_end=self.timeline_len,
                    out_pos=self.out_read + o + split_shift,
                    new_spectrum=new_spectrum,
                    reanalyse=reanalyse,
                    time_factor=time_factor))
                self.samples_since_last = 0
                o_next_block = o + H
            else:
                o_next_block = o + (H - self.samples_since_last)
            advance = min(o_next_block, out_samples) - o
            self.samples_since_last += advance
            o += advance

        copy_input(in_samples)
        self.prev_input_offset -= in_samples
        self.out_read += out_samples


def build_exact_schedule(cfg: StretchConfig, in_samples: int,
                         out_samples: int) -> ExactSchedule:
    """Schedule for SignalsmithStretch::exact() (signalsmith-stretch.h:467-491)."""
    H = cfg.interval_samples
    playback_rate = f32(f32(in_samples) / f32(out_samples))
    # int outputSeekLength = int(inputLatency + playbackRate*outputLatency)
    seek_length = int(f32(f32(cfg.input_latency)
                          + f32(playback_rate * f32(cfg.output_latency))))
    sched = ExactSchedule(cfg=cfg, in_samples=in_samples,
                          out_samples=out_samples, valid=True,
                          playback_rate=playback_rate, seek_length=seek_length)
    if in_samples < seek_length:
        sched.valid = False
        return sched

    st = _SimState(cfg)

    # outputSeek(inputs, seekLength) (signalsmith-stretch.h:172-204)
    surplus = max(seek_length - cfg.input_latency, 0)
    preroll_rate = f32(f32(surplus) / f32(cfg.output_latency))
    seek_samples = seek_length - surplus
    st.seek(seek_samples, 0, preroll_rate)
    preroll_len = cfg.output_latency
    st.process(surplus, preroll_len, src_base=seek_samples)
    n_preroll_blocks = len(st.blocks)

    # main process: outputIndex = outputSamples - seekLength/playbackRate
    main_out = int(f32(f32(out_samples) - f32(f32(seek_length) / playback_rate)))
    st.process(in_samples - seek_length, main_out, src_base=seek_length)
    n_main_blocks = len(st.blocks) - n_preroll_blocks

    # flush (signalsmith-stretch.h:426-464)
    flush_out = out_samples - main_out
    flush_block_out = max(0, flush_out - H)
    if flush_block_out > 0:
        zeros_in = int(f32(f32(flush_block_out) * playback_rate))
        st.process(zeros_in, flush_block_out, src_base=None)
    tail_len = flush_out - flush_block_out

    sched.segments = st.segments
    sched.blocks = st.blocks
    sched.timeline_len = st.timeline_len
    sched.preroll_len = preroll_len
    sched.main_out = main_out
    sched.flush_block_out = flush_block_out
    sched.tail_len = tail_len
    sched.surplus = surplus
    sched.seek_samples = seek_samples
    sched.main_in = in_samples - seek_length
    sched.n_preroll_blocks = n_preroll_blocks
    sched.n_main_blocks = n_main_blocks
    sched.ring_len = (max(b.out_pos for b in st.blocks) + cfg.block_samples
                      + 2 * H + 8)
    return sched


def block_arrays(sched: ExactSchedule) -> dict:
    """The schedule's per-block flags and factors as numpy arrays."""
    blocks = sched.blocks
    return dict(
        analysis_end=np.array([b.analysis_end for b in blocks], np.int32),
        out_pos=np.array([b.out_pos for b in blocks], np.int32),
        new_spectrum=np.array([b.new_spectrum for b in blocks], np.bool_),
        reanalyse=np.array([b.reanalyse for b in blocks], np.bool_),
        time_factor=np.array([b.time_factor for b in blocks], np.float32),
    )
