"""The least time of two kernels of the randomised plan (above 2x) on one
H100, from a request's shapes (the offline_random loop's traced record,
`shapes`: rows R, bands B, channels, position sets, draws).  The count
depends on the shapes alone, not on the code that runs.

- A, the lookup on the four per-bin position sets: bytes, each bin's
  positions (4 B a set), the input planes (8 B a channel) and the outputs
  (8 B a channel and set), at the HBM rate.
- I, the draws: the longer of its bytes (btf1 and btf2, 8 B a bin) at the
  HBM rate and its 32-bit integer operations, counted from Threefry-2x32
  with 20 rounds: a draw is one hash, 2 key additions, 20 rounds of an
  add, a rotate and an xor, 5 key injections of 2 additions (the round
  constant folded into the key word once a key), then the xor of the
  hash's two words: 73 operations.  They run at the SM's issue rate, 128
  a clock (four schedulers of 32 lanes): Hopper issues integer additions
  on the FMA pipe (IMAD.IADD) beside the ALU, so the ALU's 64 a clock is
  not the peak, and I runs faster than 73 operations at 64 a clock
  allow.  132 SMs at 1.98 GHz (NVIDIA's data sheet for the H100 SXM)."""
from __future__ import annotations

from benchmark.harness.roofline import PEAK_BYTES

SMS = 132
CLOCK_HZ = 1.98e9
INT_PER_CLOCK = 128
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2 + 1
PEAK_INT = SMS * INT_PER_CLOCK * CLOCK_HZ


def lookup_bound_ms(shapes: dict) -> float:
    """Kernel A on the sets: positions, input planes and outputs, each
    byte once."""
    ch, sets = shapes["channels"], shapes["sets"]
    per_bin = sets * 4 + ch * 8 + sets * ch * 8
    return 1e3 * shapes["R"] * shapes["B"] * per_bin / PEAK_BYTES


def draws_bound_ms(shapes: dict) -> float:
    """Kernel I: its bytes or its integer operations, the longer."""
    t_bytes = shapes["R"] * shapes["B"] * 8 / PEAK_BYTES
    t_ops = shapes["draws"] * THREEFRY_OPS / PEAK_INT
    return 1e3 * max(t_bytes, t_ops)
