"""render.positions_device_ms: the device's busy time (the union of its
intervals) of the operations launched inside the program's
`sst.plan.positions` span (the four per-bin vote position sets above 2x),
ms a request."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_busy_ms(rec, "sst.plan.positions")
    return spans.mean(per) if per else None
