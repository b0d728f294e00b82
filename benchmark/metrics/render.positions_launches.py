"""render.positions_launches: the device operations (kernels, copies,
memsets) launched inside the program's `sst.plan.positions` span, a
request."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_ops(rec, "sst.plan.positions")
    return spans.mean([len(g) for g in per]) if per else None
