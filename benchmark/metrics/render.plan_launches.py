"""render.plan_launches: the device operations (kernels, copies, memsets)
launched inside the program's `sst.render.plan` span, a request."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_ops(rec, "sst.render.plan")
    return spans.mean([len(g) for g in per]) if per else None
