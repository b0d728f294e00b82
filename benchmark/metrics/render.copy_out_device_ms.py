"""render.copy_out_device_ms: the device's busy time (the union of its
intervals) of the operations launched inside the program's
`sst.render.copy_out` span (a host request's render copied into pinned
host memory), ms a request; None where the program has no such span."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_busy_ms(rec, "sst.render.copy_out")
    return spans.mean(per) if per else None
