"""stream.seek_host_ms: the host's wall time of the program's
`sst.stream.seek` span (StreamingStretch._seek: the history's copy to the
device, the new history, the energy test), ms a quantum."""
from benchmark.harness import spans


def read(rec):
    per = spans.wall_ms(rec, "sst.stream.seek")
    return spans.mean(per) if per else None
