"""stream.block_host_ms: the host's wall time of the program's
`sst.stream.block` spans (one a stream block: its frames and D, the
spectral step, the synthesis and overlap-add), ms a block; beside
stream.block_device_ms."""
from benchmark.harness import spans


def read(rec):
    per = spans.per_outer(rec, "sst.stream.block")
    if not per:
        return None
    return spans.mean([(e - s) / 1e6 for g in per for s, e in g])
