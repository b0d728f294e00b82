"""node.output_wait_ms: the host's wall time of the program's
`sst.stream.output` spans (the output's normalisation, and its copy to the
host, where the host waits for the card), ms a quantum, over the quanta
that run a block."""
from benchmark.harness import spans


def read(rec):
    out = spans.wall_ms(rec, "sst.stream.output")
    blocks = spans.per_outer(rec, "sst.stream.block")
    if not out or not blocks:
        return None
    return spans.mean([ms for ms, b in zip(out, blocks) if b])
