"""stream.launches_per_block: the device operations inside the quanta that
run a block, over the blocks they run."""
from benchmark.harness import trace


def read(rec):
    quanta, blocks = rec.get("spans"), rec.get("blocks")
    if not quanta or blocks is None or len(quanta) != len(blocks):
        return None
    spans = [q for q, b in zip(quanta, blocks) if b > 0]
    total = int(sum(blocks))
    if not total:
        return None
    n = sum(len(trace.within(rec["device"], a, b)) for a, b in spans)
    return n / total if n else None
