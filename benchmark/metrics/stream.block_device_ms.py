"""stream.block_device_ms: the device's busy time (the union of its
intervals) inside the quanta that run a block, ms over the blocks they
run."""
from benchmark.harness import trace


def read(rec):
    quanta, blocks = rec.get("spans"), rec.get("blocks")
    if not quanta or blocks is None or len(quanta) != len(blocks):
        return None
    spans = [q for q, b in zip(quanta, blocks) if b > 0]
    total = int(sum(blocks))
    busy = trace.busy_ns(rec["device"], spans)
    return busy / 1e6 / total if total and busy else None
