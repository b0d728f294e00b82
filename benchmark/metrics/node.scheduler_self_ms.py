"""node.scheduler_self_ms: the self time of the program's
`sst.node.quantum` span (StretchNode.process_quantum less the program
spans inside it: the node's own Python around the history read, the seek,
the process and the output copy), ms a quantum."""
from benchmark.harness import spans


def read(rec):
    per = spans.self_ms(rec, "sst.node.quantum")
    return spans.mean(per) if per else None
