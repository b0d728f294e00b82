"""The benchmark's harness: loading the cells, their loops (benchmark/loops/)
and their per-layer readers (benchmark/metrics/) by name, the clips, the
trace reduction, the rooflines and the comparison that decides
`correct`."""
