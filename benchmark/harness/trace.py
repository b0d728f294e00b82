"""The profiler's events as plain tuples, and the reductions the per-layer
readers share: the union of device intervals, the operations inside a
host span, the breakdown of device time and of idle gaps.

Events are kept in memory (no Chrome trace is written).  Times are in
nanoseconds on the profiler's clock, which it shares between the host's
events and the card's."""
from __future__ import annotations

import bisect
import collections


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def events(prof, spans=()):
    """(host, device): host events (name, start, end) (operators and the
    loop's own record_function spans, named in `spans`) and device events
    (name, start, end) (kernels, copies, memsets; not the mirrors of those
    spans that the profiler puts on the device's timeline), each sorted by
    start."""
    from torch.autograd import DeviceType
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + int(e.duration_ns() if hasattr(e, "duration_ns")
                          else e.duration_us() * 1000)
        if e.device_type() == DeviceType.CUDA:
            if e.name() in spans:
                continue
            device.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), start, end))
    host.sort(key=lambda x: x[1])
    device.sort(key=lambda x: x[1])
    return host, device


def spans(host, name: str):
    """The host spans called `name`, (start, end), in order."""
    return [(s, e) for n, s, e in host if n == name]


def union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def within(device, start: int, end: int):
    """The device events that start inside [start, end), clipped to it."""
    starts = [d[1] for d in device]
    i = bisect.bisect_left(starts, start)
    out = []
    while i < len(device) and device[i][1] < end:
        n, s, e = device[i]
        out.append((n, s, min(e, end)))
        i += 1
    return out


def busy_ns(device, windows) -> int:
    """Device busy time (union of intervals) inside each (start, end)
    window, summed."""
    return sum(union_ns([(s, e) for _, s, e in within(device, a, b)])
               for a, b in windows)


def top_ops(device, windows, n: int = 10):
    """[[name, seconds], ...]: the device operations that took most time
    inside the windows."""
    acc = collections.Counter()
    for a, b in windows:
        for name, s, e in within(device, a, b):
            acc[name[:120]] += e - s
    return [[k, v / 1e9] for k, v in acc.most_common(n)]


def idle_gaps(host, device, windows, n: int = 10, outside: str = "no span"):
    """[[what the host was doing, seconds], ...]: the device's idle time
    inside the windows, each gap named by the innermost host event that
    covers its middle (or `outside` where none does), summed by name, the
    longest first."""
    starts = [h[1] for h in host]
    acc = collections.Counter()
    for a, b in windows:
        busy = merged([(s, e) for _, s, e in within(device, a, b)])
        edges = [a] + [x for iv in busy for x in iv] + [b]
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name, best = outside, None
            for j in range(i, max(-1, i - 400), -1):
                hn, hs, he = host[j]
                if he >= mid and (best is None or hs > best):
                    name, best = hn, hs
                    break
            acc[name[:120]] += g1 - g0
    return [[k, v / 1e9] for k, v in acc.most_common(n)]
