"""render.copy_out_device_ms on synthetic events (nanoseconds): the busy
time of the copies launched in `sst.render.copy_out`, a mean over the
requests, and None for a program without the span."""
import pytest

from benchmark.harness import common


def _rec(with_span=True):
    """Two requests, each a copy in, a kernel and a copy out."""
    host, device = [], []
    for t in (0, 1000):
        host += [("request", t, t + 1000),
                 ("sst.render.copy_in", t + 2, t + 8),
                 ("cudaMemcpyAsync", t + 3, t + 6),
                 ("cudaLaunchKernel", t + 20, t + 25)]
        if with_span:
            host.append(("sst.render.copy_out", t + 600, t + 990))
        host.append(("cudaMemcpyAsync", t + 610, t + 615))
        device += [("Memcpy HtoD (Pinned -> Device)", t + 7, t + 9),
                   ("sweep", t + 30, t + 600),
                   ("Memcpy DtoH (Device -> Pinned)", t + 620,
                    t + 620 + (80 if t else 40))]
    return {"host": sorted(host, key=lambda h: h[1]), "device": device,
            "spans": [(0, 1000), (1000, 2000)]}


def test_copy_out_busy_a_request():
    assert common.reader("render.copy_out_device_ms")(_rec()) == (
        pytest.approx(60 / 1e6))


def test_none_without_the_span():
    read = common.reader("render.copy_out_device_ms")
    assert read(_rec(with_span=False)) is None
    assert read({}) is None
