"""The cell-parametrised runs of test_bench_faults.py take the small sizes
of the offline or node mix (test_bench_reference.small_offline and
small_node), whose traffic names the `offline` or `node` loop.  A cell
whose own traffic names another loop (offline_random, for the stretches
above 2x) runs there with its own loop, at the same small sizes."""
import pytest

from benchmark.harness import common


@pytest.fixture(autouse=True)
def _cells_own_loop(request, monkeypatch):
    callspec = getattr(request.node, "callspec", None)
    workload = callspec.params.get("workload") if callspec else None
    if (workload is None
            or request.module.__name__.split(".")[-1] != "test_bench_faults"):
        return
    cell = common.cell(common.benchmark(), workload)
    loop = common.traffic(cell["traffic"])["loop"]
    small = request.module.small_offline
    if "offline" in workload and loop != small()["loop"]:
        monkeypatch.setattr(request.module, "small_offline",
                            lambda: dict(small(), loop=loop))
