"""run.py's refusals: no card, no program beside it, JAX loaded."""
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark.harness import common, runner
from benchmark.tests.test_bench_faults import BENCH, run


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "node_stretch1.25", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=common.ROOT,
                       capture_output=True, text=True)
    if p.returncode == 0:
        pytest.skip("a card is present")
    assert p.returncode == 3 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: the harness
    cannot build the system under test."""
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(common.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import io, sys; sys.path.insert(0, '.'); "
            "from benchmark.harness import common, runner; "
            "from benchmark.tests.test_bench_reference import small_config, "
            "small_node; b = common.benchmark(); "
            "c = common.cell(b, 'node_stretch1.25'); "
            "print(runner.measure(b, c, small_config(c['config']), "
            "small_node(), common.limits(c['name']), 1, 0.1, False, 0.0, "
            "'cpu', io.StringIO()))")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "signalsmith_stretch_torch" in p.stderr


def test_jax_loaded_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    with pytest.raises(runner.Forbidden):
        run("node_stretch1.25")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(workload):
    """Each cell, a short window, on the card: a result that is correct."""
    import json
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 99), "--seconds",
                        "2", "--trace", "0"], cwd=common.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
