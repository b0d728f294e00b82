"""The plain reference: it loads nothing of the port, JAX or the JAX
package; at a tiny size on the CPU it gives the port's plain path's bits,
offline and a stream's quanta; and its bfloat16 control fails the
limits."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import check, common
from benchmark.reference import render, spectral
from benchmark.reference.geometry import StretchConfig

RATE = 8000
CONFIGS = ("pitch12_tonality8k", "stretch1.25_default")
# each configuration's cells by loop, from BENCHMARK.json
CELLS = {c: {common.traffic(w["traffic"])["loop"]: w["name"]
             for w in common.benchmark()["workloads"] if w["config"] == c}
         for c in CONFIGS}


def small_config(name):
    return dict(common.load_json(f"{common.BENCH_DIR}/configs/{name}.json"),
                sample_rate=RATE)


def small_offline():
    return dict(common.traffic("offline_batch32x10s"), batch=4,
                clip_seconds=1.0, pool=2, check_clips=4, check_block=8,
                stage_reps=1, trace_requests=1)


def small_node():
    return dict(common.traffic("node_paced128"), warm_quanta=40,
                check_runs=2, buffer_seconds=8.0, bank_seconds=2.0)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import benchmark.reference.render, "
            "benchmark.reference.stream; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not tops & {"signalsmith_stretch_torch", "jax", "jaxlib", "flax",
                       "signalsmith_stretch_tpu"}


def test_forbidden_compares_whole_names():
    sys.modules.setdefault("jaxlike_module", type(sys)("jaxlike_module"))
    assert "jaxlike_module" not in common.forbidden_loaded()
    assert "signalsmith_stretch_torch" not in common.FORBIDDEN


@pytest.mark.parametrize("name", CONFIGS)
def test_offline_reference_is_the_ports_plain_path(name):
    from signalsmith_stretch_torch.models.stretch import StretchModel
    cfg = small_config(name)
    n_in = RATE
    n_out = int(n_in * cfg["time_factor"])
    rng = np.random.default_rng(7)
    audio = (0.3 * rng.standard_normal((2, 2, n_in))).astype(np.float32)
    audio[1, :, : n_in // 2] = 0       # a silent stretch
    port = StretchModel.build(2, RATE, n_in, n_out, device="cpu",
                              **cfg["controls"])
    want = port.batched(audio).numpy()
    plan = render.build_exact_plan(StretchConfig.preset_default(2, RATE),
                                   n_in, n_out)
    ctl = spectral.Controls.of(RATE, **cfg["controls"])
    got = render.render(torch.as_tensor(audio), plan, ctl).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_stream_reference_steps_the_ports_node(name):
    """The reference stepping from the node's own state before each
    quantum, and from its own initial state, gives the node's bits."""
    cfg = small_config(name)
    nd = common.loop("node")(cfg, small_node(), 11, "cpu")
    nd.window(0.3)
    got = nd.numbers()
    assert set(got) >= {"start_gap", "quantum_gap", "state_gap"}
    assert all(v == 0.0 for v in got.values()), got


@pytest.mark.parametrize("name", CONFIGS)
def test_controls_fail(name):
    """The reference in bfloat16 in the program's place reads far above
    the sound runs' gaps and fails the cells' limits."""
    cfg = small_config(name)
    o = common.loop("offline")(cfg, small_offline(), 5, "cpu")
    o.window(0.01)
    o.free()
    sound = o.numbers()["chaos_gap"]
    ctl = o.numbers(control=True)["chaos_gap"]
    lim = common.limits(CELLS[name]["offline"])
    assert sound < 1 < lim["chaos_gap"]["limit"] < ctl
    if "node" not in CELLS[name]:
        return
    nd = common.loop("node")(cfg, small_node(), 6, "cpu")
    nd.window(0.3)
    got = nd.numbers(control=True)
    lim = common.limits(CELLS[name]["node"])
    assert not check.correct(check.decide(got, lim))
