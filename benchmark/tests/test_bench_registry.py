"""BENCHMARK.json and the files it names: every configuration, traffic mix,
per-layer metric and limit is found by name, and the file keeps to the
benchmark's contract on names, units and keys."""
import json
import os
import re

import pytest

from benchmark.harness import common

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    for text in (c["source"], c["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    cfg = common.config(BENCH, c["name"])
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert c["file"].startswith("benchmark/configs/")
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    traffic = common.traffic(w["traffic"])
    loop = common.load("loops", traffic["loop"])
    assert callable(loop.Loop) and loop.FAULTS
    limits = common.limits(w["name"])
    assert [k for k in limits if not k.startswith("_")]
    e2e = common.metrics_for(BENCH, w["name"], "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert common.metrics_for(BENCH, w["name"], "per_layer")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_found(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert callable(common.reader(m["name"]))
    assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moved.get("workloads",
                                                 m["workloads"]))
    assert common.reader(m["name"])({}) is None


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_files_named_by_names():
    root = common.BENCH_DIR

    def have(sub, ext):
        return {f[:-len(ext)] for f in os.listdir(os.path.join(root, sub))
                if f.endswith(ext)}

    assert {m["name"] for m in BENCH["per_layer"]} <= have("metrics", ".py")
    assert {w["traffic"] for w in BENCH["workloads"]} <= have("traffic",
                                                              ".json")
    assert {w["name"] for w in BENCH["workloads"]} <= have("limits", ".json")
    loops = {common.traffic(w["traffic"])["loop"] for w in BENCH["workloads"]}
    assert loops <= have("loops", ".py")


def test_loaded_once_by_path():
    a = common.load("loops", "node")
    assert common.load("loops", "node") is a
    assert a.__name__.split(".")[0] not in common.FORBIDDEN


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_controls_passed_unchanged(c, monkeypatch):
    """A configuration's controls reach the program's builders as they
    stand in its file, whatever keys they hold."""
    from signalsmith_stretch_torch.models.stretch import StretchModel
    from signalsmith_stretch_torch.scheduler import StretchNode
    cfg = common.config(BENCH, c["name"])
    seen = []

    class Stop(Exception):
        pass

    def build(*a, **k):
        seen.append(k)
        raise Stop

    def start(self, **k):
        seen.append(k)
        raise Stop

    monkeypatch.setattr(StretchModel, "build", build)
    monkeypatch.setattr(StretchNode, "start", start)
    for loop in ("offline", "node"):
        traffic = dict(common.traffic(next(
            w["traffic"] for w in BENCH["workloads"]
            if common.traffic(w["traffic"])["loop"] == loop)),
            buffer_seconds=1.0, bank_seconds=1.0, clip_seconds=0.5)
        with pytest.raises(Stop):
            common.loop(loop)(dict(cfg, sample_rate=8000), traffic, 1, "cpu")
    assert all(cfg["controls"].items() <= k.items() for k in seen)
    assert len(seen) == 2
