"""Every cell of BENCHMARK.json finds its configuration, traffic, reference
and metric readers by name, and the file keeps to the benchmark's
contract."""

import importlib
import json
import os
import re

import pytest

from gpu_bench import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_by_name(name):
    c = harness.cell(name, SPEC)
    assert c["config"]["name"] == c["workload"]["config"]
    importlib.import_module(f"gpu_bench.reference."
                            f"{c['config']['reference']}")
    for m in c["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    assert set(c["config"]["limits"]) == {"mismatch_pct", "u_gap", "x_gap"}


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    root = os.path.dirname(harness.HERE)
    cells = {w["name"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpu_bench/")
        assert os.path.exists(os.path.join(root, c["file"]))
        assert json.load(open(os.path.join(root, c["file"])))["name"] \
            == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
    for entry in (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
                  + SPEC["per_layer"]):
        assert NAME.match(entry["name"])
