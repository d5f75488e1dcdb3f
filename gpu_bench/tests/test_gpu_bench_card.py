"""A short run of every cell on the card, through run.py as the check runs
it: the result line's keys, a correct run, no failures. Skips without a
card.

    python3 -m pytest gpu_bench/tests/test_gpu_bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpu_bench import harness

ROOT = os.path.dirname(harness.HERE)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.benchmark_spec()["workloads"]])
def test_cell_runs_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    cell = harness.cell(name)
    want = cell["per_layer" if trace else "end_to_end"]
    assert {m["name"] for m in want} >= set(res["metrics"])
    if trace:
        assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    else:
        assert set(res["metrics"]) == {m["name"] for m in want}
