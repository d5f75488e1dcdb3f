"""Nothing a run imports is JAX or the JAX package (by whole top-level
name: the port's name begins with the JAX package's), and the reference
imports nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DRIVE = """
import json, sys, torch
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(body):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c",
                          DRIVE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules("""
import importlib
sys.argv = ["run.py"]
run = importlib.import_module("gpu_bench.run")
from gpu_bench import harness, trace
for c in harness.benchmark_spec()["workloads"]:
    cell = harness.cell(c["name"])
    for m in cell["per_layer"]:
        harness.load_metric(m["name"])
harness.run_cell("fleet_cold", 5, 0.0, True, device="cpu",
                 dtype=torch.float64, batch=16)
assert run.forbidden_modules() == [], run.forbidden_modules()
""".replace("harness.run_cell", "trace.PAD_S = 0.0\nharness.run_cell"))
    assert "srbd_nmpc_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "srbd_nmpc_tpu"}


def test_reference_imports_nothing_of_the_program():
    mods = _modules("from gpu_bench.reference import srbd_sqp\n"
                    "from gpu_bench import check, traffic")
    assert not mods & {"srbd_nmpc_tpu_torch", "srbd_nmpc_tpu", "jax"}
