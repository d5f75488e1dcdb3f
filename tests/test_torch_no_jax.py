"""The PyTorch port imports neither JAX nor (for its defaults) PyYAML, and
never falls back to the CPU when a CUDA device is asked for, explicitly or
by default."""

import os
import re
import subprocess
import sys

import pytest
import torch

import srbd_nmpc_tpu_torch
from srbd_nmpc_tpu_torch.utils.device import resolve_device

PKG_DIR = os.path.dirname(srbd_nmpc_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["yaml"] = None
import srbd_nmpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    srbd_nmpc_tpu_torch.__path__, "srbd_nmpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from srbd_nmpc_tpu_torch.utils.config import MpcOptions
from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
build_from_options(MpcOptions.default(), device="cpu")
assert not any(m == "jax" or m.startswith("jax.") or m.startswith("srbd_nmpc_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
print(" ".join(names))
"""


def test_imports_without_jax_or_yaml():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 19
    # the OCP-QP package, the shared Riccati solve and the AoS model
    for name in ("ocpqp", "ocpqp.data", "ops.riccati_soa", "ops.so3",
                 "models.srbd"):
        assert f"srbd_nmpc_tpu_torch.{name}" in names, name


def test_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import srbd_nmpc_tpu\b|"
                     r"from srbd_nmpc_tpu[ .])", re.M)
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    from srbd_nmpc_tpu_torch.models import srbd

    with pytest.raises(RuntimeError, match="cuda"):
        srbd.SRBDParams.create(device="cuda")
    # the default is the card, too
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        srbd.SRBDParams.create()
    assert resolve_device("cpu") == torch.device("cpu")
