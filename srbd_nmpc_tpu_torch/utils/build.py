"""Build and load the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so
         csrc/<name>.cu

- The output goes to ``srbd_nmpc_tpu_torch/build/`` (ignored by git),
  keyed by a hash of the source, the shared headers ``csrc/*.cuh`` and the
  flags, so a changed source or header is rebuilt and an unchanged one is
  reused.
- The library is written under a temporary name and renamed into place
  (atomic on POSIX), so concurrent processes never load a partial file.
- A failed build raises with nvcc's output; ``-Xptxas -v`` output of a
  successful build (registers, spill bytes) is kept beside the library as
  ``lib<name>_<hash>.log`` and returned by ``build_log``.
- Never fast-math: the SO(3) chain needs full-precision transcendentals.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# -fmad=false: no multiply-add contraction, so a kernel rounds like its
# plain PyTorch version (one rounding per elementwise op). Measured on an
# H100 (700 W): with contraction K1 is 12.5 vs 13.9 ms per B=131072 launch
# but differs from the plain version by up to 1.9e-4 (relative) in f32 on
# random inputs, as far as the plain version itself is from f64; without
# it the difference is below 7e-5 and zero on the benchmark iterate.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda)")


def _key(src: str, cmd) -> str:
    """Hash of ``src``, every shared header in ``csrc/`` and the command."""
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(cmd).encode())
    return h.hexdigest()[:16]


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    key = _key(src, NVCC_FLAGS)
    stem = os.path.join(BUILD_DIR, f"lib{name}_{key}")
    return src, stem + ".so", stem + ".log"


def _compile(cmd_head, src: str, lib: str, log: str) -> str:
    """Run ``cmd_head -o <tmp> src`` and rename the result to ``lib``."""
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".lib_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd_head, "-o", tmp, src],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd_head[0]} failed to build {src} (exit "
                f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        log_tmp = f"{log}.{os.getpid()}.tmp"
        with open(log_tmp, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(log_tmp, log)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` with nvcc unless its keyed library exists;
    return the library's path."""
    src, lib, log = _paths(name)
    return _compile([_nvcc(), *NVCC_FLAGS], src, lib, log)


def build_host(src: str, flags=("-O2",)) -> str:
    """Compile a C++ source (``.cpp``, or a ``.cu`` file's host build) with
    g++ into a keyed shared library in the build directory; return its
    path."""
    cmd = ["g++", "-x", "c++", "-std=c++17", "-shared", "-fPIC", *flags]
    key = _key(src, cmd)
    stem = os.path.join(
        BUILD_DIR, f"libhost_{os.path.splitext(os.path.basename(src))[0]}_{key}")
    return _compile(cmd, src, stem + ".so", stem + ".log")


def build_log(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report of the current build of ``name``."""
    _, _, log = _paths(name)
    with open(log) as f:
        return f.read()


def check_cuda_f32(name: str, t, shape, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a CUDA tensor of shape ``shape`` in ``dtype``
    (float32 unless the kernel has a form in another): what every kernel
    wrapper checks before it hands a pointer to a kernel. The shape is
    checked first, so a misshapen input is named on any device."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device.type != "cuda" or t.dtype != dtype:
        what = str(dtype).replace("torch.", "")
        raise TypeError(f"{name}: the CUDA kernel takes {what} CUDA tensors, "
                        f"got {t.dtype} on {t.device}")


def load_kernel(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise RuntimeError(f"cannot load {path}: {exc}") from exc
            _loaded[name] = lib
        return lib
