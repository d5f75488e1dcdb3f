"""The port's CUDA sources (``csrc/``) and their build key
(``utils/build.py``): each ``.cu`` is one kernel family that includes
headers only, so it compiles on its own, and a library's key follows its
source and every shared header.

The sources are compiled here as host C++ (g++, syntax only, in the three
host forms the tests and ``utils/opcount.py`` build: f64, f32 and the
counting scalar); nvcc builds them on the card."""

import glob
import os
import re
import shutil
import subprocess

import pytest

from srbd_nmpc_tpu_torch.utils import build

SOURCES = sorted(os.path.basename(p)[:-3]
                 for p in glob.glob(os.path.join(build.CSRC, "*.cu")))
FORMS = ((), ("-DSRBD_HOST_F32",), ("-DSRBD_OPCOUNT",))


def test_sources_are_the_kernel_families():
    assert SOURCES == ["linearize", "merit", "permute", "riccati",
                       "sqp_onepass", "sqp_planes", "sqp_twopass"]


@pytest.mark.parametrize("name", SOURCES)
def test_source_includes_headers_only_and_compiles_alone(name):
    """No source includes another source, and each compiles on its own in
    every host form."""
    path = os.path.join(build.CSRC, f"{name}.cu")
    with open(path) as f:
        includes = re.findall(r'^#include "([^"]+)"', f.read(), re.M)
    assert all(i.endswith(".cuh") for i in includes), includes
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    for flags in FORMS:
        proc = subprocess.run(
            ["g++", "-x", "c++", "-std=c++17", "-fsyntax-only", *flags, path],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (flags, proc.stderr[-2000:])


def test_build_key_follows_the_source_and_every_header(tmp_path, monkeypatch):
    """A library's key changes with its source, with any shared header and
    with the command, and with nothing else in ``csrc/``."""
    for name, text in (("a.cu", '#include "h.cuh"\n'), ("h.cuh", "// h\n"),
                       ("g.cuh", "// g\n"), ("b.cu", "// b\n")):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    src, cmd = str(tmp_path / "a.cu"), ["nvcc"]
    key = build._key(src, cmd)
    assert build._key(src, cmd) == key
    (tmp_path / "b.cu").write_text("// another source\n")
    assert build._key(src, cmd) == key
    assert build._key(src, ["nvcc", "-O2"]) != key
    for name in ("g.cuh", "a.cu"):
        (tmp_path / name).write_text("// changed\n")
        assert build._key(src, cmd) != key
        key = build._key(src, cmd)
