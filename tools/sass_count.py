"""Static SASS counts of the port's kernels, and their SASS compared across
trees, on a machine with nvcc and cuobjdump (the card's).

    python3 tools/sass_count.py --source sqp_planes \
        --kernels k1s_riccati_team_kernel k1s_riccati_team_f64_kernel \
        [--trees . build/parent]

compiles ``srbd_nmpc_tpu_torch/csrc/<source>.cu`` of each tree to a cubin
with the port's nvcc flags (``utils/build.NVCC_FLAGS``), disassembles it
(``cuobjdump -sass``) and prints one JSON line per kernel whose mangled
name holds one of ``--kernels`` (all kernels without it): its instructions
by class (shared loads by width, shared stores, barriers, warp syncs,
float adds and multiplies, global loads and stores, all), and a hash of
its SASS with addresses and encodings stripped, so that two trees' builds
of one kernel can be compared. The counts are static: each instruction of
the kernel once, whatever the loop trips.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srbd_nmpc_tpu_torch.utils import build  # noqa: E402

# an instruction line: /*addr*/ [@pred] OPCODE[.mods] operands ; /* encoding */
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")


def _classes(op: str) -> list:
    """The classes an opcode (with its modifiers) counts in."""
    base, *mods = op.split(".")
    width = next((m for m in mods if m in ("64", "128")), "32")
    out = []
    if base == "LDS":
        out += ["LDS", f"LDS.{width}"]
    elif base == "STS":
        out += ["STS", f"STS.{width}"]
    elif base in ("BAR", "WARPSYNC", "FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA", "MUFU",
                  "LDG", "STG", "LDL", "STL"):
        out.append(base)
    return out + ["all"]


def sass_by_kernel(cubin: str) -> dict:
    """Kernel mangled name -> list of (opcode, operands) of its SASS."""
    text = subprocess.run(["cuobjdump", "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = _FUNC.search(ln)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(ln)
        if m and cur is not None:
            cur.append(((m.group(1) or "").strip() + " " + m.group(2), m.group(3).strip()))
    return out


def _counts(insns) -> dict:
    c = collections.Counter()
    for op, _ in insns:
        c.update(_classes(op.split()[-1]))
    return dict(sorted(c.items()))


def _steps(insns) -> list:
    """The counts of each stretch of ``insns`` that ends at a barrier: a
    block barrier (``BAR``), or a warp's (``__syncwarp`` compiles to a
    ``BRA.DIV`` to an out-of-line ``WARPSYNC``, which ends a stretch too)."""
    out, cur = [], []
    for op, a in insns:
        cur.append((op, a))
        opc = op.split()[-1]
        if opc.split(".")[0] in ("BAR", "WARPSYNC") or opc.startswith("BRA.DIV"):
            out.append(_counts(cur))
            cur = []
    return out + [_counts(cur)]


def count(tree: str, source: str, needles, steps=False, dump=None) -> dict:
    """Mangled name -> counts (and SASS hash) of ``source``'s kernels in ``tree``."""
    src = os.path.join(tree, "srbd_nmpc_tpu_torch", "csrc", f"{source}.cu")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{source}.cubin")
        subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin, src], check=True,
                       capture_output=True, text=True)
        kernels = sass_by_kernel(cubin)
    res = {}
    for name, insns in kernels.items():
        if needles and not any(n in name for n in needles):
            continue
        digest = hashlib.sha256("\n".join(f"{o} {a}" for o, a in insns).encode())
        res[name] = dict(_counts(insns), sass_sha=digest.hexdigest()[:16])
        if steps:
            res[name]["steps"] = _steps(insns)
        if dump:
            os.makedirs(dump, exist_ok=True)
            tag = os.path.basename(os.path.abspath(tree))
            with open(os.path.join(dump, f"{tag}.{name}.sass"), "w") as f:
                f.write("\n".join(f"{o} {a}" for o, a in insns) + "\n")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True)
    ap.add_argument("--kernels", nargs="*", default=[])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    for tree in args.trees:
        for name, c in count(tree, args.source, args.kernels, args.steps,
                             args.dump).items():
            print(json.dumps(dict(tree=tree, source=args.source, kernel=name, **c)),
                  flush=True)


if __name__ == "__main__":
    main()
