#!/usr/bin/env python3
"""Compare the compiled i.i.d. kernels of two builds, instruction by
instruction.

  python3 tools/iid_sass_diff.py OLD.so NEW.so     # needs the CUDA toolkit

OLD and NEW are two builds of one kernel library (``cim_read.cu`` or
``fault_inject.cu``), e.g. the libraries ``chip_smoke.py`` leaves under
``build/repro_torch/`` in two checkouts. Each old instantiation is paired
with the new one whose template arguments are the same, or the old ones
plus a trailing kind 0 (``MODEL_IID``: a kernel that gained a fault-process
parameter), or the old ones plus or less a trailing ``false`` (K3's kernel,
which lost a shard-offset flag in one change and gained another, its
column-shard flag, in a later one); the script reads both with ``cuobjdump
-sass``, drops addresses and encodings, and prints for each pair whether
the instruction streams are equal, or how many lines differ. Exits non-zero
when no pair was found.
"""
from __future__ import annotations

import difflib
import re
import shutil
import subprocess
import sys

FAMILY = re.compile(r"(?<=\d)((?:cim_read|fault_inject)_\w*?kernel)I((?:L[ib]\d+E|[a-z])+)E")


def _sass(lib: str) -> dict:
    """{(family, template args): [normalized instructions]}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            m = FAMILY.search(ln)
            cur = (m.group(1), m.group(2)) if m else None
            if cur:
                funcs[cur] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+([^;]*);", ln)
        if cur and m:
            funcs[cur].append(re.sub(r"\s+", " ", m.group(1)).strip())
    return funcs


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = _sass(argv[1]), _sass(argv[2])
    pairs = 0
    for (family, args), code in sorted(old.items()):
        kin = [args, args + "Li0E", args + "Lb0E"] + (
            [args[:-4]] if args.endswith("Lb0E") else [])
        twin = next((new[(family, a)] for a in kin if (family, a) in new),
                    None)
        if twin is None:
            continue
        pairs += 1
        diff = [d for d in difflib.unified_diff(code, twin, lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        print(f"sass: {family}<{args}>: {len(code)} vs {len(twin)} "
              f"instructions, "
              + ("identical" if not diff else f"{len(diff)} lines differ"))
    print(f"sass: {pairs} instantiations compared")
    return 0 if pairs else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
