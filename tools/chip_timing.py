"""What the card timing tools share: CUDA-event timing, output digests, the
card's name and power limit, and the frame of a parent-vs-change timer.

A parent-vs-change timer (``k3_burst_time.py``, ``k4_block_time.py``) runs
``args = checkout(tool, argv)``, which imports ``repro_torch`` from
``--root``'s ``src`` (default: this checkout), times its cases table with
:func:`time_ms`, digests each case's output with :func:`digest`, and ends
with ``emit(out, args)``. Two checkouts (a parent unpacked with ``git
archive`` into a git-ignored directory, and the change) timed in turn in
one call on one card are then compared case by case, digest to digest.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_ms(fn, reps: int = 5, inner: int = 5, warm: int = 3) -> float:
    """Median over ``reps`` CUDA-event runs of ``inner`` calls of ``fn``
    (after ``warm`` calls), in ms a call."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return sorted(times)[len(times) // 2]


def digest(t) -> str:
    """The first 16 hex digits of the SHA-1 of a tensor's bytes."""
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:16]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def checkout(tool: str, argv=None):
    """Parse ``--root DIR`` and ``--json PATH`` and put ``DIR/src`` first on
    ``sys.path``; None (after saying why) when there is no CUDA card."""
    ap = argparse.ArgumentParser(prog=tool)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: torch.cuda is not available", file=sys.stderr)
        return None
    return args


def emit(out: dict, args) -> None:
    """Add the card to ``out``; print it as one JSON line (appended to
    ``--json`` too, where given), then the card."""
    out["card"] = card()
    line = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "a") as f:
            f.write(line + "\n")
    print(line)
    print(out["card"])
