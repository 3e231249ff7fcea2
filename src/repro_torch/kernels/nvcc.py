"""Build a hand-written CUDA source into a shared library and bind it.

Each kernel module owns one :class:`CudaLibrary`: one ``.cu`` file compiled
with ``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch/`` at the
repository root (git-ignored), named by a hash of its sources and flags so an
edited source is rebuilt. Headers shared between kernel families live in
``kernels/csrc/`` (the counter-PRNG hash of ``flip.cuh``) and are on the
include path of every build. The library exposes a plain C interface bound
with ``ctypes``; a failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

COMMON_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("repro_torch kernels: nvcc not found (needs the CUDA "
                       "toolkit)")


class CudaLibrary:
    """One ``.cu`` source, built once per source hash, bound by ``bind``
    (which sets the ``argtypes``/``restype`` of each C entry point)."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.name = self.source.stem
        self._bind = bind
        self._lib = None
        self.build_log = ""

    def _sources(self):
        headers = sorted(self.source.parent.glob("*.cuh")) \
            + sorted(COMMON_CSRC.glob("*.cuh"))
        return [self.source] + headers

    def _hash(self) -> str:
        h = hashlib.sha1()
        for path in self._sources():
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def build(self, build_dir: Path | None = None) -> Path:
        """Compile (if this source hash is not built yet); the library path."""
        build_dir = Path(build_dir or BUILD_DIR)
        build_dir.mkdir(parents=True, exist_ok=True)
        lib_path = build_dir / f"{self.name}-{self._hash()}.so"
        if lib_path.exists():
            return lib_path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(COMMON_CSRC), "-o", tmp,
               str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{self.name}: nvcc failed ({proc.returncode}):"
                               f"\n{self.build_log}")
        os.replace(tmp, lib_path)
        return lib_path

    def load(self) -> ctypes.CDLL:
        """The bound library, built on first use."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib

    def timed_build(self) -> float:
        """Build and load; the wall seconds it took."""
        t0 = time.perf_counter()
        self.load()
        return time.perf_counter() - t0


def check_rc(rc: int, name: str) -> None:
    """Raise on a C entry point's refusal (-1) or a CUDA launch error."""
    if rc == -1:
        raise ValueError(f"{name}: arguments outside what the kernel takes")
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
