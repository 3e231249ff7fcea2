"""Build and bind the hand-written CUDA kernels of ``csrc/cim_read.cu``.

The shared library is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/`` at the repository root (git-ignored), named by a hash
of the sources so an edited source is rebuilt. It exposes a plain C interface
bound with ``ctypes``; pointers and the stream pass as ``c_void_p``. A failed
build, a refused argument set or a non-zero ``cudaGetLastError()`` raises.

Each launch wrapper adds one to :data:`launch_counts` where it launches its
kernel, and nowhere else.
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

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("cim_read.cu", "flip.cuh")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

K1 = "cim_read_matmul_one4n"
K2 = "cim_read_matmul_raw"
launch_counts = {K1: 0, K2: 0}

_lib = None
build_log = ""


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cim_read: nvcc not found (needs the CUDA toolkit)")


def _source_hash() -> str:
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(build_dir: Path | None = None) -> Path:
    """Compile the kernels (if this source hash is not built yet) and return
    the shared library's path."""
    global build_log
    build_dir = Path(build_dir or BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / f"cim_read-{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "cim_read.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"cim_read: nvcc failed ({proc.returncode}):\n"
                           f"{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def load(build_dir: Path | None = None) -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build(build_dir)))
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.cim_read_one4n.argtypes = [vp, vp, vp, vp] + [i] * 16 + [u, u, vp, vp, i, vp]
    lib.cim_read_one4n.restype = i
    lib.cim_read_raw.argtypes = [vp] * 5 + [i] * 10 + [u, u, vp, i, vp]
    lib.cim_read_raw.restype = i
    _lib = lib
    return lib


def timed_build() -> float:
    """Build and load the kernels; the wall seconds it took."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def _check(rc: int, name: str) -> None:
    if rc == -1:
        raise ValueError(f"{name}: arguments outside what the kernel tiles")
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {rc}")


def _scalars_arg(scalars: np.ndarray):
    arr = np.ascontiguousarray(scalars, dtype=np.uint32)
    return arr, arr.ctypes.data_as(ctypes.c_void_p)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cim_read_matmul_one4n(x: torch.Tensor, man: torch.Tensor, cw: torch.Tensor,
                          scalars: np.ndarray, *, k_log: int, n_out: int,
                          n_group: int, row_weights: int, n_segments: int,
                          code_words: int, segment_bits: int, n_body: int,
                          r: int, payload_bits: int, word_masks: np.ndarray,
                          man_bits: int, exp_bits: int, bias: int,
                          store_g: int, store_j: int,
                          dynamic: bool) -> torch.Tensor:
    """x f32 [M, k_log] @ decode(man uint16 [K_pad, J_pad], cw int32
    [K_pad/n, J_pad/rw, S, W]) -> f32 [M, n_out] (K1). ``word_masks`` is
    uint32 [8]: the stored body bits of each codeword word, then body plus
    the overall parity bit."""
    lib = load()
    m = x.shape[0]
    k_pad, j_pad = man.shape
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    sc, sc_ptr = _scalars_arg(scalars)
    wm, wm_ptr = _scalars_arg(word_masks)
    rc = lib.cim_read_one4n(
        x.data_ptr(), man.data_ptr(), cw.data_ptr(), out.data_ptr(), m, k_log,
        k_pad, j_pad, n_out, n_group, row_weights, n_segments, code_words,
        segment_bits, n_body, r, payload_bits, man_bits, exp_bits, bias,
        store_g, store_j, wm_ptr, sc_ptr, int(dynamic), _stream(x))
    _check(rc, K1)
    launch_counts[K1] += 1
    del sc, wm
    return out


def cim_read_matmul_raw(x: torch.Tensor, man: torch.Tensor, exp: torch.Tensor,
                        signw: torch.Tensor, scalars: np.ndarray, *, k_log: int,
                        n_out: int, n_group: int, man_bits: int, exp_bits: int,
                        bias: int, store_k: int, store_j: int,
                        dynamic: bool) -> torch.Tensor:
    """x f32 [M, k_log] @ decode(man uint16 [K_pad, J_pad], exp uint8
    [K_pad/n, J_pad], signw int32 [ceil(K_pad/32), J_pad]) -> f32 [M, n_out]
    (K2)."""
    lib = load()
    m = x.shape[0]
    k_pad, j_pad = man.shape
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    sc, sc_ptr = _scalars_arg(scalars)
    rc = lib.cim_read_raw(
        x.data_ptr(), man.data_ptr(), exp.data_ptr(), signw.data_ptr(),
        out.data_ptr(), m, k_log, k_pad, j_pad, n_out, signw.shape[0], n_group,
        man_bits, exp_bits, bias, store_k, store_j, sc_ptr, int(dynamic),
        _stream(x))
    _check(rc, K2)
    launch_counts[K2] += 1
    del sc
    return out
