"""Bind the hand-written CUDA block-FP matmul of ``csrc/bfp_matmul.cu``
(port of ``repro/kernels/bfp_matmul/kernel.py``).

K5 :func:`bfp_matmul` replaces ``bfp_matmul_pallas``: ``x [M, K]`` (fp32 or
bf16) @ the block-FP weights of ``man`` uint16 [K, N] and ``exp`` uint8
[K/n_group, N] -> f32 [M, N]. The kernel masks ragged edges itself, so any
M, K and N are taken (K a multiple of ``n_group``); M <= 8 runs the narrow,
bytes-bound variant, larger M the 128 x 128 tile on the TF32 tensor cores
(x split into two TF32 parts, :func:`.ref.split_tf32`, for fp32 accuracy).

The library is built at first use by :class:`repro_torch.kernels.nvcc.
CudaLibrary`. The wrapper takes CUDA tensors only (the CPU goes to
:mod:`.ref` through :mod:`.ops`), raises on what the kernel does not take,
and adds one to :data:`launch_counts` where it launches its kernel, and
nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import CudaLibrary, check_rc, stream_of

CSRC = Path(__file__).resolve().parent / "csrc"

K5 = "bfp_matmul"
launch_counts = {K5: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bfp_matmul.argtypes = [vp, i, vp, vp, vp, i, i, i, i, vp]
    lib.bfp_matmul.restype = i


LIBRARY = CudaLibrary(CSRC / "bfp_matmul.cu", _bind)
load = LIBRARY.load
timed_build = LIBRARY.timed_build


def bfp_matmul(x: torch.Tensor, man: torch.Tensor, exp: torch.Tensor, *,
               n_group: int) -> torch.Tensor:
    """x [M, K] @ dequant(man [K, N], exp [K/n_group, N]) -> f32 [M, N]."""
    if x.ndim != 2 or man.ndim != 2 or exp.ndim != 2:
        raise ValueError("bfp_matmul: x, man and exp must be 2-D")
    m, k = x.shape
    k2, n = man.shape
    if k != k2 or k % n_group or tuple(exp.shape) != (k // n_group, n):
        raise ValueError(f"bfp_matmul: shapes x {tuple(x.shape)}, man "
                         f"{tuple(man.shape)}, exp {tuple(exp.shape)} do not "
                         f"fit n_group={n_group}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            man.dtype != torch.uint16 or exp.dtype != torch.uint8:
        raise ValueError(f"bfp_matmul: dtypes x {x.dtype}, man {man.dtype}, "
                         f"exp {exp.dtype}; expected f32/bf16, uint16, uint8")
    for name, t in (("x", x), ("man", man), ("exp", exp)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"bfp_matmul: {name} is on {t.device}; the "
                             f"kernel takes tensors on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"bfp_matmul: {name} must be contiguous")
    lib = load()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = lib.bfp_matmul(x.data_ptr(), int(x.dtype == torch.bfloat16),
                        man.data_ptr(), exp.data_ptr(), out.data_ptr(), m, k,
                        n, n_group, stream_of(x))
    check_rc(rc, K5)
    launch_counts[K5] += 1
    return out
