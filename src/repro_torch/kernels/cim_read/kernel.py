"""Bind the hand-written CUDA kernels of ``csrc/cim_read.cu``.

The library is built at first use by :class:`repro_torch.kernels.nvcc.
CudaLibrary` (nvcc, ``sm_90a``, into the git-ignored ``build/repro_torch/``).
A refused argument set or a non-zero ``cudaGetLastError()`` raises.

``store_j`` / ``store_g`` / ``store_k`` are the padded dims of the image
the planes were cut from (a mesh shard's global image, else the planes'
own): the kernels compute each dynamic draw's element index against them,
at the shard offsets in the scalars' ``OFF_K`` / ``OFF_J`` slots.

Each launch wrapper adds one to :data:`launch_counts` where it launches its
kernel, and nowhere else; each of K1's and K2's two kernels (the narrow one
for M <= 8, the tile above it) counts under its function's name.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.fault_inject.kernel import MODEL_AXES, MODEL_KINDS
from repro_torch.kernels.nvcc import CudaLibrary, check_rc, stream_of

CSRC = Path(__file__).resolve().parent / "csrc"

K1 = "cim_read_matmul_one4n"
K2 = "cim_read_matmul_raw"
launch_counts = {K1: 0, K2: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.cim_read_one4n.argtypes = [vp, vp, vp, vp] + [i] * 16 \
        + [u, u, vp, vp, i, i, i, vp]
    lib.cim_read_one4n.restype = i
    lib.cim_read_one4n_narrow.argtypes = [vp, vp, vp, vp] + [i] * 17 \
        + [u, u, vp, vp, i, i, i, vp]
    lib.cim_read_one4n_narrow.restype = i
    lib.cim_read_raw.argtypes = [vp] * 5 + [i] * 10 + [u, u, vp, i, i, i, vp]
    lib.cim_read_raw.restype = i
    lib.cim_read_raw_narrow.argtypes = [vp] * 5 + [i] * 12 \
        + [u, u, vp, i, i, i, vp]
    lib.cim_read_raw_narrow.restype = i


LIBRARY = CudaLibrary(CSRC / "cim_read.cu", _bind)
load = LIBRARY.load
timed_build = LIBRARY.timed_build


def _scalars_arg(scalars: np.ndarray):
    arr = np.ascontiguousarray(scalars, dtype=np.uint32)
    return arr, arr.ctypes.data_as(ctypes.c_void_p)


def _model_args(model_kind: str, model_axis: str) -> tuple:
    """The kernels' fault-process codes: kind 0 (i.i.d.; drift, whose
    thresholds come pre-scaled), 1 burst, 2 correlated; axis 0 row, 1 col,
    2 bank."""
    return MODEL_KINDS[model_kind], MODEL_AXES[model_axis]


def cim_read_matmul_one4n(x: torch.Tensor, man: torch.Tensor, cw: torch.Tensor,
                          scalars: np.ndarray, *, k_log: int, n_out: int,
                          n_group: int, row_weights: int, n_segments: int,
                          code_words: int, segment_bits: int, n_body: int,
                          r: int, payload_bits: int, word_masks: np.ndarray,
                          man_bits: int, exp_bits: int, bias: int,
                          store_g: int, store_j: int, dynamic: bool,
                          model_kind: str = "iid",
                          model_axis: str = "row") -> torch.Tensor:
    """x f32 [M, k_log] @ decode(man uint16 [K_pad, J_pad], cw int32
    [K_pad/n, J_pad/rw, S, W]) -> f32 [M, n_out] (K1). ``word_masks`` is
    uint32 [8]: the stored body bits of each codeword word, then body plus
    the overall parity bit. ``model_kind``/``model_axis`` name the fault
    process of a dynamic read (its parameters ride in ``scalars``)."""
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
        store_g, store_j, wm_ptr, sc_ptr, int(dynamic),
        *_model_args(model_kind, model_axis), stream_of(x))
    check_rc(rc, K1)
    launch_counts[K1] += 1
    del sc, wm
    return out


def cim_read_matmul_one4n_narrow(x: torch.Tensor, man: torch.Tensor,
                                 cw: torch.Tensor, scalars: np.ndarray, *,
                                 k_log: int, n_out: int, n_group: int,
                                 row_weights: int, n_segments: int,
                                 code_words: int, segment_bits: int,
                                 n_body: int, r: int, tables: np.ndarray,
                                 man_bits: int, exp_bits: int, bias: int,
                                 x_slab: int, smem_bytes: int, store_g: int,
                                 store_j: int, dynamic: bool,
                                 model_kind: str = "iid",
                                 model_axis: str = "row") -> torch.Tensor:
    """K1's narrow kernel, for M <= 8: the same function as
    :func:`cim_read_matmul_one4n`. ``tables`` is uint32 [36]: the codeword
    words' body masks [4], stored-bit masks [4] and syndrome column masks
    [7, 4]; ``x_slab`` and ``smem_bytes`` are the geometry of
    ``ops.resolve_tiles``, which the library checks."""
    lib = load()
    m = x.shape[0]
    k_pad, j_pad = man.shape
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    sc, sc_ptr = _scalars_arg(scalars)
    tb, tb_ptr = _scalars_arg(tables)
    rc = lib.cim_read_one4n_narrow(
        x.data_ptr(), man.data_ptr(), cw.data_ptr(), out.data_ptr(), m, k_log,
        k_pad, j_pad, n_out, n_group, row_weights, n_segments, code_words,
        segment_bits, n_body, r, man_bits, exp_bits, bias, x_slab, smem_bytes,
        store_g, store_j, tb_ptr, sc_ptr, int(dynamic),
        *_model_args(model_kind, model_axis), stream_of(x))
    check_rc(rc, K1)
    launch_counts[K1] += 1
    del sc, tb
    return out


def cim_read_matmul_raw(x: torch.Tensor, man: torch.Tensor, exp: torch.Tensor,
                        signw: torch.Tensor, scalars: np.ndarray, *, k_log: int,
                        n_out: int, n_group: int, man_bits: int, exp_bits: int,
                        bias: int, store_k: int, store_j: int,
                        dynamic: bool, model_kind: str = "iid",
                        model_axis: str = "row") -> torch.Tensor:
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
        *_model_args(model_kind, model_axis), stream_of(x))
    check_rc(rc, K2)
    launch_counts[K2] += 1
    del sc
    return out


def cim_read_matmul_raw_narrow(x: torch.Tensor, man: torch.Tensor,
                               exp: torch.Tensor, signw: torch.Tensor,
                               scalars: np.ndarray, *, k_log: int, n_out: int,
                               n_group: int, man_bits: int, exp_bits: int,
                               bias: int, x_slab: int, smem_bytes: int,
                               store_k: int, store_j: int, dynamic: bool,
                               model_kind: str = "iid",
                               model_axis: str = "row") -> torch.Tensor:
    """K2's narrow kernel, for M <= 8: the same function as
    :func:`cim_read_matmul_raw`. ``x_slab`` and ``smem_bytes`` are the
    geometry of ``ops.resolve_tiles``, which the library checks."""
    lib = load()
    m = x.shape[0]
    k_pad, j_pad = man.shape
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    sc, sc_ptr = _scalars_arg(scalars)
    rc = lib.cim_read_raw_narrow(
        x.data_ptr(), man.data_ptr(), exp.data_ptr(), signw.data_ptr(),
        out.data_ptr(), m, k_log, k_pad, j_pad, n_out, signw.shape[0], n_group,
        man_bits, exp_bits, bias, x_slab, smem_bytes, store_k, store_j, sc_ptr,
        int(dynamic), *_model_args(model_kind, model_axis), stream_of(x))
    check_rc(rc, K2)
    launch_counts[K2] += 1
    del sc
    return out
