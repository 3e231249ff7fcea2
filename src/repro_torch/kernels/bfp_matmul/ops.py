"""Public wrappers of the block-FP matmul (port of
``repro/kernels/bfp_matmul/ops.py``).

The route follows the tensors' device: on a CUDA ``x`` with ``use_kernel``
the hand-written kernel K5 (:func:`kernel.bfp_matmul`) launches or raises;
it never falls back. A CPU ``x`` runs the plain version of :mod:`.ref`,
since no kernel runs on the CPU. ``info['used_kernel']`` is True only when
K5 launched.

The reference pads ragged M, K and N up to its TPU tiles before its kernel;
K5 masks its edges instead, so no padded copies are made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bfp_matmul import kernel as kernel_lib
from repro_torch.kernels.bfp_matmul.ref import (  # noqa: F401
    bfp_matmul_ref, dequant_ref, pack_bfp)


def _same_device(x: torch.Tensor, man: torch.Tensor, exp: torch.Tensor):
    if man.device != x.device or exp.device != x.device:
        raise ValueError(f"bfp_matmul: x on {x.device}, man on {man.device}, "
                         f"exp on {exp.device}; expected one device")


def bfp_matmul(x: torch.Tensor, man: torch.Tensor, exp: torch.Tensor, *,
               n_group: int = 8) -> torch.Tensor:
    """x [M, K] (f32 or bf16) @ dequant(man, exp) -> f32 [M, N]: K5 on the
    card, the plain version on the CPU."""
    _same_device(x, man, exp)
    if x.device.type == "cuda":
        return kernel_lib.bfp_matmul(x.contiguous(), man.contiguous(),
                                     exp.contiguous(), n_group=n_group)
    return bfp_matmul_ref(x, man, exp, n_group)


def cim_linear(x: torch.Tensor, man: torch.Tensor, exp: torch.Tensor, *,
               n_group: int = 8, use_kernel: bool = True,
               with_info: bool = False):
    """Linear layer on the BFP weight planes, ``x [..., K] -> [..., N]``
    (the serving-path integration point: no dequantized matrix in device
    memory on the kernel route). ``use_kernel=False`` runs the plain
    ``x @ dequant_ref(man, exp)``. Returns the output, or ``(out, info)``
    with ``with_info``."""
    _same_device(x, man, exp)
    b_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n_out = man.shape[1]
    used = use_kernel and x.device.type == "cuda"
    if used:
        out = bfp_matmul(x2, man, exp, n_group=n_group)
    else:
        out = x2.to(torch.float32) @ dequant_ref(man, exp, n_group)
    out = out.reshape(*b_shape, n_out)
    return (out, {"used_kernel": used}) if with_info else out
