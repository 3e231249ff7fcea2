"""Plain PyTorch version of the fused decode-on-read matmul (port of
``repro/kernels/cim_read/ref.py``).

It states what kernels K1/K2 compute: draw the dynamic flips into the image
with :func:`repro_torch.core.cim.inject_with_seeds` (when ``scalars`` carry
nonzero thresholds), decode the whole matrix with :func:`cim.read`, then run
one fp32 matmul. The CPU tests run it in place of the kernels, and
``chip_smoke.py`` holds the kernels against it on the card.

A mesh shard's read draws at the shard's global coordinates through its
:class:`~repro_torch.core.cim.ShardInfo` (``inject_with_seeds`` honours it):
the offsets and global dims the kernels take from ``ops``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import cim as cim_lib

# uint32[9] scalar layout of the fused kernels (repro/kernels/cim_read/
# kernel.py SCALAR_*); thresholds of 0 mean "no flips".
SCALAR_THR_MAN = 0
SCALAR_THR_META = 1
SCALAR_SEED_MAN = 2
SCALAR_SEED_META = 3
SCALAR_SEED_CW = 4
SCALAR_OFF_K = 5
SCALAR_OFF_J = 6
SCALAR_M_THR = 7
SCALAR_M_LEN = 8


def scalar_seeds(scalars) -> dict:
    return {"man": int(scalars[SCALAR_SEED_MAN]),
            "meta": int(scalars[SCALAR_SEED_META]),
            "cw": int(scalars[SCALAR_SEED_CW])}


def cim_read_ref(x2: torch.Tensor, store, scalars=None, model=None):
    """x [M, K] @ decode(store [K, J]) -> ([M, J] f32, decode stats).

    ``model`` shapes the dynamic flips into a fault process. A drift
    model's time scaling is already folded into the ``scalars`` thresholds
    (``ops.cim_linear_store`` does it, as the reference's caller does), so
    its tick is zeroed here rather than applied twice."""
    if scalars is not None:
        if model is not None and model.kind == "drift" and model.tick:
            model = dataclasses.replace(model, tick=0)
        store = cim_lib.inject_with_seeds(
            store, scalar_seeds(scalars), int(scalars[SCALAR_THR_MAN]),
            int(scalars[SCALAR_THR_META]), model=model)
    w, stats = cim_lib.read(store)
    return x2.to(torch.float32) @ w, stats
