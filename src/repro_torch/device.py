"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A ``cuda`` request with no card raises — the
    port never falls back to the CPU on its own; the caller asks for it with
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA device requested but torch.cuda is not "
                "available; pass device='cpu' to run the plain versions")
        # float32 stays float32: TF32 would round matmul and convolution
        # inputs to 10 mantissa bits, far outside the fp32 tolerances the
        # port is held to against the JAX reference.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):   # meta: shapes, no storage
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
