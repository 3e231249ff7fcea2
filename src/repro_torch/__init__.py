"""PyTorch / CUDA port of the Unicorn-CIM reproduction.

Each module mirrors its counterpart under ``repro`` (``repro_torch/core/cim.py``
<-> ``repro/core/cim.py``) and is held against it by the ``tests/test_torch_*``
parity suite. The port imports ``torch`` and numpy only — never ``jax`` and
nothing of the ``repro`` package.

Integer planes keep their storage width (uint16 mantissas, uint8 exponents,
uint32 words held in ``torch.int32`` views). Arithmetic on them widens to
``int64`` and masks to 32 bits, because torch cannot shift or compare
``uint32`` tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); with no card they raise.
"""
