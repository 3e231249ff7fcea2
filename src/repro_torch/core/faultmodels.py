"""Fault processes (port of ``repro/core/faultmodels.py``, i.i.d. only).

This slice ports the default i.i.d. process, whose compiled threshold is the
field threshold unchanged. Burst, correlated and drift wait for ROADMAP
Queue 1 item 2; naming one raises ``NotImplementedError`` rather than serving
i.i.d. streams in its place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

VALID_KINDS = ("iid", "burst", "correlated", "drift")

_NOT_PORTED = ("fault model {kind!r} is not ported yet (ROADMAP Queue 1 "
               "item 2: this slice serves the i.i.d. process only)")


@dataclasses.dataclass(frozen=True)
class FaultProcess:
    """One error process; only ``kind='iid'`` is constructible here."""

    kind: str = "iid"

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"FaultProcess: kind={self.kind!r} is not valid; "
                             f"expected one of {', '.join(VALID_KINDS)}")
        if self.kind != "iid":
            raise NotImplementedError(_NOT_PORTED.format(kind=self.kind))


def parse_fault_model(spec) -> Optional[FaultProcess]:
    """CLI/policy grammar -> :class:`FaultProcess` (``None``/'' -> ``None``)."""
    if spec is None or isinstance(spec, FaultProcess):
        return spec
    spec = str(spec).strip()
    if not spec:
        return None
    kind, _, rest = spec.partition(":")
    if kind not in VALID_KINDS:
        raise ValueError(f"unknown fault model {kind!r}; expected one of "
                         f"{', '.join(VALID_KINDS)}")
    if kind != "iid" or rest:
        raise NotImplementedError(_NOT_PORTED.format(kind=spec))
    return FaultProcess()


def check_iid(model) -> None:
    """Raise unless ``model`` is ``None`` or the i.i.d. process."""
    model = parse_fault_model(model)
    if model is not None and model.kind != "iid":
        raise NotImplementedError(_NOT_PORTED.format(kind=model.kind))


def model_scalars(model):
    """The kernel's ``(m_thr, m_len)`` payload: (0, 0) for i.i.d."""
    check_iid(model)
    return 0, 0


def compiled_threshold(model, threshold, tick=None) -> int:
    """Element-independent threshold: the identity for i.i.d."""
    check_iid(model)
    return int(threshold)


def plane_thresholds(model, threshold, elem, plane_seed, shape) -> int:
    """Per-element thresholds of one plane: the field threshold for i.i.d."""
    check_iid(model)
    return int(threshold)
