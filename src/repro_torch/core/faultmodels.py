"""Fault-model zoo (port of ``repro/core/faultmodels.py``): structured error
processes over the counter-PRNG streams.

Every injection path draws i.i.d. Bernoulli flips from the counter PRNG: bit
``p`` of the word at C-order flat index ``e`` flips iff
``murmur3(e*32 + p XOR seed*GOLD) < threshold``. A :class:`FaultProcess`
compiles to a per-element uint32 threshold derived from the GLOBAL C-order
element index of the packed plane:

    ==========  ===========================================================
    kind        compiled threshold at element ``e``
    ==========  ===========================================================
    iid         ``thr`` unchanged: the legacy streams, bit for bit
    burst       ``thr`` where the element's row / column / bank *unit* draws
                a Bernoulli hit at ``rate`` (one draw per aligned run of
                ``length`` units), else 0
    correlated  ``thr`` scaled per macro-column group by a hash-derived
                factor in ``[1-strength, 1]`` (Q16 fixed point, exact uint32
                arithmetic)
    drift       ``thr * (1+drift_rate)**tick`` (element-independent; serving
                keys ``tick`` on the request-local read position)
    ==========  ===========================================================

The compiled threshold is a pure function of (plane seed, process, global
element index), so the plain routes here and the CUDA kernels K1-K3, which
compute it themselves, draw the same masks. Scaled thresholds never exceed
the i.i.d. one (burst zeroes, the correlated factor is <= 1): a process's
flip set is a subset of the i.i.d. flip set at the same (seed, threshold).

Words follow the port's CPU rule: Python ints or ``int64`` tensors holding
uint32 values, every product masked back to 32 bits.

The drift scale is the correctly rounded float32 of ``(1 + rate) ** tick``
(a float64 power rounded once); the reference's float32 ``jnp.power`` is off
by one float32 ulp at a few (rate, tick) points, where its threshold and
this one can differ (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.fault_inject.ref import hash_u32

VALID_KINDS = ("iid", "burst", "correlated", "drift")
VALID_AXES = ("row", "col", "bank")

M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
# Salt folding a plane seed into the burst/correlated *unit* stream, so unit
# hit decisions never alias the per-bit flip stream of the same seed (the
# cim.fold_seed chain extended sideways).
MODEL_SEED_SALT = 0x0DD5EED5
# threshold saturation (as ber_to_threshold): values at or above this map to
# the all-ones threshold
_THR_SAT = np.float32(4294967040.0)


@dataclasses.dataclass(frozen=True)
class FaultProcess:
    """One error process of the zoo (hashable; unused fields are ignored per
    kind).

    * ``rate`` - burst: fraction of units hit (Bernoulli per aligned run).
    * ``length`` - burst: units per aligned run (``axis='bank'``: a
      ``length x length`` tile).
    * ``axis`` - burst alignment: ``row``, ``col`` or ``bank``.
    * ``strength`` - correlated: per-column scaling spread in ``[0, 1]``.
    * ``period`` - correlated: macro column groups per probability draw.
    * ``drift_rate`` - drift: per-tick multiplicative BER growth.
    * ``tick`` - drift: logical time of a *static* injection (serving reads
      fold their read position into the thresholds and keep it at 0).
    """

    kind: str = "iid"
    rate: float = 0.25
    length: int = 4
    axis: str = "row"
    strength: float = 0.5
    period: int = 1
    drift_rate: float = 0.02
    tick: int = 0

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"FaultProcess: kind={self.kind!r} is not valid; "
                             f"expected one of {', '.join(VALID_KINDS)}")
        if self.axis not in VALID_AXES:
            raise ValueError(f"FaultProcess: axis={self.axis!r} is not valid; "
                             f"expected one of {', '.join(VALID_AXES)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"FaultProcess: rate must be in [0, 1], "
                             f"got {self.rate}")
        if not 0.0 <= self.strength <= 1.0:
            raise ValueError(f"FaultProcess: strength must be in [0, 1], "
                             f"got {self.strength}")
        if self.length < 1 or self.period < 1:
            raise ValueError("FaultProcess: length and period must be >= 1")
        if self.drift_rate < 0 or self.tick < 0:
            raise ValueError("FaultProcess: drift_rate and tick must be >= 0")

    @classmethod
    def iid(cls) -> "FaultProcess":
        return cls()

    @classmethod
    def burst(cls, rate: float = 0.25, length: int = 4,
              axis: str = "row") -> "FaultProcess":
        return cls(kind="burst", rate=rate, length=length, axis=axis)

    @classmethod
    def correlated(cls, strength: float = 0.5,
                   period: int = 1) -> "FaultProcess":
        return cls(kind="correlated", strength=strength, period=period)

    @classmethod
    def drift(cls, drift_rate: float = 0.02, tick: int = 0) -> "FaultProcess":
        return cls(kind="drift", drift_rate=drift_rate, tick=tick)


def parse_fault_model(spec) -> Optional[FaultProcess]:
    """CLI/policy grammar -> :class:`FaultProcess` (``None``/'' -> ``None``).

    ``'burst'`` takes the kind's defaults; ``'burst:rate=0.3,length=8,
    axis=col'`` overrides fields (floats/ints coerced per field)."""
    if spec is None or isinstance(spec, FaultProcess):
        return spec
    spec = str(spec).strip()
    if not spec:
        return None
    kind, _, rest = spec.partition(":")
    if kind not in VALID_KINDS:
        raise ValueError(f"unknown fault model {kind!r}; expected one of "
                         f"{', '.join(VALID_KINDS)}")
    kw = {"kind": kind}
    if rest:
        fields = {f.name: f.type for f in dataclasses.fields(FaultProcess)}
        for part in rest.split(","):
            name, _, val = part.partition("=")
            name = name.strip()
            if name not in fields or name == "kind":
                raise ValueError(f"fault model {kind!r}: unknown parameter "
                                 f"{name!r}")
            kw[name] = (val.strip() if fields[name] == "str"
                        else int(val) if fields[name] == "int"
                        else float(val))
    return FaultProcess(**kw)


# ---------------------------------------------------------------------------
# Compilation: process -> (kernel scalar payload, per-element thresholds).
# ---------------------------------------------------------------------------


def model_scalars(model: Optional[FaultProcess]):
    """The kernels' ``(m_thr, m_len)`` payload of a process, as ints:
    ``burst``: (hit threshold of ``rate``, run ``length``); ``correlated``:
    (Q16 ``strength``, ``period``); ``iid``/``drift``: (0, 0)."""
    if model is None or model.kind in ("iid", "drift"):
        return 0, 0
    if model.kind == "burst":
        from repro_torch.kernels.fault_inject.ops import ber_to_threshold
        return ber_to_threshold(model.rate), int(model.length)
    q16 = max(0, min(65536, int(round(model.strength * 65536.0))))
    return q16, int(model.period)


def plane_geometry(shape) -> tuple:
    """``(width, col_div)`` of a packed plane's C-order layout: flat elements
    per logical row, and the divisor taking an intra-row offset to its
    macro-column unit. A 2-D plane ``[R, C]`` addresses columns directly;
    the 4-D One4N codeword plane ``[B, G, S, W]`` has ``G*S*W`` words a
    block row and ``S*W`` words a column group."""
    if len(shape) == 4:
        return (int(shape[1]) * int(shape[2]) * int(shape[3]),
                int(shape[2]) * int(shape[3]))
    return int(shape[-1]), 1


def unit_seed(plane_seed):
    """The burst/correlated unit-decision seed of a plane seed (an int or an
    int64 tensor of uint32 values)."""
    salt = (MODEL_SEED_SALT * 0x85EBCA6B + _GOLD) & M32
    return hash_u32((plane_seed & M32) ^ salt)


def scale_elem_thresholds(elem, threshold, plane_seed, *, kind: str,
                          axis: str, m_thr, m_len, width: int,
                          col_div: int = 1):
    """Per-element flip thresholds of a compiled burst/correlated process.

    ``elem`` holds GLOBAL C-order flat element indices (an int64 tensor of
    any shape); ``threshold`` and ``plane_seed`` are ints or tensors that
    broadcast against it (the trial-batched plain version passes a seed per
    trial). Returns an int64 tensor of uint32 thresholds; ``iid``/``drift``
    return ``threshold`` as given."""
    if kind in ("iid", "drift"):
        return threshold
    elem = elem & M32
    m_thr, m_len = int(m_thr) & M32, int(m_len) & M32
    useed = (unit_seed(plane_seed) * _GOLD) & M32
    threshold = threshold & M32
    row = elem // width
    col = (elem % width) // col_div
    if kind == "burst":
        if axis == "row":
            unit = row // m_len
        elif axis == "col":
            unit = col // m_len
        else:  # bank: length x length tiles, mixed into one unit index
            unit = ((row // m_len) * 0x10001 + col // m_len) & M32
        hit = hash_u32(unit ^ useed) < m_thr
        return torch.where(hit, torch.as_tensor(threshold, dtype=torch.int64,
                                                device=elem.device),
                           torch.zeros((), dtype=torch.int64,
                                       device=elem.device))
    # correlated: scale by s/65536 with s = 65536 - strength_q16 * h16 / 65536
    # drawn per column group; the split multiply keeps every intermediate
    # below 2^32 and gives `threshold` exactly at strength 0 (s = 65536)
    grp = col // m_len
    h16 = hash_u32(grp ^ useed) >> 16
    var = (m_thr * h16) >> 16                          # [0, 65536)
    s = 65536 - var                                    # (0, 65536]
    hi = (threshold >> 16) * s
    lo = ((threshold & 0xFFFF) * s) >> 16
    return (hi + lo) & M32


def drift_scale(drift_rate: float, tick: int) -> np.float32:
    """``(1 + drift_rate) ** tick`` in float32, correctly rounded: the base
    is the float32 sum, the power a float64 power rounded once (``inf``
    past the float32 range)."""
    base = float(np.float32(1.0) + np.float32(drift_rate))
    try:
        scale = base ** int(tick)
    except OverflowError:
        scale = math.inf
    with np.errstate(over="ignore"):
        return np.float32(scale)


def drift_threshold(threshold, drift_rate, tick) -> int:
    """Drift time scaling ``thr * (1+drift_rate)**tick``: the float32
    product of the float32 threshold and :func:`drift_scale`, saturating to
    0xFFFFFFFF like ``ber_to_threshold``, else truncated. A zero threshold
    stays zero."""
    threshold = int(threshold) & M32
    if threshold == 0:
        return 0
    with np.errstate(over="ignore"):
        scaled = np.float32(threshold) * drift_scale(drift_rate, tick)
    if scaled >= _THR_SAT:
        return M32
    return int(scaled)


def compiled_threshold(model: Optional[FaultProcess], threshold,
                       tick=None) -> int:
    """The element-independent part of a process: drift's time scaling
    (identity for every other kind). ``tick=None`` uses the model's static
    tick; serving passes the read position. A tick of 0 is the identity (no
    float32 round trip), so drift at tick 0 draws the i.i.d. streams."""
    if model is None or model.kind != "drift":
        return int(threshold) & M32
    t = model.tick if tick is None else int(tick)
    if t == 0:
        return int(threshold) & M32
    return drift_threshold(threshold, model.drift_rate, t)


def plane_thresholds(model: Optional[FaultProcess], threshold, elem,
                     plane_seed, shape):
    """Full compile of ``model`` for one packed plane of ``shape``: drift's
    time scaling, then the burst/correlated mask at global indices ``elem``.
    For a mesh shard ``elem`` and ``shape`` are its image's (the global
    C-order indices and plane shape), so its masks are the single-device
    image's block. ``model=None`` / ``iid`` return ``threshold`` as an
    int."""
    if model is None or model.kind == "iid":
        return int(threshold) & M32
    threshold = compiled_threshold(model, threshold)
    if model.kind == "drift":
        return threshold
    m_thr, m_len = model_scalars(model)
    width, col_div = plane_geometry(shape)
    return scale_elem_thresholds(elem, threshold, plane_seed,
                                 kind=model.kind, axis=model.axis,
                                 m_thr=m_thr, m_len=m_len, width=width,
                                 col_div=col_div)

