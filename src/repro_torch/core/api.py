"""Framework-level reliability configuration (port of ``repro/core/api.py``).

:class:`ReliabilityConfig` is carried by every training run (``RunConfig.
rel``): it switches the frozen-exponent projection of the optimizer
(``mode='align'`` and ``'cim'``) and names the deployment a run is packed
into. It is a thin single-rule policy factory: ``.policy`` compiles it into a
uniform :class:`~repro_torch.core.deployment.ReliabilityPolicy`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.align import AlignmentConfig
from repro_torch.core.bitops import FORMAT_NAMES, get_format
from repro_torch.core.cim import CIMConfig

# the fault fields: the packed image's cell classes plus the Fig. 2
# characterization axes
_FAULT_FIELDS = ("full", "mantissa", "exponent_sign", "sign", "exponent")


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """mode: 'off' (vanilla training), 'align' (exponent-aligned weights and
    frozen-exponent fine-tuning), 'cim' ('align' plus the emulated SRAM
    image with fault injection and optional One4N ECC)."""

    mode: str = "off"
    n_group: int = 8
    index: int = 2
    protect: str = "one4n"
    ber: float = 0.0
    field: str = "full"
    inject: str = "dynamic"
    fmt_name: str = "fp16"
    serve_path: str = "fused"
    policy_override: Optional[object] = None   # a full ReliabilityPolicy

    def __post_init__(self):
        from repro_torch.core import deployment as dep_lib
        where = "ReliabilityConfig"
        dep_lib.check_enum("mode", self.mode, dep_lib.VALID_MODES, where)
        dep_lib.check_enum("protect", self.protect, dep_lib.VALID_PROTECTS,
                           where)
        dep_lib.check_enum("field", self.field, _FAULT_FIELDS, where)
        dep_lib.check_enum("inject", self.inject, dep_lib.VALID_INJECTS, where)
        dep_lib.check_enum("serve_path", self.serve_path,
                           dep_lib.VALID_SERVE_PATHS, where)
        dep_lib.check_enum("fmt_name", self.fmt_name, FORMAT_NAMES, where)
        if self.ber < 0:
            raise ValueError(f"{where}: ber must be >= 0, got {self.ber}")
        if self.policy_override is not None and \
                not isinstance(self.policy_override, dep_lib.ReliabilityPolicy):
            raise TypeError(f"{where}: policy_override must be a "
                            f"ReliabilityPolicy, got "
                            f"{type(self.policy_override).__name__}")

    @classmethod
    def from_policy(cls, policy, ber: float = 0.0,
                    inject: str = "dynamic") -> "ReliabilityConfig":
        """Compile a :class:`ReliabilityPolicy` into a config. The mode is
        always ``'cim'`` (also for a fault-free align run at ber 0, so that
        the run's result carries a deployment). A uniform policy whose
        default rule has legacy semantics (``field='full'``, ``ber_scale=1``)
        maps onto the scalar fields; any other rides in
        ``policy_override``."""
        from repro_torch.core import deployment as dep_lib
        if not isinstance(policy, dep_lib.ReliabilityPolicy):
            raise TypeError(f"from_policy: expected ReliabilityPolicy, got "
                            f"{type(policy).__name__}")
        d = policy.default
        legacy = policy.uniform and d.field == "full" and d.ber_scale == 1.0
        return cls(mode="cim", n_group=d.n_group, index=d.index,
                   protect=d.protect, ber=ber, field=d.field, inject=inject,
                   fmt_name=d.fmt_name, serve_path=d.serve_path,
                   policy_override=None if legacy else policy)

    @property
    def fmt(self):
        return get_format(self.fmt_name)

    @property
    def align_cfg(self) -> AlignmentConfig:
        return AlignmentConfig(n_group=self.n_group, index=self.index,
                               fmt=self.fmt)

    @property
    def cim_cfg(self) -> CIMConfig:
        return CIMConfig(n_group=self.n_group, index=self.index,
                         protect=self.protect, fmt=self.fmt)

    @property
    def policy(self):
        """``policy_override`` when set, else the uniform single-rule policy
        of the scalar fields. A Fig. 2 axis ('sign' / 'exponent') maps to
        the 'exponent_sign' cell class, where sign and exponent cells are
        stored together."""
        from repro_torch.core import deployment as dep_lib
        if self.policy_override is not None:
            return self.policy_override
        field = self.field if field_is_cell_class(self.field) \
            else "exponent_sign"
        rule = dep_lib.PolicyRule(
            pattern="*", deploy=True, protect=self.protect, field=field,
            n_group=self.n_group, index=self.index, fmt_name=self.fmt_name,
            serve_path=self.serve_path)
        return dep_lib.ReliabilityPolicy(rules=(), default=rule)

    @property
    def residual_exp_ber(self) -> float:
        """Closed-form post-ECC exponent/sign BER of the active codec (the
        training fault schedule's rate for that field; the raw BER when
        unprotected)."""
        from repro_torch.core import deployment as dep_lib
        return dep_lib._residual_ber(self.ber, self)

    def enabled(self) -> bool:
        return self.mode != "off"


def field_is_cell_class(field: str) -> bool:
    """Whether ``field`` names a stored-cell class of the packed image rather
    than a Fig. 2 characterization axis."""
    from repro_torch.core import deployment as dep_lib
    return field in dep_lib.VALID_FIELDS
