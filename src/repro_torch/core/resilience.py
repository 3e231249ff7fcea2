"""Resilience characterization entry points (port of
``repro/core/resilience.py``, paper §III-A / Fig. 2 / Fig. 6).

``characterize_fields`` / ``characterize_protection`` are thin wrappers over
:class:`repro_torch.core.sweep.SweepEngine`, which draws every (BER, trial)
fault plane of an arm through the trial-batched CUDA kernel K3 and then
evaluates the trials. They run on ``cuda`` unless the caller passes
``device="cpu"``.

``seeds`` replaces the reference's ``jax.random`` key: an int (expanded by
:func:`repro_torch.core.sweep.default_seeds`) or uint32 ``[arms, BERs,
trials]`` seeds, arms in plan order; the reference's seeds are
``jax.random.bits(sub, (B, T), uint32)`` after one ``split`` per arm.

``characterize_policies`` sweeps per-layer reliability policies
(:meth:`SweepEngine.run_policies`, K3 again) and ``search_policies`` runs
the co-design policy search over them (:class:`repro_torch.training.
codesign.PolicySearch`). The ``*_loop`` harnesses draw ``jax.random`` and
wait with the ``xla`` backend (item 8).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from repro_torch.core import cim as cim_lib
from repro_torch.core import sweep as sweep_lib
from repro_torch.core.bitops import FP16
from repro_torch.core.sweep import SweepResult  # noqa: F401  (re-export)


def characterize_fields(seeds, params, eval_fn: Callable,
                        bers: Sequence[float],
                        fields: Sequence[str] = ("sign", "exponent",
                                                 "mantissa", "full"),
                        n_trials: int = 10, fmt=FP16,
                        engine: Optional[sweep_lib.SweepEngine] = None,
                        fault_models: Sequence[str] = ("iid",), *,
                        device=None) -> List[SweepResult]:
    """Fig. 2: per-field sensitivity of plain FP weights (static injection).

    ``params`` is a ``{path: tensor}`` tree; ``eval_fn(params) -> accuracy``.
    A prebuilt ``engine`` must describe the same grid as the explicit
    arguments."""
    if engine is None:
        plan = sweep_lib.SweepPlan(bers=tuple(bers), n_trials=n_trials,
                                   fields=tuple(fields), fmt=fmt,
                                   fault_models=tuple(fault_models))
        engine = sweep_lib.SweepEngine(plan, device=device)
    else:
        _check_engine_grid(engine, bers=tuple(float(b) for b in bers),
                           n_trials=n_trials, fields=tuple(fields), fmt=fmt,
                           fault_models=tuple(str(m) for m in fault_models))
    return engine.run_fields(seeds, params, eval_fn)


def characterize_protection(seeds, params, eval_fn: Callable,
                            bers: Sequence[float],
                            cim_cfg: Optional[cim_lib.CIMConfig] = None,
                            n_trials: int = 10,
                            protects: Sequence[str] = ("none", "one4n"),
                            engine: Optional[sweep_lib.SweepEngine] = None,
                            fault_models: Sequence[str] = ("iid",), *,
                            device=None) -> List[SweepResult]:
    """Fig. 6: accuracy vs BER with/without One4N (optionally also the
    Table III per-weight SECDED arm) on the CIM deployment."""
    if engine is None:
        plan = sweep_lib.SweepPlan(bers=tuple(bers), n_trials=n_trials,
                                   protects=tuple(protects),
                                   fault_models=tuple(fault_models))
        engine = sweep_lib.SweepEngine(plan, device=device)
    else:
        _check_engine_grid(engine, bers=tuple(float(b) for b in bers),
                           n_trials=n_trials, protects=tuple(protects),
                           fault_models=tuple(str(m) for m in fault_models))
    return engine.run_protection(seeds, params, eval_fn, cim_cfg)


def characterize_policies(seeds, params, eval_fn: Callable,
                          bers: Sequence[float], policies, n_trials: int = 10,
                          engine: Optional[sweep_lib.SweepEngine] = None, *,
                          device=None) -> List[SweepResult]:
    """Fig. 6 arms as per-layer reliability POLICIES (mixed protection).

    ``policies`` is a dict or sequence of ``(name, ReliabilityPolicy)``:
    each arm deploys the whole tree under its policy and sweeps the (BER x
    trial) plane; ``results[i].protect`` carries the arm name. ``seeds`` is
    an int or the explicit plane seeds of
    :meth:`SweepEngine.run_policies`."""
    if engine is None:
        plan = sweep_lib.SweepPlan(bers=tuple(bers), n_trials=n_trials)
        engine = sweep_lib.SweepEngine(plan, device=device)
    else:
        _check_engine_grid(engine, bers=tuple(float(b) for b in bers),
                           n_trials=n_trials)
    return engine.run_policies(seeds, params, eval_fn, policies)


def search_policies(params, eval_fn: Callable, ber: float, groups,
                    max_drop: float = 0.02, n_trials: int = 3, seeds=0, *,
                    device=None, **space_kw):
    """One-call co-design policy search: the cheapest per-layer protection
    (by deployed ``stored_bits``) whose mean accuracy at ``ber`` stays
    within ``max_drop`` of clean. ``groups`` is the ordered ``(name,
    pattern)`` grammar of :class:`repro_torch.training.codesign.
    SearchSpace`; extra kwargs (``protects``, ``fields``, ``n_groups``,
    ``default``) refine the grid; ``seeds`` (an int) replaces the
    reference's ``key``. Returns a :class:`~repro_torch.training.codesign.
    SearchResult`."""
    from repro_torch.training.codesign import (AccuracySLO, PolicySearch,
                                               SearchSpace)
    space = SearchSpace(groups=tuple(groups), **space_kw)
    slo = AccuracySLO(ber=ber, max_drop=max_drop)
    return PolicySearch(params, eval_fn, slo, space, n_trials=n_trials,
                        seeds=seeds, device=device).search()


def _check_engine_grid(engine: sweep_lib.SweepEngine, **expected) -> None:
    """A prebuilt engine runs ITS plan's grid — refuse silently diverging
    explicit arguments instead of ignoring them."""
    for name, want in expected.items():
        got = getattr(engine.plan, name)
        if got != want:
            raise ValueError(
                f"engine.plan.{name}={got!r} conflicts with explicit "
                f"argument {name}={want!r}; build the engine from a matching "
                f"SweepPlan or drop the explicit argument")
