"""Online ECC scrubbing: a self-healing loop over the serving engine (port
of ``repro/launch/scrub.py``).

Soft errors accumulate in the SRAM image between deployments: under a drift
process (:mod:`repro_torch.core.faultmodels`) the BER grows with time, and a
double-bit error stays until the image is rewritten. A scrub reads every
word of a store through its ECC decoder and packs the decoded weights back
into a fresh image, turning correctable errors into clean cells before a
second hit makes them uncorrectable.

* :class:`ScrubPolicy`: when to scrub. A per-store threshold on the
  cumulative ECC events the engine's per-read accountants charged to
  ``engine.store_ecc``, checked every ``interval`` engine steps.
* :class:`DriftAging`: the wear process of a soak. Every ``every`` steps the
  deployment takes a fresh static injection at the aging tick's
  drift-scaled BER, from per-tick seeds, so a scrub-on and a scrub-off run
  draw the same damage.
* :class:`ScrubController`: the ``engine.run(on_step=...)`` hook. It ages,
  scrubs the stores past the threshold (``cim.read`` through the decoder,
  ``cim.pack`` back into a fresh image, as deployment packs), swaps the
  engine's params with ``refresh_params(force=True)`` (which drops the
  prefix cache; ``serving_params`` rebuilds decoded-row caches from the
  new image) and logs the scrub through ``engine.record_scrub``.

The controller replaces its ``dep`` as it ages and scrubs: read
``controller.dep`` after a run for the final image, and
``engine.aggregate()['scrub']`` for the rollup.

Seeds. The reference keys a tick's injection on ``fold_in(key, tick)``
(``jax.random``, which the port does not reimplement). :class:`DriftAging`
takes the per-tick per-store plane seeds instead: a callable ``tick ->
{path: {"man", "meta", "cw"}}`` (a parity test passes the reference's seeds
there), or an integer from which :func:`tick_seeds` derives them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import cim as cim_lib
from repro_torch.core import faultmodels as fm_lib

_AGE_SALT = 0xA6E5


@dataclasses.dataclass(frozen=True)
class ScrubPolicy:
    """When the controller rewrites a store's SRAM image.

    ``threshold``: cumulative ECC events (corrected + uncorrectable) charged
    to one store in ``engine.store_ecc`` since its last scrub. ``interval``:
    the check cadence in engine steps. ``max_scrubs``: a cap on scrub events
    a run (0: none)."""

    threshold: int = 16
    interval: int = 1
    max_scrubs: int = 0

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {self.threshold}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")

    def due(self, store_ecc: dict) -> List[str]:
        """Store paths whose cumulative charges crossed the threshold."""
        return [p for p, c in store_ecc.items()
                if c["corrected"] + c["uncorrectable"] >= self.threshold]


def tick_seeds(seed: int, tick: int, paths: Sequence[str]) -> dict:
    """Per-store plane seeds of aging tick ``tick`` from an integer seed.

    Rule: ``np.random.SeedSequence([seed, 0xA6E5, tick]).generate_state(
    3 * len(paths), np.uint32)``, taken in order as the (man, meta, cw)
    seeds of each path in ``paths``."""
    w = [int(v) for v in np.random.SeedSequence(
        [int(seed), _AGE_SALT, int(tick)]).generate_state(3 * len(paths),
                                                          np.uint32)]
    return {p: {"man": w[3 * i], "meta": w[3 * i + 1], "cw": w[3 * i + 2]}
            for i, p in enumerate(paths)}


SeedSource = Union[int, Callable[[int], Dict[str, dict]]]


@dataclasses.dataclass
class DriftAging:
    """Cumulative wear: fresh static faults into the deployment every tick.

    Each application injects at ``ber`` scaled by the drift curve at
    ``tick`` (the process's ``tick`` is set per call) from the tick's seeds.
    Damage accumulates because each injection lands on the current,
    already-faulted image; only a scrub's re-encode clears it. ``seeds`` is
    an integer (:func:`tick_seeds`) or a callable ``tick -> {path: plane
    seeds}``."""

    seeds: SeedSource
    ber: float
    model: fm_lib.FaultProcess = dataclasses.field(
        default_factory=fm_lib.FaultProcess.drift)
    every: int = 1

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        self.model = fm_lib.parse_fault_model(self.model)

    def seeds_at(self, dep, tick: int) -> Dict[str, dict]:
        if callable(self.seeds):
            return self.seeds(int(tick))
        return tick_seeds(self.seeds, tick, [p for p, _, _ in
                                             dep.store_leaves()])

    def age(self, dep, tick: int):
        """One wear step at ``tick`` -> the derived deployment."""
        model = self.model
        if model is not None and model.kind == "drift":
            model = dataclasses.replace(model, tick=int(tick))
        return dep.inject(self.seeds_at(dep, tick), self.ber, model=model)


def _words(plane: torch.Tensor) -> torch.Tensor:
    """A plane's words as a signed integer view of the same width (CUDA
    compares no uint16)."""
    return plane.view(torch.int16) if plane.dtype == torch.uint16 else plane


class ScrubController:
    """``engine.run(on_step=controller)``: age, threshold, re-encode, swap.

    ``dep``: the live :class:`~repro_torch.core.deployment.CIMDeployment`
    behind the engine's params (the controller owns it from here; aging and
    scrubs replace it). ``policy``: a :class:`ScrubPolicy` (the default
    thresholds if omitted). ``aging``: an optional :class:`DriftAging` driven
    off engine steps. ``serving_kw``: the ``dep.serving_params`` kwargs of
    the engine's params (``dynamic_seeds``/``ber``/``model``/``row_cache``
    ...), used to rebuild them after aging or a scrub; they must be the
    ones the engine's params were built with."""

    def __init__(self, dep, policy: Optional[ScrubPolicy] = None, *,
                 aging: Optional[DriftAging] = None, serving_kw=None):
        self.dep = dep
        self.policy = policy or ScrubPolicy()
        self.aging = aging
        self.serving_kw = dict(serving_kw or {})
        self.events: List[dict] = []
        self.tick = 0

    def __call__(self, engine, ev=None) -> None:
        self.on_step(engine, ev)

    def on_step(self, engine, ev=None) -> None:
        self.tick += 1
        dirty = False
        if self.aging is not None and self.tick % self.aging.every == 0:
            self.dep = self.aging.age(self.dep, self.tick)
            dirty = True
        if self.tick % self.policy.interval == 0:
            due = self.policy.due(engine.store_ecc)
            if due and not (self.policy.max_scrubs
                            and len(self.events) >= self.policy.max_scrubs):
                event = self.scrub(due)
                event["step"] = int(getattr(engine, "steps", self.tick))
                engine.record_scrub(event)
                dirty = True
        if dirty:
            engine.refresh_params(self.dep.serving_params(**self.serving_kw),
                                  force=True)

    def scrub(self, paths) -> dict:
        """Re-encode the stores at ``paths`` -> the event dict.

        Each store is read through its ECC decoder (every correctable error
        cleared; an uncorrectable row is rewritten as its decoded value,
        wrong but stable from then on) and packed into a fresh image, as
        deployment packs. Unprotected stores are skipped: with no decoder a
        rewrite would only bake the faults in. ``words_healed`` counts the
        words that differ between the old and the fresh planes."""
        t0 = time.perf_counter()
        paths = {str(p) for p in paths}
        stores = dict(self.dep.stores)
        rows = words = corrected = uncorrectable = 0
        scrubbed = []
        for path, _, leaf in self.dep.store_leaves():
            if path not in paths or leaf.codewords is None:
                continue
            st = cim_lib.store_stats(leaf)
            w, _ = cim_lib.read(leaf)
            fresh = cim_lib.pack(w, leaf.cfg)
            del w
            rows += int(leaf.man.shape[0])         # the whole image rewritten
            old, new = cim_lib.plane_dict(leaf), cim_lib.plane_dict(fresh)
            words += sum(int((_words(old[n]) != _words(new[n])).sum())
                         for n in old)
            corrected += st["corrected"]
            uncorrectable += st["uncorrectable"]
            stores[path] = fresh
            scrubbed.append(path)
        self.dep = self.dep._replace_stores(stores)
        event = {
            "paths": scrubbed,
            "rows": rows,
            "words_healed": words,
            "corrected_cleared": corrected,
            # the uncorrectable events this image would charge on every
            # later read until rewritten: the scrub's averted estimate
            "uncorrectable_cleared": uncorrectable,
            "wall_s": time.perf_counter() - t0,
            "tick": self.tick,
        }
        self.events.append(event)
        return event
