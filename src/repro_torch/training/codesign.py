"""The co-design loop (port of ``repro/training/codesign.py``, paper §III-C):
resilience-aware fine-tuning and automatic reliability-policy search.

* :class:`Finetuner` — two-stage fine-tuning through the deployment stack:

    1. **reshape** — train with the exponent-compression regularizer
       (:func:`repro_torch.models.losses.exponent_compression_penalty`,
       weighted per the policy's rule groups) and free exponents, shrinking
       each N-block's log-magnitude spread so alignment loses less;
    2. **aligned** — re-align the reshaped weights per rule, freeze
       (exponent, sign), and train mantissas under the policy's dynamic
       fault schedule (:func:`repro_torch.core.deployment.
       training_fault_schedule`, drawn through the CUDA kernel K4 on the
       card), so the model learns under the soft errors it will serve with.

  The fault streams follow the counter-PRNG contract: each step's seed is a
  function of (seed, step), folded per leaf, field and counter chunk.

* :class:`PolicySearch` — the cheapest per-layer protection meeting an
  accuracy-vs-BER SLO. The search space is per-group (pattern) choices of
  ``protect x field x n_group`` (:class:`SearchSpace`); the evaluator is
  :meth:`repro_torch.core.sweep.SweepEngine.run_policies` (every store
  plane of a candidate arm drawn for all trials in one launch of the CUDA
  kernel K3); the cost axis is the deployed ``stored_bits``. Greedy
  cost-ascent: every group starts at its cheapest candidate, single-step
  upgrades are evaluated together and the best accuracy-per-bit move is
  taken until the SLO holds; then a prune pass walks groups back down while
  it still holds. The moves, the prune and the trace entries are the
  reference's.

How it differs from the reference: ``PolicySearch`` takes ``seeds`` (an
int) in place of a ``jax.random`` key and draws evaluation ``k``'s seed as
``fold_seed(seeds, k)``, so a search is reproducible; weights and
evaluations are ``{path: tensor}`` trees on ``device`` (default ``cuda``).

On a mesh: ``Finetuner(mesh=...)`` runs both stages data-parallel through
``run_training(mesh=)`` (replicated state; :mod:`repro_torch.training.
loop`). ``mesh='auto'`` builds ``make_host_mesh(model_axis=1)`` over the
world when torchrun's environment names more than one rank, and otherwise
stays on one device without starting a process group. ``PolicySearch(
engine=SweepEngine(plan, mesh=make_trial_mesh()))`` splits each
evaluation's trials over the ranks (``SweepEngine.run_policies``), every
rank gets every result, so every rank takes the same moves.

``python -m repro_torch.training.codesign --quick --json out.json`` runs the
smoke: a short fine-tune of reduced olmo-1b plus a 2-candidate policy
selection (``--device cpu`` for the plain path).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import cim as cim_lib
from repro_torch.core import sweep as sweep_lib
from repro_torch.core.deployment import (VALID_FIELDS, VALID_PROTECTS,
                                         CIMDeployment, PolicyRule,
                                         ReliabilityPolicy, check_enum)
from repro_torch.device import resolve_device
from repro_torch.training import steps as steps_lib
from repro_torch.training.loop import TrainResult, run_training


# ---------------------------------------------------------------- fine-tune


@dataclasses.dataclass
class Finetuner:
    """Two-stage resilience-aware fine-tuning under a reliability policy.

    ``run(batches, params=...)`` fine-tunes ``params`` (a ``{path: tensor}``
    tree; or trains from ``torch.Generator(device).manual_seed(seed)`` when
    None) and returns the stage-2 :class:`TrainResult`, whose
    ``deployment`` is the final weights packed under ``policy`` and whose
    ``info['reshape']`` carries the stage-1 curve. ``batches`` is an
    iterator (consumed across both stages) or a zero-arg callable returning
    one per stage."""

    cfg: ModelConfig
    policy: ReliabilityPolicy
    ber: float = 0.0
    reshape_steps: int = 40
    aligned_steps: int = 40
    learning_rate: float = 1e-3
    exp_reg_coef: float = 5e-2
    exp_reg_margin: float = 1.0
    weight_decay: float = 0.0
    seed: int = 0
    mesh: object = "auto"
    device: object = None

    def _mesh(self):
        """None, the given mesh, or for ``"auto"`` the host mesh over the
        world when torchrun's environment names more than one rank (made
        before the device resolves: it binds the process to its card)."""
        if not isinstance(self.mesh, str):
            return self.mesh
        if self.mesh != "auto":
            raise ValueError(f"Finetuner: mesh must be 'auto', None or a "
                             f"Mesh, got {self.mesh!r}")
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        from repro_torch.launch.mesh import make_host_mesh
        kind = "cuda" if self.device is None \
            else torch.device(self.device).type
        return make_host_mesh(model_axis=1, device_type=kind)

    def _run_cfg(self, **kw) -> RunConfig:
        base = dict(policy=self.policy, learning_rate=self.learning_rate,
                    weight_decay=self.weight_decay, seed=self.seed,
                    checkpoint_dir="", remat=False, warmup_steps=0)
        base.update(kw)
        return RunConfig(**base)

    def _batches(self, batches):
        if callable(batches):
            return iter(batches())
        return iter(batches)

    def _stage(self, run: RunConfig, seed: int, batches, params,
               log_fn, mesh) -> TrainResult:
        """One stage of ``run_training`` from ``params``. The state goes
        straight in: ``run_training`` holds its only reference, so a step
        frees the weights and moments it replaces."""
        dev = resolve_device(self.device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return run_training(self.cfg, run, self._batches(batches),
                            log_fn=log_fn, state=steps_lib.init_train_state(
                                gen, self.cfg, run, params=params,
                                device=dev), mesh=mesh)

    def _reshape(self, batches, params, log_fn, mesh):
        """Stage 1: (its params, its history). Its moments die here."""
        run1 = self._run_cfg(steps=self.reshape_steps, ber=0.0,
                             exp_reg_coef=self.exp_reg_coef,
                             exp_reg_margin=self.exp_reg_margin,
                             freeze_exponents=False)
        res = self._stage(run1, self.seed, batches, params, log_fn, mesh)
        return res.state.params, res.history

    def run(self, batches, params=None,
            log_fn: Optional[Callable] = None) -> TrainResult:
        mesh = self._mesh()
        reshape_hist: List[Dict] = []
        if self.reshape_steps > 0:
            params, reshape_hist = self._reshape(batches, params, log_fn,
                                                 mesh)
        run2 = self._run_cfg(steps=self.aligned_steps, ber=self.ber,
                             inject="dynamic", freeze_exponents=True)
        res2 = self._stage(run2, cim_lib.fold_seed(self.seed, 1), batches,
                           params, log_fn, mesh)
        res2.info["reshape"] = {"steps": self.reshape_steps,
                                "history": reshape_hist}
        return res2


# ------------------------------------------------------------ search space


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Per-layer protection search grammar.

    ``groups`` is an ordered tuple of ``(name, pattern)`` rule groups —
    pattern syntax is :class:`PolicyRule`'s (glob / ``re:`` regex, first
    match wins, so order specific groups before catch-alls). Every group
    independently picks one candidate from the ``protects x fields x
    n_groups`` grid; leaves no group matches fall to ``default`` (fixed, not
    searched).
    """

    groups: Tuple[Tuple[str, str], ...]
    protects: Tuple[str, ...] = ("none", "one4n", "per_weight")
    fields: Tuple[str, ...] = ("full",)
    n_groups: Tuple[int, ...] = (8,)
    default: PolicyRule = PolicyRule()

    def __post_init__(self):
        object.__setattr__(self, "groups", tuple(
            (str(n), str(p)) for n, p in self.groups))
        object.__setattr__(self, "protects", tuple(self.protects))
        object.__setattr__(self, "fields", tuple(self.fields))
        object.__setattr__(self, "n_groups", tuple(int(n)
                                                   for n in self.n_groups))
        if not self.groups:
            raise ValueError("SearchSpace: need at least one (name, pattern) "
                             "group")
        names = [n for n, _ in self.groups]
        if len(set(names)) != len(names):
            raise ValueError(f"SearchSpace: duplicate group names in {names}")
        for p in self.protects:
            check_enum("protects", p, VALID_PROTECTS, "SearchSpace")
        for f in self.fields:
            check_enum("fields", f, VALID_FIELDS, "SearchSpace")
        if not self.protects or not self.fields or not self.n_groups:
            raise ValueError("SearchSpace: protects/fields/n_groups must be "
                             "non-empty")

    def candidates(self) -> Tuple[dict, ...]:
        """The per-group candidate grid as PolicyRule kwargs."""
        return tuple(dict(protect=p, field=f, n_group=n)
                     for p, f, n in itertools.product(
                         self.protects, self.fields, self.n_groups))


@dataclasses.dataclass(frozen=True)
class AccuracySLO:
    """Accuracy floor at a BER: ``accuracy(ber) >= clean - max_drop`` (and
    ``>= min_accuracy`` when given). ``floor`` resolves the effective bound
    against the measured clean accuracy."""

    ber: float
    max_drop: float = 0.02
    min_accuracy: Optional[float] = None

    def __post_init__(self):
        if self.ber < 0:
            raise ValueError(f"AccuracySLO: ber must be >= 0, got {self.ber}")
        if self.max_drop < 0:
            raise ValueError(f"AccuracySLO: max_drop must be >= 0, got "
                             f"{self.max_drop}")

    def floor(self, clean_accuracy: float) -> float:
        f = clean_accuracy - self.max_drop
        if self.min_accuracy is not None:
            f = max(f, self.min_accuracy)
        return f


@dataclasses.dataclass
class SearchResult:
    """Outcome of a policy search/selection."""

    policy: ReliabilityPolicy
    name: str
    accuracy: float            # mean accuracy at slo.ber under the policy
    clean_accuracy: float
    floor: float               # resolved SLO floor
    slo_met: bool
    stored_bits: int
    raw_bits: int
    overhead: float            # stored_bits / raw_bits - 1
    evals: int                 # total candidate-arm evaluations spent
    trace: List[Dict]          # per-move search log

    @property
    def assignment(self) -> Dict[str, dict]:
        """Group name -> chosen rule settings (search results only)."""
        return {r.pattern: dict(protect=r.protect, field=r.field,
                                n_group=r.n_group)
                for r in self.policy.rules}


class PolicySearch:
    """Cheapest per-layer protection meeting an accuracy-vs-BER SLO.

    ``params`` is a ``{path: tensor}`` tree; ``eval_fn(params) -> scalar
    accuracy`` takes a decoded one. Evaluation goes through
    ``SweepEngine.run_policies`` (K3 on the card); cost comes from each
    arm's deployed ``stored_bits``. ``seeds`` (an int) seeds evaluation
    ``k`` with ``fold_seed(seeds, k)``."""

    def __init__(self, params, eval_fn: Callable, slo: AccuracySLO,
                 space: Optional[SearchSpace] = None, *, n_trials: int = 3,
                 seeds: int = 0, engine=None, device=None):
        self.params = params
        self.eval_fn = eval_fn
        self.slo = slo
        self.space = space
        self.seeds = int(seeds)
        if engine is None:
            plan = sweep_lib.SweepPlan(bers=(slo.ber,), n_trials=n_trials)
            engine = sweep_lib.SweepEngine(plan, device=device)
        elif engine.plan.bers != (float(slo.ber),):
            raise ValueError(f"engine.plan.bers={engine.plan.bers} must be "
                             f"exactly (slo.ber,)=({slo.ber},)")
        self.engine = engine
        self.evals = 0
        self._draws = 0
        self.trace: List[Dict] = []
        self._clean: Optional[float] = None
        self._bits_cache: Dict[tuple, int] = {}

    # ------------------------------------------------------------- plumbing

    def clean_accuracy(self) -> float:
        if self._clean is None:
            self._clean = float(self.eval_fn(self.params))
        return self._clean

    def _leaf_bits(self, shape, rule: PolicyRule) -> int:
        """Stored bits of one K x J leaf under ``rule`` — shape-only, so a
        zeros probe pack is cached per (shape, packing config)."""
        ck = (tuple(shape), rule.protect, rule.n_group, rule.index,
              rule.row_weights, rule.fmt_name)
        if ck not in self._bits_cache:
            probe = cim_lib.pack(torch.zeros(shape, dtype=torch.float32),
                                 rule.cim_cfg)
            self._bits_cache[ck] = int(probe.stored_bits)
        return self._bits_cache[ck]

    def _group_map(self) -> Dict[Optional[str], List[tuple]]:
        """Group name -> [(path, shape)] of the deployable leaves it owns
        (first matching group wins, mirroring rule order); key None holds
        the default rule's leaves."""
        probes = {name: PolicyRule(pattern)
                  for name, pattern in self.space.groups}
        out: Dict[Optional[str], List[tuple]] = {None: []}
        out.update({name: [] for name, _ in self.space.groups})
        for p, leaf in self.params.items():
            if not cim_lib._deployable(p, leaf):
                continue
            for name, _ in self.space.groups:
                if probes[name].matches(p):
                    out[name].append((p, tuple(leaf.shape)))
                    break
            else:
                out[None].append((p, tuple(leaf.shape)))
        return out

    def _policy_of(self, assignment: Dict[str, dict]) -> ReliabilityPolicy:
        rules = tuple(PolicyRule(pattern, **assignment[name])
                      for name, pattern in self.space.groups)
        return ReliabilityPolicy(rules=rules, default=self.space.default)

    def _evaluate(self, named_policies) -> Dict[str, tuple]:
        """One engine call -> {name: (mean accuracy, stored_bits)}."""
        if isinstance(named_policies, dict):
            named_policies = list(named_policies.items())
        seed = cim_lib.fold_seed(self.seeds, self._draws)
        self._draws += 1
        results = self.engine.run_policies(seed, self.params, self.eval_fn,
                                           named_policies)
        self.evals += len(named_policies)
        return {r.protect: (r.mean, r.stored_bits) for r in results}

    # --------------------------------------------------------------- search

    def search(self, max_rounds: Optional[int] = None) -> SearchResult:
        """Greedy cost-ascent + prune over the :class:`SearchSpace`."""
        if self.space is None:
            raise ValueError("PolicySearch.search needs a SearchSpace (or "
                             "use .select(named_policies))")
        clean = self.clean_accuracy()
        floor = self.slo.floor(clean)
        cands = self.space.candidates()
        gmap = self._group_map()
        for name, _ in self.space.groups:
            if not gmap[name]:
                self.trace.append({"action": "warn-empty-group",
                                   "group": name})

        def group_bits(name: str, ci: int) -> int:
            rule = PolicyRule("*", **cands[ci])
            return sum(self._leaf_bits(shape, rule)
                       for _, shape in gmap[name])

        # per-group candidate order, cheapest stored-bits first
        order = {name: sorted(range(len(cands)),
                              key=lambda ci: (group_bits(name, ci), ci))
                 for name, _ in self.space.groups}
        pos = {name: 0 for name, _ in self.space.groups}

        def assignment():
            return {name: cands[order[name][pos[name]]]
                    for name, _ in self.space.groups}

        acc, bits = self._evaluate([("start", self._policy_of(assignment()))])[
            "start"]
        self.trace.append({"action": "start", "accuracy": acc,
                           "stored_bits": bits, "floor": floor})

        budget = max_rounds if max_rounds is not None else \
            len(order) * len(cands)
        rounds = 0
        while acc < floor and rounds < budget:
            rounds += 1
            proposals = {}
            for name, _ in self.space.groups:
                if pos[name] + 1 < len(order[name]):
                    a = assignment()
                    a[name] = cands[order[name][pos[name] + 1]]
                    proposals[name] = self._policy_of(a)
            if not proposals:
                break
            res = self._evaluate([(n, p) for n, p in proposals.items()])
            # a proposal that already meets the SLO wins on cheapness;
            # otherwise climb the best accuracy-gain-per-added-bit slope
            meeting = [(res[n][1], n) for n in proposals if res[n][0] >= floor]
            if meeting:
                _, pick = min(meeting)
            else:
                def slope(n):
                    da = res[n][0] - acc
                    db = max(res[n][1] - bits, 1)
                    return da / db
                pick = max(proposals, key=slope)
            pos[pick] += 1
            acc, bits = res[pick]
            self.trace.append({"action": "upgrade", "group": pick,
                               "candidate": cands[order[pick][pos[pick]]],
                               "accuracy": acc, "stored_bits": bits})

        # prune: walk groups back down while the SLO still holds
        while acc >= floor:
            downs = {}
            for name, _ in self.space.groups:
                if pos[name] > 0:
                    a = assignment()
                    a[name] = cands[order[name][pos[name] - 1]]
                    downs[name] = self._policy_of(a)
            if not downs:
                break
            res = self._evaluate([(n, p) for n, p in downs.items()])
            ok = [(res[n][1], n) for n in downs if res[n][0] >= floor]
            if not ok:
                break
            _, pick = min(ok)   # biggest saving = smallest resulting bits
            pos[pick] -= 1
            acc, bits = res[pick]
            self.trace.append({"action": "prune", "group": pick,
                               "candidate": cands[order[pick][pos[pick]]],
                               "accuracy": acc, "stored_bits": bits})

        policy = self._policy_of(assignment())
        return self._result(policy, "searched", acc, clean, floor, bits)

    def select(self, named_policies) -> SearchResult:
        """Cheapest SLO-meeting policy from an explicit candidate list;
        falls back to the most accurate candidate when none meets the floor
        (``slo_met=False``)."""
        if isinstance(named_policies, dict):
            named_policies = list(named_policies.items())
        if not named_policies:
            raise ValueError("select: empty candidate list")
        clean = self.clean_accuracy()
        floor = self.slo.floor(clean)
        res = self._evaluate(named_policies)
        by_name = dict(named_policies)
        meeting = [(res[n][1], n) for n, _ in named_policies
                   if res[n][0] >= floor]
        if meeting:
            _, name = min(meeting)
        else:
            name = max(res, key=lambda n: res[n][0])
        acc, bits = res[name]
        self.trace.append({"action": "select", "name": name,
                           "accuracy": acc, "stored_bits": bits,
                           "floor": floor,
                           "arms": {n: {"accuracy": res[n][0],
                                        "stored_bits": res[n][1]}
                                    for n in res}})
        return self._result(by_name[name], name, acc, clean, floor, bits)

    def _result(self, policy, name, acc, clean, floor, bits) -> SearchResult:
        cost = CIMDeployment.deploy(self.params, policy).bit_cost()
        return SearchResult(policy=policy, name=name, accuracy=acc,
                            clean_accuracy=clean, floor=floor,
                            slo_met=acc >= floor,
                            stored_bits=cost["stored_bits"],
                            raw_bits=cost["raw_bits"],
                            overhead=cost["overhead"], evals=self.evals,
                            trace=list(self.trace))


# ------------------------------------------------------------- smoke CLI


def lm_accuracy_eval(cfg: ModelConfig, batches) -> Callable:
    """``eval_fn(params) -> greedy next-token accuracy`` over ``batches``
    (the reference smoke's eval: the mean of each batch's accuracy)."""
    from repro_torch.models import lm
    from repro_torch.models.losses import lm_loss
    model = lm.shell(cfg)

    @torch.no_grad()
    def eval_fn(params):
        dev = next(iter(params.values())).device
        accs = []
        for b in batches:
            logits = lm.forward(model, params, torch.as_tensor(
                np.asarray(b["tokens"]), dtype=torch.int64, device=dev))
            accs.append(lm_loss(logits, torch.as_tensor(
                np.asarray(b["labels"]), dtype=torch.int64,
                device=dev))[1]["accuracy"])
        return torch.stack(accs).mean()
    return eval_fn


def smoke_candidates() -> dict:
    """The smoke's two arms: uniform One4N, and One4N on the embeddings
    with everything else unprotected."""
    return {"uniform_one4n": ReliabilityPolicy(),
            "embeds_only": ReliabilityPolicy(
                rules=(PolicyRule("embed", protect="one4n"),
                       PolicyRule("unembed", protect="one4n"),
                       PolicyRule("*", protect="none")))}


def _smoke(args) -> dict:
    """Quick fine-tune + 2-candidate policy selection on reduced olmo-1b."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM

    t0 = time.time()
    cfg = get_config("olmo-1b").reduced()
    data = MarkovLM(cfg.vocab_size, 64, 8, seed=0)
    ft = Finetuner(cfg, ReliabilityPolicy(), ber=args.ber,
                   reshape_steps=args.reshape_steps,
                   aligned_steps=args.aligned_steps, seed=0,
                   device=args.device)
    res = ft.run(iter(data))
    losses = np.asarray(
        [h["loss"] for h in res.info["reshape"]["history"]] +
        [h["loss"] for h in res.history])
    eval_fn = lm_accuracy_eval(cfg, [data.batch(9000 + i) for i in range(2)])
    search = PolicySearch(res.state.params, eval_fn,
                          AccuracySLO(ber=args.ber, max_drop=args.max_drop),
                          n_trials=2, device=args.device)
    sel = search.select(smoke_candidates())
    return {
        "quick": True,
        "wall_s": time.time() - t0,
        "finetune": {"steps": int(len(losses)),
                     "final_loss": float(losses[-1]),
                     "losses_finite": bool(np.isfinite(losses).all()),
                     "ecc_stats": res.ecc_stats},
        "search": {"selected": sel.name, "slo_met": bool(sel.slo_met),
                   "accuracy": sel.accuracy,
                   "clean_accuracy": sel.clean_accuracy,
                   "floor": sel.floor, "stored_bits": sel.stored_bits,
                   "overhead": sel.overhead, "evals": sel.evals},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(
        description="co-design smoke: quick fine-tune + policy selection")
    ap.add_argument("--quick", action="store_true",
                    help="shrink steps further")
    ap.add_argument("--ber", type=float, default=1e-3)
    ap.add_argument("--max-drop", type=float, default=0.05)
    ap.add_argument("--reshape-steps", type=int, default=20)
    ap.add_argument("--aligned-steps", type=int, default=20)
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    if args.quick:
        args.reshape_steps = min(args.reshape_steps, 10)
        args.aligned_steps = min(args.aligned_steps, 10)

    out = _smoke(args)
    print(json.dumps(out, indent=2))
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    if not out["finetune"]["losses_finite"]:
        print("codesign smoke: NON-FINITE training losses")
        return 1
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
