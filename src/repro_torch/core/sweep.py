"""Characterization engine (port of ``repro/core/sweep.py``, paper §III-A).

The paper's Fig. 2 / Fig. 6 evidence is a fault-injection grid over (field
or protection arm × BER × trial). For each arm and BER the engine draws all
T trials' faulted copies of every weight plane in one launch of the
trial-batched counter-PRNG kernel K3 (:mod:`repro_torch.kernels.
fault_inject`), then evaluates the trials. ``run_policies`` does the same
for arms that are per-layer reliability policies (the co-design search's
evaluator).

How it differs from the reference's engine:

* one route, the counter-PRNG route (the reference's ``backend="pallas"``):
  K3 on ``cuda``, its plain version only for ``device="cpu"``; the
  reference's ``xla`` backend draws ``jax.random.bernoulli`` streams and
  raises here (ROADMAP Queue 1 item 8);
* every ``fault_models`` arm runs on that route: burst and correlated
  thresholds are computed per element inside K3 (the reference, too, sends
  a non-i.i.d. Fig. 2 arm through its batched kernel whatever the engine's
  backend);
* trial randomness is explicit: each arm takes a uint32 ``[B, T]`` seed
  array, in the order the reference's ``_trial_randomness`` consumes keys
  (arms in plan order, one ``jax.random.bits(sub, (B, T), uint32)`` each);
  an int seed expands through :func:`default_seeds`;
* ``eval_fn`` runs trial by trial (one trial's decoded weights live at a
  time); the result is the ``[B, T]`` grid the reference's ``vmap``
  produces;
* the trial mesh (``SweepEngine(plan, mesh=make_trial_mesh())``, the
  reference's ``shard_trials``, always on when a mesh is given): each rank
  of the ``("trial",)`` axis runs its slice of every cell's trials (K3
  with those trials' seeds, then the decode and the eval) and the
  per-trial accuracies and ECC counts are gathered in trial order. A
  trial's seeds do not depend on the split, so the gathered cell equals
  the unsharded one. A trial count the mesh does not divide runs whole on
  every rank, as the reference replicates it.
  ``trial_shard=(n, index)`` runs one rank's slice without a mesh and
  :func:`merge_trial_shards` joins the slices;
* the 2-D ``("trial", "model")`` sweep mesh (``make_sweep_mesh``, the
  reference's ``_shard_stores``): on a mesh with ``"model"`` every store of
  a Fig. 6 or policy arm is column-sharded over it (``cim.shard_store(...,
  dim='j')``; a store ``can_shard_store`` refuses stays whole), each rank
  draws its block through K3 at the block's global counters (so each
  block's faults are the unsharded draw's), decodes it, and the decoded
  columns are gathered over ``"model"`` before ``eval_fn``, the ECC counts
  summed over it. Trials split over ``"trial"`` as above. Fig. 2 arms draw
  plain tensors and are not sharded, as in the reference.

Parameter trees are ``{path: tensor}`` mappings in the reference's flatten
order (:mod:`repro_torch.core.tree`); leaf ``i`` salts its streams with
``_salted(seeds, i)`` (Fig. 2) or ``_salted(seeds, 7*i + 1)`` (Fig. 6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitops, bitpack, tree
from repro_torch.core import cim as cim_lib
from repro_torch.core import fault as fault_lib
from repro_torch.core import faultmodels as fm_lib
from repro_torch.core.bitops import FP16, FloatFormat
from repro_torch.device import resolve_device
from repro_torch.kernels.fault_inject import kernel as fi_kernel
from repro_torch.kernels.fault_inject import ops as fi_ops
from repro_torch.kernels.fault_inject.ref import hash_u32

M32 = 0xFFFFFFFF
_SEED_SALT = 0x5EED2


@dataclasses.dataclass
class SweepResult:
    """One (BER, arm) cell of the characterization grid."""

    ber: float
    field: str
    protect: str            # 'raw' (plain tensors), or the protection arm
    accuracies: List[float]
    corrected: float = 0.0
    uncorrectable: float = 0.0
    stored_bits: int = 0    # the arm's deployed SRAM cells (policy sweeps)
    fault_model: str = "iid"
    # per-trial ECC counts (their means are ``corrected`` / ``uncorrectable``)
    trial_corrected: List[int] = dataclasses.field(default_factory=list)
    trial_uncorrectable: List[int] = dataclasses.field(default_factory=list)

    @property
    def mean(self) -> float:
        return float(np.mean(self.accuracies))

    @property
    def std(self) -> float:
        return float(np.std(self.accuracies))


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Static description of a characterization grid: arms are fields
    (Fig. 2) or protection modes (Fig. 6), times ``fault_models``."""

    bers: Tuple[float, ...]
    n_trials: int = 10
    fields: Tuple[str, ...] = ("sign", "exponent", "mantissa", "full")
    protects: Tuple[str, ...] = ("none", "one4n")
    fmt: FloatFormat = FP16
    backend: str = "auto"               # 'auto' | 'xla' | 'pallas'
    fault_models: Tuple[str, ...] = ("iid",)

    def __post_init__(self):
        object.__setattr__(self, "bers", tuple(float(b) for b in self.bers))
        object.__setattr__(self, "fields", tuple(self.fields))
        object.__setattr__(self, "protects", tuple(self.protects))
        object.__setattr__(self, "fault_models",
                           tuple(str(m) for m in self.fault_models))
        for m in self.fault_models:
            fm_lib.parse_fault_model(m)        # validate the grammar eagerly
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")

    def n_arms(self, kind: str) -> int:
        arms = self.fields if kind == "fields" else self.protects
        return len(self.fault_models) * len(arms)


def default_seeds(seed: int, n_arms: int, n_bers: int,
                  n_trials: int) -> np.ndarray:
    """uint32 [n_arms, n_bers, n_trials] trial seeds from an int:
    ``np.random.SeedSequence([seed, 0x5EED2]).generate_state``, in C order."""
    words = np.random.SeedSequence([int(seed), _SEED_SALT]).generate_state(
        n_arms * n_bers * n_trials, np.uint32)
    return words.reshape(n_arms, n_bers, n_trials)


_POLICY_SEED_SALT = 0x5EED3
PLANE_KEYS = ("man", "meta", "cw")


def policy_seeds(seed: int, n_arms: int, n_bers: int, n_trials: int,
                 paths) -> list:
    """A policy sweep's plane seeds from an int: ``[arm][BER][trial]``
    ``{path: {"man", "meta", "cw"}}`` for every leaf path, from
    ``np.random.SeedSequence([seed, 0x5EED3]).generate_state`` in C order
    over (arm, BER, trial, path, plane) — the shape of the reference's key
    chain (``_split_schedule`` per arm, then ``CIMDeployment.inject``'s
    per-leaf split and ``plane_seeds``)."""
    paths = list(paths)
    words = np.random.SeedSequence([int(seed), _POLICY_SEED_SALT]) \
        .generate_state(n_arms * n_bers * n_trials * len(paths) * 3,
                        np.uint32).reshape(n_arms, n_bers, n_trials,
                                           len(paths), 3)
    return [[[{p: dict(zip(PLANE_KEYS, map(int, words[a, b, t, i])))
               for i, p in enumerate(paths)}
              for t in range(n_trials)] for b in range(n_bers)]
            for a in range(n_arms)]


def _salted(seeds: np.ndarray, salt: int) -> np.ndarray:
    """Decorrelate the per-trial counter-PRNG streams of distinct planes."""
    s = np.asarray(seeds, np.uint32).astype(np.int64)
    return hash_u32(s ^ ((salt * 0x85EBCA6B + 0x9E3779B9) & M32)) \
        .astype(np.uint32)


def _arm_model(spec) -> Optional[fm_lib.FaultProcess]:
    """Fault-model arm spec -> process; ``iid`` maps to ``None``."""
    model = fm_lib.parse_fault_model(spec)
    return None if model is not None and model.kind == "iid" else model


def _inject(bits, seeds, threshold, positions, model=None, col_div=1,
            at=None, plane=None):
    return fi_ops.fault_inject_bits_batched(
        bits, seeds, threshold, positions=tuple(positions), model=model,
        col_div=col_div, at=at, plane=plane)


def inject_pytree_batched(params: Mapping, seeds, threshold: int, field: str,
                          fmt: FloatFormat = FP16, *,
                          predicate=fault_lib._is_injectable, model=None):
    """Batched static injection: every injectable leaf becomes ``[T, ...]``
    faulted copies (its ``reshape(-1, last)`` bit plane through K3, salted
    by its flatten index); pass-through leaves become ``expand`` views.
    Every injectable leaf's counter space is checked before any is drawn."""
    positions = tuple(int(p) for p in fmt.field_bit_positions(field))
    seeds = fi_kernel.seed_words(seeds)
    t = seeds.size
    flat = tree.flatten(params)
    for path, leaf in flat.items():
        if predicate(path, leaf):
            fi_kernel.check_counter_space(leaf.numel() // leaf.shape[-1],
                                          leaf.shape[-1])
    out = {}
    for i, (path, leaf) in enumerate(flat.items()):
        if predicate(path, leaf):
            bits = bitops.to_bits(leaf.reshape(-1, leaf.shape[-1]), fmt)
            faulted = _inject(bits, _salted(seeds, i), threshold, positions,
                              model)
            out[path] = bitops.bits_to_dtype(faulted, leaf.dtype, fmt) \
                .reshape((t,) + tuple(leaf.shape))
        else:
            out[path] = leaf.expand((t,) + tuple(leaf.shape))
    return out


def _valid_words(masks: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(masks, np.uint32)
                            .view(np.int32)).to(device)


def _store_inject_batched(store: cim_lib.CIMStore, seeds: Mapping,
                          thr_man: int, thr_meta: int, n_trials: int,
                          model=None) -> cim_lib.CIMStore:
    """Batched SRAM-plane injection on the word-packed planes: K3 draws
    per-word flip masks over the ``n_trials`` trials, one launch a plane,
    from the plane's uint32 [T] seeds ``seeds["man"]`` / ``["cw"]`` (the
    codeword plane) / ``["meta"]`` and ``["sign"]`` (the raw exponent and
    sign planes); ``thr_man`` gates the mantissa plane, ``thr_meta`` the
    others (0: the plane is not drawn, its trials are ``expand`` views).
    Lanes that are not stored cells (codeword tail words, the sign plane's
    ragged last word) are restored to their original bits. The result's
    planes carry a leading [T]."""
    t = n_trials
    fmt = store.cfg.fmt
    dev = store.device

    def draw(plane, key, name, thr, positions, **kw):
        if not thr:
            return plane.expand((t,) + tuple(plane.shape))
        return _inject(plane, seeds[key], thr, positions, model,
                       at=store.shard, plane=name, **kw)

    man = draw(store.man, "man", "man", thr_man, range(fmt.man_bits))
    sign = exp = cw = None
    if store.codewords is not None:
        cw_arr = store.codewords
        masks = cim_lib.codeword_valid_masks(store.cfg)
        if cw_arr.ndim == 2:
            # per-weight SECDED: one uint16 word per weight, n stored bits
            positions = [p for p in range(16) if (int(masks) >> p) & 1]
            cw = draw(cw_arr, "cw", "cw", thr_meta, positions)
        else:
            cw2d = cw_arr.reshape(cw_arr.shape[0], -1)     # [B, G*S*W]
            # macro-column units of the flattened plane are S*W words wide
            # (the geometry faultmodels.plane_geometry derives from 4-D)
            cw = draw(cw2d, "cw", "cw", thr_meta, range(32),
                      col_div=cw_arr.shape[2] * cw_arr.shape[3])
            if thr_meta:
                valid = _valid_words(
                    np.tile(masks, cw2d.shape[1] // masks.size), dev)
                cw = (cw & valid) | (cw2d[None] & ~valid)
            cw = cw.reshape((t,) + tuple(cw_arr.shape))
    else:
        exp = draw(store.exp, "meta", "exp", thr_meta, range(fmt.exp_bits))
        sign = draw(store.sign, "sign", "sign", thr_meta, range(32))
        if thr_meta:
            valid = _valid_words(bitpack.word_masks(
                store.man.shape[0], store.sign.shape[0]), dev)[:, None]
            sign = (sign & valid) | (store.sign[None] & ~valid)
    return cim_lib.CIMStore(man=man, sign=sign, exp=exp, codewords=cw,
                            shape=store.shape, cfg=store.cfg,
                            shard=store.shard)


# the Fig. 6 engine's per-plane salts of a store's trial seeds
_FIG6_PLANE_SALTS = (("man", 101), ("cw", 102), ("meta", 103), ("sign", 104))


def cim_inject_pytree_batched(stores: Mapping, seeds, threshold: int,
                              model=None):
    """Batched ``cim.inject_pytree``: every store gains a leading [T] on each
    plane, every pass-through leaf an ``expand`` view (no copies)."""
    seeds = fi_kernel.seed_words(seeds)
    t = seeds.size
    out = {}
    for i, (path, leaf) in enumerate(tree.flatten(stores).items()):
        if cim_lib._is_store(leaf):
            salted = _salted(seeds, 7 * i + 1)
            out[path] = _store_inject_batched(
                leaf, {k: _salted(salted, s) for k, s in _FIG6_PLANE_SALTS},
                threshold, threshold, t, model)
        else:
            out[path] = leaf.expand((t,) + tuple(leaf.shape))
    return out


def _trial_store(store: cim_lib.CIMStore, i: int) -> cim_lib.CIMStore:
    def pick(p):
        return None if p is None else p[i]
    return cim_lib.CIMStore(man=pick(store.man), sign=pick(store.sign),
                            exp=pick(store.exp), codewords=pick(store.codewords),
                            shape=store.shape, cfg=store.cfg,
                            shard=store.shard)


def trial_params(batched: Mapping, i: int) -> dict:
    """Trial ``i`` of a batched tree (stores' planes and tensors at ``i``)."""
    return {p: _trial_store(v, i) if cim_lib._is_store(v) else v[i]
            for p, v in batched.items()}


def policy_inject_batched(dep, trials, ber) -> dict:
    """A deployment's T faulted copies at ``ber``: every store plane its
    rule draws is one K3 launch over the trials, at the rule's threshold
    (``ber * ber_scale`` in float32, ``field`` gating mantissa against
    exponent/sign/check planes) from ``trials[t][path]``'s plane seeds —
    trial ``t`` of the result equals ``dep.inject(trials[t], ber)``'s
    stores bit for bit. Pass-through leaves become ``expand`` views."""
    n_t = len(trials)
    batched = {}
    for path, leaf in dep.stores.items():
        if not cim_lib._is_store(leaf):
            batched[path] = leaf.expand((n_t,) + tuple(leaf.shape))
            continue
        rule = dep.rules[path]
        thr_man, thr_meta = cim_lib.field_thresholds(
            np.float32(ber) * np.float32(rule.ber_scale), rule.field)
        planes = {k: np.asarray([c[path][k] for c in trials], np.uint32)
                  for k in PLANE_KEYS}
        planes["sign"] = planes["cw"]
        batched[path] = _store_inject_batched(leaf, planes, thr_man, thr_meta,
                                              n_t, rule.fault_process)
    return batched


def trial_slice(n_trials: int, n_shards: int, index: int) -> slice:
    """Rank ``index``'s trials of ``n_shards``: an even split, or all of
    them when ``n_shards`` does not divide ``n_trials``."""
    if n_shards <= 1 or n_trials % n_shards:
        return slice(0, n_trials)
    per = n_trials // n_shards
    return slice(index * per, (index + 1) * per)


def _cell(ber, field, protect, accs, corr, unc, **kw) -> SweepResult:
    """A grid cell from its per-trial accuracies and ECC counts."""
    return SweepResult(ber, field, protect, list(accs),
                       float(np.mean(corr)) if len(corr) else 0.0,
                       float(np.mean(unc)) if len(unc) else 0.0,
                       trial_corrected=list(corr),
                       trial_uncorrectable=list(unc), **kw)


def merge_trial_shards(parts) -> List[SweepResult]:
    """Join the trial slices of one grid (one result list a rank, in rank
    order) into the unsharded grid: per-trial accuracies and counts
    concatenated in trial order, the means taken over them."""
    out = []
    for cells in zip(*parts):
        c0 = cells[0]
        kw = dict(stored_bits=c0.stored_bits, fault_model=c0.fault_model)
        out.append(_cell(
            c0.ber, c0.field, c0.protect,
            [a for c in cells for a in c.accuracies],
            [v for c in cells for v in c.trial_corrected],
            [v for c in cells for v in c.trial_uncorrectable], **kw))
    return out


class SweepEngine:
    """Executor for characterization grids on one device, or on one rank of
    a ``("trial",)`` or ``("trial", "model")`` mesh (``mesh``; module doc).

    ``run_fields`` / ``run_protection`` map (seeds, params, ``eval_fn``) to
    :class:`SweepResult` rows in the reference's order. ``eval_fn`` takes
    one trial's ``{path: tensor}`` params and returns a scalar accuracy.
    ``trial_shard=(n, index)`` runs rank ``index``'s slice of ``n`` without
    a mesh and returns it ungathered (:func:`merge_trial_shards`)."""

    def __init__(self, plan: SweepPlan, device=None, mesh=None,
                 trial_shard=None):
        if plan.backend == "xla":
            raise NotImplementedError(
                "SweepEngine: the 'xla' backend draws jax.random streams and "
                "is not ported (ROADMAP Queue 1 item 8); the port's engine "
                "runs the counter-PRNG route ('pallas' / 'auto')")
        if mesh is not None and trial_shard is not None:
            raise ValueError("SweepEngine: mesh= or trial_shard=, not both")
        self.plan = plan
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.distributed import sharding as shlib
            trial_shard = (shlib.axis_size("trial", mesh),
                           shlib.axis_index("trial", mesh))
        n, i = trial_shard or (1, 0)
        self.trials = trial_slice(plan.n_trials, n, i)

    @property
    def _model_ranks(self) -> int:
        from repro_torch.distributed import sharding as shlib
        return shlib.axis_size(shlib.MODEL_AXIS, self.mesh) \
            if self.mesh is not None else 1

    def _shard_stores(self, stores: Mapping) -> dict:
        """On a mesh with ``"model"``: this rank's column block of every
        store (``cim.shard_store``, whole where it does not split)."""
        n = self._model_ranks
        if n == 1:
            return dict(stores)
        from repro_torch.distributed import sharding as shlib
        i = shlib.axis_index(shlib.MODEL_AXIS, self.mesh)
        return {p: cim_lib.shard_store(v, n, i, "j")
                if cim_lib._is_store(v) else v for p, v in stores.items()}

    def _gather(self, cells: List[SweepResult]) -> List[SweepResult]:
        """This rank's cells, or (on a mesh that split the trials) every
        rank's joined in trial order."""
        if self.mesh is None or self.trials == slice(0, self.plan.n_trials):
            return cells
        from repro_torch.distributed import sharding as shlib
        return merge_trial_shards(
            shlib.all_gather_objects(cells, "trial", self.mesh))

    # ------------------------------------------------------------- plumbing

    def _flat(self, params: Mapping) -> dict:
        flat = tree.flatten(params)
        for path, leaf in flat.items():
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"SweepEngine: leaf {path!r} is a "
                                f"{type(leaf).__name__}, expected a tensor")
            if leaf.device != self.device:
                raise ValueError(f"SweepEngine: leaf {path!r} is on "
                                 f"{leaf.device}, expected {self.device}")
        return flat

    def _seeds(self, seeds, kind: str) -> np.ndarray:
        plan = self.plan
        shape = (plan.n_arms(kind), len(plan.bers), plan.n_trials)
        if isinstance(seeds, (int, np.integer)):
            return default_seeds(int(seeds), *shape)
        arr = fi_kernel.seed_words(seeds).reshape(-1)
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"SweepEngine: expected uint32 seeds of shape "
                             f"{shape} (arms, BERs, trials), got "
                             f"{np.shape(seeds)}")
        return arr.reshape(shape)

    def _decoded(self, batched: Mapping, i: int, stats: list) -> dict:
        """Trial ``i`` of batched stores, ECC-decoded (its counts go to
        ``stats``); pass-through leaves stay views. A column block is
        decoded here, then the matrix gathered over ``"model"`` and its
        counts summed there (``deployment.read_placed``)."""
        from repro_torch.core import deployment as dep_lib
        restored, st = {}, {"corrected": 0, "uncorrectable": 0}
        for path, leaf in trial_params(batched, i).items():
            if cim_lib._is_store(leaf):
                restored[path], got = dep_lib.read_placed(leaf, self.mesh)
                st = {k: st[k] + got[k] for k in st}
            else:
                restored[path] = leaf
        stats.append(st)
        return restored

    # ------------------------------------------------------- Fig. 2 sweeps

    def run_fields(self, seeds, params: Mapping,
                   eval_fn: Callable) -> List[SweepResult]:
        """Fig. 2: per-field sensitivity of plain FP weights."""
        plan = self.plan
        flat = self._flat(params)
        seeds = self._seeds(seeds, "fields")
        results, arm = [], 0
        for fm_spec in plan.fault_models:
            fp = _arm_model(fm_spec)
            for field in plan.fields:
                for b, ber in enumerate(plan.bers):
                    thr = fi_ops.ber_to_threshold(ber)
                    cell_seeds = seeds[arm, b, self.trials]
                    corrupted = inject_pytree_batched(
                        flat, cell_seeds, thr, field, plan.fmt, model=fp)
                    accs = [float(eval_fn(trial_params(corrupted, i)))
                            for i in range(len(cell_seeds))]
                    results.append(SweepResult(ber, field, "raw", accs,
                                               fault_model=fm_spec))
                arm += 1
        return self._gather(results)

    # ------------------------------------------------------- Fig. 6 sweeps

    def run_protection(self, seeds, params: Mapping, eval_fn: Callable,
                       cim_cfg: Optional[cim_lib.CIMConfig] = None
                       ) -> List[SweepResult]:
        """Fig. 6: accuracy vs BER per protection arm on the CIM deployment
        (every 2-D weight aligned and packed; ECC counts per trial summed
        over the stores, then averaged over the trials)."""
        plan = self.plan
        flat = self._flat(params)
        seeds = self._seeds(seeds, "protection")
        results, arm = [], 0
        for fm_spec in plan.fault_models:
            fp = _arm_model(fm_spec)
            for protect in plan.protects:
                cfg = dataclasses.replace(cim_cfg or cim_lib.CIMConfig(),
                                          protect=protect)
                stores, _ = cim_lib.deploy_pytree_impl(flat, cfg)
                stores = self._shard_stores(stores)
                for b, ber in enumerate(plan.bers):
                    thr = fi_ops.ber_to_threshold(ber)
                    cell_seeds = seeds[arm, b, self.trials]
                    batched = cim_inject_pytree_batched(stores, cell_seeds,
                                                        thr, model=fp)
                    stats = []
                    accs = [float(eval_fn(self._decoded(batched, i, stats)))
                            for i in range(len(cell_seeds))]
                    del batched
                    results.append(_cell(
                        ber, "exponent_sign+mantissa", protect, accs,
                        [s["corrected"] for s in stats],
                        [s["uncorrectable"] for s in stats],
                        fault_model=fm_spec))
                arm += 1
        return self._gather(results)

    # ------------------------------------------------- policy (mixed) sweeps

    def run_policies(self, seeds, params: Mapping, eval_fn: Callable,
                     policies) -> List[SweepResult]:
        """Fig. 6 arms as reliability POLICIES: each arm deploys the whole
        tree under its :class:`~repro_torch.core.deployment.
        ReliabilityPolicy` (e.g. One4N on the unembed while the mantissas
        of the rest go unprotected) and sweeps the plan's (BER x trial)
        grid. ``policies`` is a sequence of ``(name, policy)`` pairs or a
        dict; results carry ``protect=name`` and the arm's ``stored_bits``.

        Each store plane of a (BER) cell is drawn for all T trials in one
        K3 launch (:func:`policy_inject_batched`). K3 computes
        ``cim.counter_flip_words``' stream, so the faulted planes equal
        ``CIMDeployment.inject``'s at the same seeds, bit for bit (the
        reference draws them through that path: its batched kernel takes
        one threshold for every store, where a policy gives each store its
        rule's). Each trial is then decoded (``CIMDeployment.read``) and
        evaluated.

        ``seeds`` is an int (:func:`policy_seeds`) or the explicit
        ``[arm][BER][trial]`` list of ``{path: {"man", "meta", "cw"}}``
        plane seeds."""
        from repro_torch.core import deployment as dep_lib
        plan = self.plan
        flat = self._flat(params)
        if isinstance(policies, dict):
            policies = list(policies.items())
        for name, policy in policies:
            if not isinstance(policy, dep_lib.ReliabilityPolicy):
                raise TypeError(f"arm {name!r}: expected ReliabilityPolicy, "
                                f"got {type(policy).__name__}")
        n_b, n_t = len(plan.bers), plan.n_trials
        if isinstance(seeds, (int, np.integer)):
            seeds = policy_seeds(int(seeds), len(policies), n_b, n_t, flat)
        elif len(seeds) != len(policies) or any(
                len(arm) != n_b or any(len(c) != n_t for c in arm)
                for arm in seeds):
            raise ValueError(f"SweepEngine.run_policies: expected plane "
                             f"seeds [arm][BER][trial] of shape "
                             f"({len(policies)}, {n_b}, {n_t})")
        results = []
        for arm, (name, policy) in enumerate(policies):
            dep = dep_lib.CIMDeployment.deploy(flat, policy)
            arm_bits = dep.bit_cost()["stored_bits"]
            dep = dataclasses.replace(
                dep, stores=self._shard_stores(dep.stores), mesh=self.mesh)
            for b, ber in enumerate(plan.bers):
                cell_seeds = seeds[arm][b][self.trials]
                batched = policy_inject_batched(dep, cell_seeds, ber)
                accs, stats = [], []
                for i in range(len(cell_seeds)):
                    restored, st = dep._replace_stores(
                        trial_params(batched, i)).read()
                    stats.append(st)
                    accs.append(float(eval_fn(restored)))
                del batched
                results.append(_cell(
                    ber, "policy", name, accs,
                    [s["corrected"] for s in stats],
                    [s["uncorrectable"] for s in stats],
                    stored_bits=arm_bits))
        return self._gather(results)
