"""Deployment API: put a model's weight matrices on the emulated CIM macro
(port of ``repro/core/deployment.py``, single device).

A :class:`ReliabilityPolicy` maps each leaf path to a :class:`PolicyRule`
(glob or ``re:`` regex, a wildcard-free pattern matching any path segment,
first match wins, then the default). :class:`CIMDeployment` owns the packed
stores and passthrough leaves of a flat ``{path: tensor}`` dict and exposes
deploy / inject / runtime / read / read_rows / stats / linear /
serving_params. :class:`ExpertDeployment` deploys a MoE's stacked expert
weights one macro an expert.

Seeds. The reference splits one ``jax.random`` key over the flat leaves of the
params pytree; the port takes explicit per-path uint32 plane-seed dicts
instead (``{path: {"man", "meta", "cw"}}``). Per-read dynamic seeds fold the
base plane seeds with :func:`request_read_seeds`, exactly as the reference.

Mesh placement. :meth:`CIMDeployment.shard` (:func:`place_stores`) keeps on
each rank of a ``torch.distributed`` mesh (:mod:`repro_torch.launch.mesh`)
its block of every store along ``dim`` of the ``"model"`` axis; every other
leaf stays replicated (each rank holds it whole). ``inject`` and the
per-read runtime then draw each block's streams at global store
coordinates; :func:`dispatch_linear` and :func:`dispatch_read_rows` read the
block and combine over the axis (a gather of column blocks, a sum of K
slabs); ``stats()`` sums each block's ECC counts over the axis.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import align as align_lib
from repro_torch.core import cim as cim_lib
from repro_torch.core import faultmodels as fm_lib
from repro_torch.core import tree
from repro_torch.core.bitops import FORMAT_NAMES, get_format
from repro_torch.models.moe import EXPERT_LEAF_NAMES

VALID_MODES = ("off", "align", "cim")
VALID_PROTECTS = ("one4n", "per_weight", "none")
VALID_FIELDS = ("full", "mantissa", "exponent_sign")
VALID_SERVE_PATHS = ("fused", "hbm")
VALID_INJECTS = ("static", "dynamic")


def check_enum(name: str, value, allowed: Sequence[str], where: str) -> None:
    """Raise ``ValueError`` with the allowed vocabulary on a bad enum value."""
    if value not in allowed:
        raise ValueError(
            f"{where}: {name}={value!r} is not valid; expected one of "
            f"{', '.join(repr(a) for a in allowed)}")


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One per-layer reliability setting, keyed by a leaf-path pattern."""

    pattern: str = "*"
    deploy: bool = True
    protect: str = "one4n"
    field: str = "full"
    ber_scale: float = 1.0
    n_group: int = 8
    index: int = 2
    row_weights: int = 16
    fmt_name: str = "fp16"
    serve_path: str = "fused"
    row_cache: bool = True
    fault_model: str = ""

    def __post_init__(self):
        where = f"PolicyRule(pattern={self.pattern!r})"
        check_enum("protect", self.protect, VALID_PROTECTS, where)
        check_enum("field", self.field, VALID_FIELDS, where)
        check_enum("serve_path", self.serve_path, VALID_SERVE_PATHS, where)
        check_enum("fmt_name", self.fmt_name, FORMAT_NAMES, where)
        if self.ber_scale < 0:
            raise ValueError(f"{where}: ber_scale must be >= 0, "
                             f"got {self.ber_scale}")
        fm_lib.parse_fault_model(self.fault_model)

    @property
    def fault_process(self):
        return fm_lib.parse_fault_model(self.fault_model)

    @property
    def fmt(self):
        return get_format(self.fmt_name)

    @property
    def cim_cfg(self) -> cim_lib.CIMConfig:
        return cim_lib.CIMConfig(n_group=self.n_group, index=self.index,
                                 protect=self.protect, fmt=self.fmt,
                                 row_weights=self.row_weights)

    @property
    def align_cfg(self) -> align_lib.AlignmentConfig:
        return align_lib.AlignmentConfig(n_group=self.n_group,
                                         index=self.index, fmt=self.fmt)

    def matches(self, leaf_path: str) -> bool:
        if self.pattern.startswith("re:"):
            return re.fullmatch(self.pattern[3:], leaf_path) is not None
        if not any(c in self.pattern for c in "*?["):
            return self.pattern == leaf_path or \
                self.pattern in leaf_path.split("/")
        return fnmatch.fnmatchcase(leaf_path, self.pattern)


@dataclasses.dataclass(frozen=True)
class ReliabilityPolicy:
    """Ordered leaf-path rules (first match wins) plus a default rule."""

    rules: Tuple[PolicyRule, ...] = ()
    default: PolicyRule = PolicyRule()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        for r in tuple(self.rules) + (self.default,):
            if not isinstance(r, PolicyRule):
                raise TypeError(f"policy rules must be PolicyRule, got "
                                f"{type(r).__name__}")

    def rule_for(self, leaf_path: str) -> PolicyRule:
        for rule in self.rules:
            if rule.matches(leaf_path):
                return rule
        return self.default

    @property
    def uniform(self) -> bool:
        return not self.rules


def _deployable(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.ndim == 2 and \
        leaf.is_floating_point()


def _is_store(x) -> bool:
    return isinstance(x, cim_lib.CIMStore)


def _add_stats(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in ("corrected", "uncorrectable")}


@dataclasses.dataclass(eq=False)
class CIMDeployment:
    """A flat ``{path: leaf}`` dict deployed under a reliability policy:
    stores for deployed leaves, tensors for passthrough ones, plus the
    cumulative ECC counters that eager reads fold into."""

    stores: Dict[str, object]
    ecc_stats: dict
    policy: ReliabilityPolicy
    rules: Dict[str, Optional[PolicyRule]]
    mesh: object = None                      # the mesh it was placed on

    @classmethod
    def deploy(cls, leaves: Dict[str, torch.Tensor], policy: ReliabilityPolicy,
               predicate: Optional[Callable] = None) -> "CIMDeployment":
        """Align + pack every 2-D float leaf whose rule deploys (and that
        ``predicate(path, leaf)`` admits); other leaves pass through."""
        stores, rules = {}, {}
        for path, leaf in leaves.items():
            rule = policy.rule_for(path)
            if rule.deploy and _deployable(leaf) and \
                    (predicate is None or predicate(path, leaf)):
                w_al, _ = align_lib.align_matrix(leaf, rule.align_cfg)
                stores[path] = cim_lib.pack(w_al, rule.cim_cfg)
                rules[path] = rule
            else:
                stores[path] = leaf
                rules[path] = None
        return cls(stores, {"corrected": 0, "uncorrectable": 0}, policy, rules)

    def _replace_stores(self, stores) -> "CIMDeployment":
        return CIMDeployment(stores, dict(self.ecc_stats), self.policy,
                             self.rules, self.mesh)

    def shard(self, mesh, *, dim: str = "j") -> "CIMDeployment":
        """Mesh placement: this rank keeps its block of every store along
        ``dim`` of the ``"model"`` axis (:func:`place_stores`); passthrough
        leaves stay whole. Later ``inject`` calls draw each block at global
        store coordinates and ``linear`` runs the sharded kernel route."""
        if self.mesh is not None:
            raise ValueError("CIMDeployment.shard: already placed")
        stores = place_stores(self.stores, mesh, dim=dim)
        return CIMDeployment(stores, dict(self.ecc_stats), self.policy,
                             self.rules, mesh)

    def store_leaves(self):
        """[(path, rule, store)] of the deployed leaves."""
        return [(p, self.rules[p], s) for p, s in self.stores.items()
                if _is_store(s)]

    # ------------------------------------------------------------ fault state

    def inject(self, seeds: Dict[str, dict], ber, field: Optional[str] = None,
               model=None) -> "CIMDeployment":
        """Static soft errors into every store at ``ber * rule.ber_scale`` in
        the rule's ``field`` (or ``field`` for all), drawn from that store's
        plane seeds ``seeds[path]``."""
        if field is not None:
            check_enum("field", field, VALID_FIELDS, "CIMDeployment.inject")
        model = fm_lib.parse_fault_model(model)
        out = {}
        for path, leaf in self.stores.items():
            if _is_store(leaf):
                rule = self.rules[path]
                out[path] = cim_lib.inject(
                    seeds[path], leaf, ber * rule.ber_scale,
                    field if field is not None else rule.field,
                    model=model if model is not None else rule.fault_process)
            else:
                out[path] = leaf
        return self._replace_stores(out)

    def runtime(self, seeds: dict, ber, field: str = "full", model=None) -> dict:
        """Per-read dynamic-injection runtime: base plane seeds plus the
        per-cell-class thresholds. A non-i.i.d. ``model`` (process or
        grammar string) rides along under ``"model"``; serving reads compile
        it to per-element thresholds, drift keyed on the read position."""
        check_enum("field", field, VALID_FIELDS, "CIMDeployment.runtime")
        thr_man, thr_meta = cim_lib.field_thresholds(ber, field)
        rt = {"seeds": {k: int(v) for k, v in seeds.items()},
              "thr_man": thr_man, "thr_meta": thr_meta}
        model = fm_lib.parse_fault_model(model)
        if model is not None and model.kind != "iid":
            rt["model"] = model
        return rt

    # ------------------------------------------------------------ read paths

    def _accumulate(self, stats) -> None:
        self.ecc_stats = _add_stats(self.ecc_stats, stats)

    def read(self):
        """Decode every store -> ({path: tensor}, aggregated stats); on a
        mesh each rank decodes its blocks and the matrices and counts are
        combined over the axis, so every rank gets the whole."""
        out, stats = {}, {"corrected": 0, "uncorrectable": 0}
        for path, leaf in self.stores.items():
            if _is_store(leaf):
                w, st = read_placed(leaf, self.mesh)
                out[path] = w
                stats = _add_stats(stats, st)
            else:
                out[path] = leaf
        self._accumulate(stats)
        return out, stats

    def stats(self) -> dict:
        """Aggregate ECC status counts without reconstructing weights (a
        sharded store's blocks summed over the mesh axis)."""
        agg = {"corrected": 0, "uncorrectable": 0}
        for _, _, s in self.store_leaves():
            agg = _add_stats(agg, store_stats_placed(s, self.mesh))
        return agg

    def _leaf(self, path: str):
        if path not in self.stores:
            raise KeyError(f"no leaf at path {path!r}; deployment has "
                           f"{sorted(self.stores)}")
        return self.stores[path], self.rules[path]

    def read_rows(self, idx, path: str = "embed", *, seeds=None, thr_man=0,
                  thr_meta=0, model=None):
        leaf, _ = self._leaf(path)
        if not _is_store(leaf):
            return leaf.to(torch.float32)[idx]
        return dispatch_read_rows(leaf, idx, seeds=seeds, thr_man=thr_man,
                                  thr_meta=thr_meta, model=model,
                                  mesh=self.mesh)

    def linear(self, x, path: str, *, scalars=None, request=None, runtime=None,
               with_info: bool = False, model=None):
        """``x [..., K] @ leaf(path) -> [..., J]``, route auto-dispatched
        (:func:`dispatch_linear`; ``serve_path='hbm'`` decodes once).
        ``request=(req_salt, pos)`` with a ``runtime`` derives the per-read
        dynamic-injection scalars of that read, under the runtime's fault
        process: a drift model's tick is the read position ``pos``, folded
        into the thresholds here, and the model handed on carries tick 0."""
        from repro_torch.kernels.cim_read import ops as cr_ops
        if request is not None:
            if scalars is not None:
                raise ValueError(f"linear({path!r}): pass either scalars= or "
                                 f"request=, not both")
            if runtime is None:
                raise ValueError(f"linear({path!r}): request= needs the "
                                 f"runtime= dict (see CIMDeployment.runtime)")
            req_salt, pos = request
            seeds = request_read_seeds(runtime["seeds"], leaf_salt(path),
                                       req_salt, pos)
            thr_man, thr_meta, model = read_thresholds(runtime, pos)
            scalars = cr_ops.make_scalars(seeds, thr_man, thr_meta,
                                          model=model)
        leaf, rule = self._leaf(path)
        if not _is_store(leaf):
            if scalars is not None:
                raise ValueError(f"linear({path!r}): scalars given, but the "
                                 f"leaf is a passthrough — no stored cells")
            out = x @ leaf.to(x.dtype)
            return (out, {"route": "passthrough"}) if with_info else out
        if rule.serve_path == "hbm":
            if scalars is not None:
                raise ValueError(f"linear({path!r}): scalars given, but the "
                                 f"rule pins serve_path='hbm'")
            w, st = read_placed(leaf, self.mesh)
            self._accumulate(st)
            out = x.to(torch.float32) @ w
            return (out, {"route": "hbm"}) if with_info else out
        return dispatch_linear(x, leaf, scalars=scalars, with_info=with_info,
                               model=model, mesh=self.mesh)

    # ------------------------------------------------------------ serving

    def serving_params(self, *, dynamic_seeds=None, ber: float = 0.0,
                       field: str = "full", row_cache: bool = True,
                       model=None) -> dict:
        """The ``{path: leaf}`` dict the model's steps read.

        Fused rules keep their stores packed; ``serve_path='hbm'`` rules are
        decoded up front. Static fused serving warms the decoded-row cache of
        stores whose rule has ``row_cache=True`` (dispatch then serves a
        plain matmul against it). With ``dynamic_seeds`` and ``ber > 0`` the
        ``_cim`` per-read dynamic-injection runtime rides along and every
        read bypasses the cache."""
        dynamic = dynamic_seeds is not None and ber > 0
        out = {}
        for path, leaf in self.stores.items():
            rule = self.rules[path]
            if _is_store(leaf) and rule.serve_path == "hbm":
                w, st = read_placed(leaf, self.mesh)
                self._accumulate(st)
                out[path] = w
            elif (_is_store(leaf) and rule.serve_path == "fused" and row_cache
                  and rule.row_cache and not dynamic and leaf.cache is None):
                out[path] = cim_lib.build_row_cache(leaf)
            else:
                out[path] = leaf
        if dynamic:
            out["_cim"] = self.runtime(dynamic_seeds, ber, field, model=model)
        return out

    # ------------------------------------------------------------ accounting

    def bit_cost(self) -> dict:
        stored = raw = byts = 0
        for _, rule, s in self.store_leaves():
            stored += s.stored_bits
            raw += int(np.prod(s.shape)) * rule.fmt.total_bits
            byts += s.stored_bytes
        return {"stored_bits": int(stored), "raw_bits": int(raw),
                "stored_bytes": int(byts),
                "overhead": (stored / raw - 1.0) if raw else 0.0}


def place_stores(stores: Dict[str, object], mesh, *,
                 dim: str = "j") -> Dict[str, object]:
    """Mesh placement of a ``{path: leaf}`` dict: each store this rank's
    block along ``dim`` of ``"model"`` (``cim.shard_store``) where the sharded
    kernel route takes it (``ops.sharded_route``: one4n / none fp16 planes
    that split evenly), else whole with a ``ShardInfo`` that says so (every
    rank reads it whole, as the reference routes it); every other leaf as it
    is (replicated: each rank holds it). The single placement rule behind
    :meth:`CIMDeployment.shard` and the serve launcher's ``--mesh``."""
    from repro_torch.distributed import sharding as shlib
    from repro_torch.kernels.cim_read import ops as cr_ops
    n = shlib.axis_size(shlib.MODEL_AXIS, mesh)
    i = shlib.axis_index(shlib.MODEL_AXIS, mesh)
    out = {}
    for path, leaf in stores.items():
        if _is_store(leaf):
            leaf = cim_lib.shard_store(
                leaf, n, i, dim, split=cr_ops.sharded_route(leaf, n, dim))
        out[path] = leaf
    return out


def _placed_mesh(mesh):
    """The mesh a placed store combines over (over its ``"model"`` axis):
    ``mesh``, or the ambient one."""
    if mesh is None:
        from repro_torch.distributed import sharding as shlib
        mesh = shlib.get_mesh()
    if mesh is None:
        raise ValueError("a sharded store is combined over its mesh: pass "
                         "mesh= or set_mesh (distributed.sharding)")
    return mesh


def store_stats_placed(store, mesh=None) -> dict:
    """ECC counts of a store; a sharded block's summed over ``"model"``."""
    st = cim_lib.store_stats(store)
    sh = store.shard
    if sh is None or not sh.sharded:
        return st
    from repro_torch.distributed import sharding as shlib
    return shlib.sum_counts(st, shlib.MODEL_AXIS, _placed_mesh(mesh))


def read_placed(store, mesh=None):
    """``cim.read`` of a store; a sharded block's decode is gathered (``'j'``)
    or stacked (``'k'``) over ``"model"`` into the whole matrix, and its
    counts summed."""
    w, st = cim_lib.read(store)
    sh = store.shard
    if sh is None or not sh.sharded:
        return w, st
    from repro_torch.distributed import sharding as shlib
    mesh = _placed_mesh(mesh)
    k, j = sh.global_shape
    w = shlib.all_gather_cat(w.contiguous(), shlib.MODEL_AXIS, mesh,
                             dim=sh.sdim)[:k, :j]
    return w, shlib.sum_counts(st, shlib.MODEL_AXIS, mesh)


# ---------------------------------------------------------------------------
# Expert-parallel MoE deployment: each expert is its own macro.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ExpertDeployment:
    """Per-expert CIM deployment of a model's stacked MoE weights.

    Every stacked expert tensor (:data:`EXPERT_LEAF_NAMES`, ``[E, D, F]`` or
    ``[G, E, D, F]``) is sliced into per-expert 2-D matrices at paths like
    ``groups/blk0/moe/moe_win/g0/expert3`` and deployed through one
    :class:`CIMDeployment`, so :class:`ReliabilityPolicy` rules match the
    per-expert paths (``PolicyRule("*/expert3", ber_scale=4.0)`` ages one
    expert across all its matrices).

    Serving is decode-once: :meth:`serving_params` reads every expert store
    back and restacks the dense tensors, which the MoE's dispatch consumes
    unchanged. Injection is therefore static only, as the reference's: the
    faults are a property of the image, not of the read, so the engine's
    bitwise solo-vs-co-batched guarantee holds. :meth:`stats_by_expert`
    gives each expert store's ECC counters."""

    inner: CIMDeployment
    leaves: Tuple[Tuple[str, tuple], ...]   # (params path, stacked shape)

    @classmethod
    def deploy(cls, params: Dict[str, torch.Tensor],
               policy: ReliabilityPolicy) -> "ExpertDeployment":
        """Slice and deploy every stacked expert tensor of the flat
        reference-layout ``params``; raises if there is none (deploying
        nothing would serve unprotected experts silently)."""
        expert, meta = {}, []
        for p, leaf in params.items():
            if _is_store(leaf) or p.split("/")[-1] not in EXPERT_LEAF_NAMES \
                    or getattr(leaf, "ndim", 0) not in (3, 4):
                continue
            if leaf.ndim == 4:                       # [G, E, D, F]
                for g in range(leaf.shape[0]):
                    for e in range(leaf.shape[1]):
                        expert[f"{p}/g{g}/expert{e}"] = leaf[g, e]
            else:                                    # [E, D, F]
                for e in range(leaf.shape[0]):
                    expert[f"{p}/expert{e}"] = leaf[e]
            meta.append((p, tuple(leaf.shape)))
        if not expert:
            raise ValueError(
                "ExpertDeployment.deploy: params has no stacked MoE expert "
                f"leaves (looked for {', '.join(EXPERT_LEAF_NAMES)})")
        return cls(inner=CIMDeployment.deploy(tree.flatten(expert), policy),
                   leaves=tuple(meta))

    def inject(self, seeds: Dict[str, dict], ber, field: Optional[str] = None,
               model=None) -> "ExpertDeployment":
        """Static soft errors into every expert store (per-rule BER scales
        apply), from each store's plane seeds ``seeds[path]``."""
        return ExpertDeployment(
            inner=self.inner.inject(seeds, ber, field=field, model=model),
            leaves=self.leaves)

    def serving_params(self, params: Optional[dict] = None) -> dict:
        """``params`` (a serving dict; stores and ``_cim`` pass through) with
        every expert leaf recorded at deploy time set to its restacked
        decoded tensor. The read's ECC counts fold into the inner
        deployment's counters."""
        decoded, _ = self.inner.read()
        out = dict(params or {})
        for p, shape in self.leaves:
            if len(shape) == 4:
                w = torch.stack([torch.stack(
                    [decoded[f"{p}/g{g}/expert{e}"] for e in range(shape[1])])
                    for g in range(shape[0])])
            else:
                w = torch.stack([decoded[f"{p}/expert{e}"]
                                 for e in range(shape[0])])
            out[p] = w
        return out

    def stats_by_expert(self) -> dict:
        """Per-expert-store ECC counters: path -> counts + rule settings."""
        out = {}
        for p, rule, s in self.inner.store_leaves():
            st = cim_lib.store_stats(s)
            out[p] = {"corrected": int(st["corrected"]),
                      "uncorrectable": int(st["uncorrectable"]),
                      "protect": rule.protect, "ber_scale": rule.ber_scale}
        return out


# ---------------------------------------------------------------------------
# Per-request counter-PRNG seed derivation:
#   plane seed --fold leaf_salt--> --fold request_salt--> --fold pos--> seed
# (every link cim.fold_seed; no request salt skips that link). The serving
# engine salts decode reads with ``request_salt(rid)`` and prompt-prefill
# reads with ``prefix_salt`` of the prompt tokens up through the chunk, so two
# requests that share a prompt prefix draw the same streams over it.
# ---------------------------------------------------------------------------

CIM_LEAF_SALTS = {"embed": 0x1001, "unembed": 0x2002}
_REQUEST_SALT_CONST = 0x7FEED5A1
_PREFIX_SALT_CONST = 0x5EEDC0DE


def leaf_salt(path: str) -> int:
    """Per-macro seed salt of a deployed leaf (FNV-1a of the path for paths
    other than embed/unembed)."""
    if path in CIM_LEAF_SALTS:
        return CIM_LEAF_SALTS[path]
    h = 0x811C9DC5
    for ch in path.encode():
        h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
    return h


def request_salt(request_id: int) -> int:
    """uint32 counter-PRNG salt of a serving request id."""
    return cim_lib.fold_seed(_REQUEST_SALT_CONST, request_id)


def prefix_salt(tokens) -> int:
    """uint32 content salt of a prompt prefix: FNV-1a over the token ids as
    little-endian uint32 words, seeded off its own constant so prefix
    streams never alias the ``request_salt`` family. A pure function of the
    tokens: independent of request id, slot and arrival order."""
    h = (0x811C9DC5 ^ _PREFIX_SALT_CONST) & 0xFFFFFFFF
    for b in np.asarray(tokens).astype("<u4").tobytes():
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def read_thresholds(runtime: dict, pos: int):
    """``(thr_man, thr_meta, model)`` of the read at position ``pos`` under
    a dynamic runtime: drift keys its tick on ``pos`` and the thresholds
    absorb that time scaling, so the model handed downstream carries tick 0
    (no double scaling); other processes pass through."""
    model = runtime.get("model")
    thr_man = fm_lib.compiled_threshold(model, runtime["thr_man"], tick=pos)
    thr_meta = fm_lib.compiled_threshold(model, runtime["thr_meta"], tick=pos)
    if model is not None and model.kind == "drift":
        model = dataclasses.replace(model, tick=0)
    return thr_man, thr_meta, model


def request_read_seeds(seeds: dict, leaf_salt_: int, req_salt, pos) -> dict:
    """Fold base plane seeds down to one (leaf, request, read) stream set."""
    out = {k: cim_lib.fold_seed(v, leaf_salt_) for k, v in seeds.items()}
    if req_salt is not None:
        out = {k: cim_lib.fold_seed(v, req_salt) for k, v in out.items()}
    return {k: cim_lib.fold_seed(v, pos) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Dispatch: the single place that picks the route of a CIM matmul or gather.
# ---------------------------------------------------------------------------


def dispatch_linear(x, store, *, scalars=None, with_info: bool = False,
                    model=None, mesh=None):
    """Route ``x @ store``: a store placed on a mesh (a ``ShardInfo``) goes
    to :func:`cim_linear_store_sharded` over ``"model"`` of ``mesh`` (the
    ambient mesh by default), as the reference sends every read on a mesh
    to its sharded route; otherwise a warmed decoded-row cache serves
    static reads as a plain matmul and everything else goes to
    :func:`cim_linear_store` (the fused kernel on the card). Dynamic
    ``scalars`` always bypass the cache."""
    from repro_torch.kernels.cim_read import ops as cr_ops
    if store.shard is not None:
        return cr_ops.cim_linear_store_sharded(
            x, store, scalars=scalars, model=model, mesh=_placed_mesh(mesh),
            with_info=with_info, device=store.device)
    if scalars is None and store.cache is not None:
        b_shape = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        out = (x2 @ store.cache).reshape(*b_shape, store.shape[1])
        if with_info:
            return out, {"used_kernel": False, "route": "cached"}
        return out
    return cr_ops.cim_linear_store(x, store, scalars=scalars,
                                   with_info=with_info, model=model,
                                   device=store.device)


def dispatch_read_rows(store, idx, *, seeds=None, thr_man=0, thr_meta=0,
                       model=None, mesh=None):
    """Row-gather route: decode-on-read off the packed image; a warmed cache
    serves static gathers. A column shard decodes its block of the rows at
    global coordinates and the blocks are gathered over ``"model"``."""
    if seeds is None and store.cache is not None:
        rows = store.cache[idx]
    else:
        rows = cim_lib.read_rows(store, idx, seeds=seeds, thr_man=thr_man,
                                 thr_meta=thr_meta, model=model)
    sh = store.shard
    if sh is None or not sh.sharded:
        return rows
    from repro_torch.distributed import sharding as shlib
    return shlib.all_gather_cat(rows.contiguous(), shlib.MODEL_AXIS,
                                _placed_mesh(mesh),
                                dim=-1)[..., :sh.global_shape[1]]


# ---------------------------------------------------------------------------
# Training-time dynamic fault schedule (paper Fig. 7), policy-aware.
# ---------------------------------------------------------------------------

# fold indices of the schedule's two cell classes (the reference splits its
# step key in two, exponent/sign first)
_SCHEDULE_FIELDS = ("exponent_sign", "mantissa")


def _residual_ber(ber: float, rule) -> float:
    """Post-ECC exponent/sign rate of ``ber`` under ``rule``'s protection
    (a :class:`PolicyRule`, or a ``ReliabilityConfig``: anything with
    ``protect`` and ``cim_cfg``)."""
    from repro_torch.core.ecc import residual_ber_after_secded
    if rule.protect == "one4n":
        return residual_ber_after_secded(ber, codec=rule.cim_cfg.codec)
    if rule.protect == "per_weight":
        return residual_ber_after_secded(ber, codeword_bits=rule.cim_cfg
                                         .pw_code.n)
    return ber


def training_fault_schedule(rel) -> Optional[Callable]:
    """Per-step weight corruption for dynamic-injection training, or None:
    ``corrupt(params, step_seed) -> params`` over a ``{path: tensor}`` tree.

    Each deployed injectable leaf sees ITS rule's post-ECC residual rate on
    the exponent/sign field and ``ber * ber_scale`` on the mantissa,
    restricted to the rule's field, as ``CIMDeployment.inject`` on the same
    policy. The reference's legacy uniform branch (exponent/sign at
    ``rel.residual_exp_ber``, mantissa at ``rel.ber``) gives the same rates
    for every uniform policy that ``ReliabilityConfig`` builds from its
    scalar fields or ``from_policy``, so the port keeps this one path.

    The draws go through :func:`repro_torch.core.fault.inject` (on the
    card one K4 launch a leaf and field, its counter chunks one run table,
    the fp32 <-> fp16 round trip fused into it): field ``f`` (0
    exponent/sign, 1 mantissa) of leaf ``i`` in flatten order draws from
    ``fold_seed(fold_seed(step_seed, f), i)``.
    The reference draws ``jax.random`` streams here, so the port holds it
    to its rates, not its bits. ``corrupt.rates(path, leaf)`` gives a
    leaf's (exponent/sign, mantissa) rates, 0 where it is not drawn.
    ``corrupt(blocks, step_seed, layouts)`` corrupts the blocks of a
    sharded tree (``{path: Layout}``) in place, each with exactly the
    flips of its region of the one-device draw (:func:`repro_torch.core.
    fault.inject_block`: one K4 launch a block and field over the table of
    its runs of rows, in place with no temporary); a sharded state is the
    step's to consume."""
    from repro_torch.core import fault as fault_lib
    if rel.mode != "cim" or rel.ber <= 0 or rel.inject != "dynamic":
        return None
    policy = rel.policy

    def rates(path, leaf):
        """(exponent/sign rate, mantissa rate) of one leaf."""
        if not fault_lib._is_injectable(path, leaf):
            return 0.0, 0.0
        rule = policy.rule_for(path)
        if not rule.deploy:
            return 0.0, 0.0
        b = rel.ber * rule.ber_scale
        return (_residual_ber(b, rule)
                if rule.field in ("full", "exponent_sign") else 0.0,
                b if rule.field in ("full", "mantissa") else 0.0)

    def corrupt(params, step_seed: int, layouts=None) -> dict:
        seeds = [cim_lib.fold_seed(step_seed, f)
                 for f in range(len(_SCHEDULE_FIELDS))]
        out = {}
        for i, (path, leaf) in enumerate(params.items()):
            for f, ber in enumerate(rates(path, leaf)):
                seed = cim_lib.fold_seed(seeds[f], i)
                fmt = policy.rule_for(path).fmt
                if layouts is None:
                    leaf = fault_lib.inject(seed, leaf, ber,
                                            _SCHEDULE_FIELDS[f], fmt)
                else:
                    leaf = fault_lib.inject_block(
                        seed, leaf, layouts[path], ber, _SCHEDULE_FIELDS[f],
                        fmt, in_place=True)
            out[path] = leaf
        return out

    corrupt.rates = rates
    return corrupt
