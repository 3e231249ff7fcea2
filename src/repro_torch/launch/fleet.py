"""Fleet serving: data-parallel engine replicas behind an SLO-aware router
(port of ``repro/launch/fleet.py``, replicas on one device).

One deployed CIM image serves N :class:`~repro_torch.launch.engine.Engine`
replicas. The serving params are spooled once to the checkpoint format
(:mod:`repro_torch.distributed.checkpoint`) and each replica restores its
own copy onto the model's device, so a swap on one replica (a scrub, an
aging tick) never touches another's. The replicas share the read-only
:class:`~repro_torch.models.lm.LM` module. They are identical by
construction: the same packed planes, ECC state and dynamic seed table.

**Router.** Arrived requests go to the admitting replica with the lowest
score ``(depth + 1) * max(EWMA TTFT, 1e-3)``: queue depth is the load
signal, and the per-replica TTFT EWMA (wall clock) folds in how fast the
replica has been serving. Ties break on the replica name.

**Replica invariance.** A request's tokens, logits, fault streams and ECC
charges do not depend on the replica that serves it, on whether its prefix
came from a trie, or on a drain and re-admission elsewhere: every replica
restores the same image, runs the same model at the same ``n_slots``, and
every fault stream keys on (leaf, content or request salt, position).

**Drain and re-admit.** The router heartbeats every live replica into an
:class:`~repro_torch.distributed.elastic.ElasticCoordinator`; a replica
that misses the deadline, or is force-failed, drains: its queued and
in-flight requests return to the router queue in arrival order and re-route
to the survivors. A recovered heartbeat re-admits it.

**Throughput.** ``aggregate()`` reports the wall tok/s and
``tok_s_virtual`` = total tokens / the busiest replica's wall time inside
its engine: replicas on disjoint devices would run concurrently, so the
busiest one's time would be the fleet's, while here the router steps them
in turn.

**Per-replica meshes** (``make_fleet_meshes("DxM", n)``, one process a
card): the world splits into n disjoint blocks of D x M ranks, replica i on
ranks ``[i*D*M, (i+1)*D*M)``, and each replica's engine serves its block as
a ``("data", "model")`` mesh (:class:`~repro_torch.launch.engine.Engine`'s
mesh). A rank holds its own replica's engine only; the others are known
to it by what the ranks exchange. Every router cycle starts with one
gather over the world: rank 0's clock (the cycle's ``now``), and from the
first rank of each replica its queue depth, busy time and the results it
finished. Every rank then folds in the same results in the same order,
so every rank's router state (TTFT EWMAs, depths) is the same, and routes
the same way: the ranks of a replica step one schedule. Every rank ends
with every request's result.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.elastic import ElasticCoordinator
from repro_torch.launch.engine import Engine, Request, RequestResult

class FleetError(RuntimeError):
    """No admitting replica for arrived work."""


def _parse_spec(spec: str) -> Tuple[int, int]:
    try:
        d_ax, m_ax = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"fleet mesh {spec!r}: expected DxM, e.g. 1x4") \
            from None
    return d_ax, m_ax


class FleetMeshes(list):
    """What :func:`make_fleet_meshes` returns: a list of n entries like the
    reference's, where entry i is replica i's ``("data", "model")`` mesh on
    the ranks of replica i and None on every other rank (a rank holds only
    its own replica's mesh). ``fleet`` is the ``("replica", "data",
    "model")`` mesh over the world the router gathers over, ``replica``
    this rank's replica."""

    def __init__(self, meshes, fleet, replica: int):
        super().__init__(meshes)
        self.fleet = fleet
        self.replica = replica


def make_fleet_meshes(spec: str, n_replicas: int,
                      device_type: str = "cuda") -> FleetMeshes:
    """``"DxM"`` per-replica meshes over DISJOINT blocks of the world:
    replica i on ranks ``[i*D*M, (i+1)*D*M)`` (the reference's device
    blocks). The world must hold exactly n x D x M ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as mesh_lib
    d_ax, m_ax = _parse_spec(spec)
    need = n_replicas * d_ax * m_ax
    world = mesh_lib.init_world(device_type)
    if n_replicas < 1 or need != world:
        raise ValueError(f"a fleet of {n_replicas} x mesh {spec} needs "
                         f"{need} ranks (devices); the world has {world}")
    full = init_device_mesh(device_type, (n_replicas, d_ax, m_ax),
                            mesh_dim_names=("replica", "data", "model"))
    i = full.get_local_rank("replica")
    own = full["data", "model"]
    return FleetMeshes([own if k == i else None for k in range(n_replicas)],
                       full, i)


def thread_fleet_meshes(spec: str, n_replicas: int) -> List[FleetMeshes]:
    """:func:`make_fleet_meshes` for a fleet whose ranks run in threads of
    this process (``sharding.thread_ranks``): one :class:`FleetMeshes` a
    rank, in rank order; each replica's mesh has its own in-process group,
    the fleet mesh one over every thread."""
    d_ax, m_ax = _parse_spec(spec)
    per = d_ax * m_ax
    world = shlib.thread_ranks(("replica", "data", "model"),
                               (n_replicas, d_ax, m_ax))
    blocks = [shlib.thread_ranks(("data", "model"), (d_ax, m_ax))
              for _ in range(n_replicas)]
    return [FleetMeshes([blocks[r // per][r % per] if k == r // per else None
                         for k in range(n_replicas)], w, r // per)
            for r, w in enumerate(world)]


@dataclasses.dataclass
class Replica:
    """One engine and the router's view of its service rate. On a fleet
    over meshes a replica of another block has no engine here (None): its
    depth is what its ranks last reported, plus what was routed to it
    since."""

    name: str
    engine: Optional[Engine]
    ewma_ttft: float = 0.0
    served: int = 0
    busy_s: float = 0.0               # wall seconds inside this engine
    reported_depth: Optional[int] = None   # set on a fleet over meshes

    @property
    def depth(self) -> int:
        return self.engine.depth if self.reported_depth is None \
            else self.reported_depth

    def submit(self, req: Request, now: float) -> None:
        if self.engine is not None:
            self.engine.submit(req, now=now)
        if self.reported_depth is not None:
            self.reported_depth += 1

    def observe_ttft(self, ttft: float, alpha: float) -> None:
        self.ewma_ttft = ttft if self.served == 0 else \
            (1 - alpha) * self.ewma_ttft + alpha * ttft
        self.served += 1

    def score(self) -> float:
        """Lower is more attractive: queue depth x demonstrated TTFT."""
        return (self.depth + 1) * max(self.ewma_ttft, 1e-3)


class Fleet:
    """N data-parallel engine replicas behind the SLO-aware router."""

    def __init__(self, replicas: List[Replica], *,
                 heartbeat_timeout: float = 60.0, ewma_alpha: float = 0.25,
                 max_depth: Optional[int] = None,
                 spool_dir: Optional[str] = None, world=None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: Dict[str, Replica] = {r.name: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise ValueError("duplicate replica names")
        self.coordinator = ElasticCoordinator(
            [r.name for r in replicas], model_axis=1,
            heartbeat_timeout=heartbeat_timeout)
        self.ewma_alpha = ewma_alpha
        self.max_depth = max_depth
        self.spool_dir = spool_dir
        self.spool: Dict[str, float] = {}      # bytes, save_s, restore_s
        self._admitting = {r.name for r in replicas}
        self._suppressed: set = set()     # force-failed: no heartbeats
        self._queue: List[Tuple[Request, float]] = []   # (req, submit_t)
        self.results: Dict[int, RequestResult] = {}
        self.routed: Dict[int, str] = {}  # rid -> the replica that finished it
        self.drains = 0
        self.requeued = 0
        self._open_loop = False
        # the fleet mesh over the world (make_fleet_meshes), or None
        self.world = world
        if world is not None:
            for r in replicas:
                r.reported_depth = 0

    # ------------------------------------------------------------ build

    @classmethod
    def from_serving_params(cls, model, sparams, *, n_replicas: int,
                            meshes=None, spool_dir: Optional[str] = None,
                            prefix_cache: bool = True,
                            heartbeat_timeout: float = 60.0,
                            ewma_alpha: float = 0.25,
                            max_depth: Optional[int] = None,
                            **engine_kw) -> "Fleet":
        """Spool ``sparams`` once (unless ``spool_dir`` already holds a
        spool), restore one copy per replica onto the model's device and
        build the engines. ``engine_kw`` goes to every :class:`Engine`
        (``n_slots``, ``max_len``, ``chunk``, ...).

        ``meshes`` (:func:`make_fleet_meshes`) builds this rank's replica
        only, its engine on its block's mesh over ``sparams`` (this rank's
        blocks, placed on that mesh); each rank spools its own params
        (under ``spool_dir/rank<r>`` when a directory is given)."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        world = None
        if meshes is not None:
            if len(meshes) != n_replicas or not isinstance(meshes,
                                                           FleetMeshes):
                raise ValueError(f"meshes: expected make_fleet_meshes' "
                                 f"{n_replicas} entries")
            world = meshes.fleet
            if spool_dir is not None:
                import torch.distributed as dist
                rank = world.rank if isinstance(world, shlib.ThreadMesh) \
                    else dist.get_rank()
                spool_dir = os.path.join(spool_dir, f"rank{rank}")
        spool = spool_dir or tempfile.mkdtemp(prefix="fleet_spool_")
        device = model.embed.device
        t0 = time.perf_counter()
        if ckpt_lib.latest_step(spool) is None:
            ckpt_lib.save(sparams, 0, spool)
        save_s = time.perf_counter() - t0
        replicas, restore_s = [], 0.0
        for i in range(n_replicas):
            name = f"replica{i}"
            if meshes is not None and meshes[i] is None:
                replicas.append(Replica(name=name, engine=None))
                continue
            t0 = time.perf_counter()
            params, _ = ckpt_lib.restore(sparams, spool, device=device)
            restore_s += time.perf_counter() - t0
            kw = dict(engine_kw)
            if meshes is not None:
                kw["mesh"] = meshes[i]
            eng = Engine(model, params, replica=name,
                         prefix_cache=True if prefix_cache else None, **kw)
            replicas.append(Replica(name=name, engine=eng))
        fleet = cls(replicas, heartbeat_timeout=heartbeat_timeout,
                    ewma_alpha=ewma_alpha, max_depth=max_depth,
                    spool_dir=spool, world=world)
        fleet.spool = {"bytes": ckpt_lib.step_bytes(spool), "save_s": save_s,
                       "restore_s": restore_s}
        return fleet

    # ------------------------------------------------------------ elasticity

    def _drain(self, name: str) -> None:
        """Pull a replica's queued and in-flight work back to the router."""
        if self.replicas[name].engine is None:
            raise FleetError(f"{name} serves another block of the world: "
                             f"draining a replica on a fleet over meshes is "
                             f"not ported (ROADMAP Queue 1 item 14b-3)")
        self._admitting.discard(name)
        back = self.replicas[name].engine.drain()
        self.drains += 1
        self.requeued += len(back)
        for req in back:
            self._queue.append((req, req.arrival if self._open_loop else 0.0))
        self._queue.sort(key=lambda e: (e[1], e[0].arrival, e[0].rid))

    def fail(self, name: str) -> None:
        """A simulated outage: stop heartbeats, force-fail, drain now."""
        if name not in self.replicas:
            raise KeyError(f"no replica {name!r}")
        self._suppressed.add(name)
        self.coordinator.mark_failed(name)
        self._drain(name)

    def recover(self, name: str) -> None:
        """End a simulated outage; the next tick's heartbeat re-admits."""
        self._suppressed.discard(name)

    # ------------------------------------------------------------ routing

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def start(self) -> None:
        """Pin one time base fleet-wide (every engine's clock origin)."""
        self._t0 = time.perf_counter()
        for rep in self.replicas.values():
            if rep.engine is not None:
                rep.engine.start(self._t0)

    def submit(self, req: Request) -> None:
        """Queue a request at the router (arrival-gated under open loop)."""
        self._queue.append((req, req.arrival if self._open_loop else 0.0))
        self._queue.sort(key=lambda e: (e[1], e[0].arrival, e[0].rid))

    def _route(self, now: float) -> List[int]:
        routed = []
        while self._queue:
            req, submit_t = self._queue[0]
            if submit_t > now:
                break
            cands = [r for r in self.replicas.values()
                     if r.name in self._admitting
                     and (self.max_depth is None
                          or r.depth < self.max_depth)]
            if not cands:
                if not self._admitting:
                    raise FleetError(
                        f"request {req.rid} arrived with no admitting "
                        f"replica (all drained, none recovered)")
                break                      # backpressure: retry next tick
            best = min(cands, key=lambda r: (r.score(), r.name))
            self._queue.pop(0)
            best.submit(req, submit_t)
            routed.append(req.rid)
        return routed

    def tick(self, now: Optional[float] = None) -> dict:
        """One router cycle: heartbeat, drain failures, re-admit
        recoveries, route arrivals, step every busy replica once. On a
        fleet over meshes this rank's replica alone steps, and the results
        it finishes are handed on at the next gather (:meth:`_gather`)."""
        if now is None:
            now = self._clock()
        for name in self.replicas:
            if name not in self._suppressed:
                self.coordinator.heartbeat(name)
        for name in self.coordinator.check():
            self._drain(name)
        for name in self.coordinator.drain_recovered():
            self._admitting.add(name)
        routed = self._route(now)
        stepped, finished = [], []
        for rep in self.replicas.values():
            if rep.engine is None or not rep.engine.busy:
                continue
            t0 = time.perf_counter()
            ev = rep.engine.step(now=now)
            rep.busy_s += time.perf_counter() - t0
            stepped.append(rep.name)
            for rid in ev["evicted"]:
                res = rep.engine.results[rid]
                if self.world is not None:
                    self._outbox.append((rid, res))
                else:
                    self._finish(rep, rid, res)
                finished.append(rid)
        return {"routed": routed, "stepped": stepped, "finished": finished}

    def _finish(self, rep: Replica, rid: int, res: RequestResult) -> None:
        self.results[rid] = res
        self.routed[rid] = rep.name
        rep.observe_ttft(res.ttft_s, self.ewma_alpha)

    def _gather(self) -> float:
        """The fleet-over-meshes cycle's one exchange: every rank sends its
        clock, and its replica's depth, busy time and newly finished
        results; every rank folds in, replica by replica in name order,
        those of each replica's first rank. Returns rank 0's clock."""
        own = next(r for r in self.replicas.values() if r.engine is not None)
        got = shlib.all_gather_world(
            {"now": self._clock(), "replica": own.name,
             "depth": own.engine.depth, "busy_s": own.busy_s,
             "finished": self._outbox}, self.world)
        self._outbox = []
        first = {}
        for g in got:
            first.setdefault(g["replica"], g)
        for name in sorted(first):
            rep, g = self.replicas[name], first[name]
            rep.reported_depth = g["depth"]
            rep.busy_s = g["busy_s"]
            for rid, res in g["finished"]:
                self._finish(rep, rid, res)
        return got[0]["now"]

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(r.depth > 0
                                        for r in self.replicas.values())

    def run(self, requests, *, open_loop: bool = False
            ) -> Tuple[Dict[int, RequestResult], dict]:
        """Serve ``requests`` to completion -> (results by rid, aggregate).
        On a fleet over meshes each cycle starts with :meth:`_gather` and
        runs at rank 0's clock, so every rank routes alike."""
        self._open_loop = open_loop
        self._outbox: List[Tuple[int, RequestResult]] = []
        self.start()
        for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(req)
        while True:
            now = self._gather() if self.world is not None else None
            if not self.busy:
                break
            ev = self.tick(now)
            if not ev["stepped"] and self._queue:
                # open loop: the next arrival is in the future
                wait = self._queue[0][1] - self._clock()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return self.results, self.aggregate()

    # ------------------------------------------------------------ reporting

    def aggregate(self) -> dict:
        res = list(self.results.values())
        ttfts = np.asarray([r.ttft_s for r in res]) if res else np.zeros(1)
        total_tok = sum(len(r.tokens) for r in res)
        wall = self._clock() if hasattr(self, "_t0") else 0.0
        # this rank's engines (on a fleet over meshes, its replica's)
        per = {name: rep.engine.aggregate()
               for name, rep in self.replicas.items()
               if rep.engine is not None}
        busy_wall = max((rep.busy_s for rep in self.replicas.values()),
                        default=0.0)
        return {
            "n_replicas": len(self.replicas),
            "n_requests": len(res),
            "total_tokens": total_tok,
            "wall_s": wall,
            "busy_wall_s": busy_wall,
            "tok_s": total_tok / wall if wall > 0 else 0.0,
            # replicas on disjoint devices: the busiest one's time is the
            # fleet's (see the module doc)
            "tok_s_virtual": total_tok / busy_wall if busy_wall > 0 else 0.0,
            "ttft_s_mean": float(ttfts.mean()),
            "ttft_s_p95": float(np.percentile(ttfts, 95)),
            "ttft_s_p99": float(np.percentile(ttfts, 99)),
            "requests_by_replica": {
                name: sum(1 for r in res if r.replica == name)
                for name in self.replicas},
            "drains": self.drains,
            "requeued": self.requeued,
            "prefix_hits": sum(1 for r in res if r.prefix_tokens > 0),
            "prefix_tokens": sum(r.prefix_tokens for r in res),
            "scrub": {
                key: sum(p["scrub"][key] for p in per.values())
                for key in ("events", "rows_reencoded", "corrected_cleared",
                            "uncorrectable_cleared", "wall_s")},
            "spool": dict(self.spool),
            "replicas": per,
        }
