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

Per-replica device meshes (``make_fleet_meshes``) wait for ROADMAP Queue 1
item 14b-2.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed.elastic import ElasticCoordinator
from repro_torch.launch.engine import Engine, Request, RequestResult

MESHES_WAIT = ("per-replica device meshes wait for the multi-GPU slice "
               "(ROADMAP Queue 1 item 14b-2)")


class FleetError(RuntimeError):
    """No admitting replica for arrived work."""


def make_fleet_meshes(spec: str, n_replicas: int):
    """Per-replica meshes over disjoint device blocks: not ported yet."""
    raise NotImplementedError(MESHES_WAIT)


@dataclasses.dataclass
class Replica:
    """One engine and the router's view of its service rate."""

    name: str
    engine: Engine
    ewma_ttft: float = 0.0
    served: int = 0
    busy_s: float = 0.0               # wall seconds inside this engine

    def observe_ttft(self, ttft: float, alpha: float) -> None:
        self.ewma_ttft = ttft if self.served == 0 else \
            (1 - alpha) * self.ewma_ttft + alpha * ttft
        self.served += 1

    def score(self) -> float:
        """Lower is more attractive: queue depth x demonstrated TTFT."""
        return (self.engine.depth + 1) * max(self.ewma_ttft, 1e-3)


class Fleet:
    """N data-parallel engine replicas behind the SLO-aware router."""

    def __init__(self, replicas: List[Replica], *,
                 heartbeat_timeout: float = 60.0, ewma_alpha: float = 0.25,
                 max_depth: Optional[int] = None,
                 spool_dir: Optional[str] = None):
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
        (``n_slots``, ``max_len``, ``chunk``, ...)."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if meshes is not None:
            raise NotImplementedError(MESHES_WAIT)
        spool = spool_dir or tempfile.mkdtemp(prefix="fleet_spool_")
        device = model.embed.device
        t0 = time.perf_counter()
        if ckpt_lib.latest_step(spool) is None:
            ckpt_lib.save(sparams, 0, spool)
        save_s = time.perf_counter() - t0
        replicas, restore_s = [], 0.0
        for i in range(n_replicas):
            t0 = time.perf_counter()
            params, _ = ckpt_lib.restore(sparams, spool, device=device)
            restore_s += time.perf_counter() - t0
            name = f"replica{i}"
            eng = Engine(model, params, replica=name,
                         prefix_cache=True if prefix_cache else None,
                         **engine_kw)
            replicas.append(Replica(name=name, engine=eng))
        fleet = cls(replicas, heartbeat_timeout=heartbeat_timeout,
                    ewma_alpha=ewma_alpha, max_depth=max_depth,
                    spool_dir=spool)
        fleet.spool = {"bytes": ckpt_lib.step_bytes(spool), "save_s": save_s,
                       "restore_s": restore_s}
        return fleet

    # ------------------------------------------------------------ elasticity

    def _drain(self, name: str) -> None:
        """Pull a replica's queued and in-flight work back to the router."""
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
                          or r.engine.depth < self.max_depth)]
            if not cands:
                if not self._admitting:
                    raise FleetError(
                        f"request {req.rid} arrived with no admitting "
                        f"replica (all drained, none recovered)")
                break                      # backpressure: retry next tick
            best = min(cands, key=lambda r: (r.score(), r.name))
            self._queue.pop(0)
            best.engine.submit(req, now=submit_t)
            routed.append(req.rid)
        return routed

    def tick(self, now: Optional[float] = None) -> dict:
        """One router cycle: heartbeat, drain failures, re-admit
        recoveries, route arrivals, step every busy replica once."""
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
            if not rep.engine.busy:
                continue
            t0 = time.perf_counter()
            ev = rep.engine.step(now=now)
            rep.busy_s += time.perf_counter() - t0
            stepped.append(rep.name)
            for rid in ev["evicted"]:
                res = rep.engine.results[rid]
                self.results[rid] = res
                self.routed[rid] = rep.name
                rep.observe_ttft(res.ttft_s, self.ewma_alpha)
                finished.append(rid)
        return {"routed": routed, "stepped": stepped, "finished": finished}

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(r.engine.busy
                                        for r in self.replicas.values())

    def run(self, requests, *, open_loop: bool = False
            ) -> Tuple[Dict[int, RequestResult], dict]:
        """Serve ``requests`` to completion -> (results by rid, aggregate)."""
        self._open_loop = open_loop
        self.start()
        for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(req)
        while self.busy:
            ev = self.tick()
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
        per = {name: rep.engine.aggregate()
               for name, rep in self.replicas.items()}
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
            "prefix_hits": sum(p["prefix_hits"] for p in per.values()),
            "prefix_tokens": sum(p["prefix_tokens"] for p in per.values()),
            "scrub": {
                key: sum(p["scrub"][key] for p in per.values())
                for key in ("events", "rows_reencoded", "corrected_cleared",
                            "uncorrectable_cleared", "wall_s")},
            "spool": dict(self.spool),
            "replicas": per,
        }
