"""Continuous-batching CIM serving engine with per-request fault streams
(port of ``repro/launch/engine.py``, single device, every block kind).

It serves a stream of requests through a fixed decode batch of ``n_slots``
slots over the deployment's serving params (packed stores, decoded copies or
plain weights, plus the optional ``_cim`` per-read dynamic runtime):

* **admit**: a queued request takes the lowest free slot; its prompt is
  prefilled ``chunk`` tokens at a time into the slot's states, the ragged
  tail padded only as far as ``max_len`` (pad K/V rows stay causally
  masked until later writes overwrite them, ring kinds drop pad writes,
  fold kinds mask pads out of the fold). The last chunk's logits give the
  first token (TTFT is taken here). A ``window_bound`` kind (``local``)
  clamps the chunk to its window: a ring of W slots takes at most W new
  rows at once.
* **decode**: one :meth:`LM.decode_slots` step advances every active slot at
  its own position.
* **evict**: a slot that reaches its request's ``max_new`` (or the cache
  ceiling ``max_len``) frees.

**Batch invariance.** Every CIM read folds its seeds per (leaf, request
salt, request-local position), never per slot index or engine step: prompt
chunks are salted by content (:func:`deployment.prefix_salt` of the tokens
up through the chunk), decode reads by request id
(:func:`deployment.request_salt`). Dynamic reads go one slot at a time, and
the rest of a decode step is row-independent at the fixed ``n_slots``
shape, so a request's tokens, logits and ECC charges are bitwise the same
served alone (through an engine of the same ``n_slots``) or co-batched.
The one boundary is capacity-coupled MoE dispatch: when
:func:`lm.engine_capacity_coupled` holds at the engine's shape, co-batched
tokens can evict each other from expert capacity, and the engine warns at
construction, as the reference's does.

**Prefix cache.** With a :class:`PrefixCache` attached, admission walks the
prompt's full leading chunks through a hash-consed trie; a hit injects the
cached state chunk (the K/V rows of ``'rows'`` kinds, the post-chunk state
snapshot of ``'state'`` kinds) instead of prefilling, and replays the chunk's ECC charge
from the same (leaf, content salt, position) chain, so a hit equals a cold
prefill bitwise. The final chunk always runs (its logits are the first
token). :meth:`Engine.refresh_params` invalidates the trie: cached state
holds the faults of the image it was prefilled against.

**Accounting.** Per request: queue wait, TTFT, decode seconds, tokens, and
the ECC charges of every CIM read (the static image's counts, or the
codeword plane of the (request, position) dynamically faulted image).

Positions live on the host beside the slot states (``pos_host``), so a
decode step folds its seeds without reading the card; each step waits on
the card once, when its logits come back.

**Finiteness.** Every request records whether all its logits were finite
(``RequestResult.finite``); with ``check_finite=True`` (the default) a
non-finite logit raises :class:`EngineError` at once. An unscrubbed image
under wear is meant to rot into non-finite logits, and is served with
``check_finite=False``.

**Scrubbing and the fleet.** ``run(on_step=...)`` is the hook the online
scrubber (:mod:`repro_torch.launch.scrub`) ages and rewrites the image from:
``refresh_params(force=True)`` swaps the params with requests in flight and
``record_scrub`` logs a scrub. ``replica``, ``drain``, ``start`` and
``depth`` serve the fleet router (:mod:`repro_torch.launch.fleet`).

**On a mesh** (``mesh=``, default the ambient mesh at construction; the
reference runs its engine under the ambient mesh): the serving params'
stores are column blocks placed ``dim='j'`` (``CIMDeployment.shard``), and
every step runs under the mesh, so the fused reads go through
``cim_linear_store_sharded`` and the embed's row reads gather their
columns over ``"model"``. The scheduler (queue, slots, positions, the
prefix trie) is the same on every rank: it decides from what every rank
sees alike, and the one thing a rank reads from its own clock, which
requests have arrived at a step, is rank 0's reading
(:func:`sharding.first_value`). A request's ECC charge is summed over
``"model"`` (each rank counts its blocks), a prefix hit's replay too. The
slots split over the batch axes (``"data"``) when they divide ``n_slots``
(the lock-step serve's rule, ``sharding.batch_rows``): a decode step
computes this rank's slots and the logits are gathered; a prompt chunk is
prefilled on every data rank, so every rank holds the same trie and the
prefilled state of every slot it may decode. Otherwise every data rank runs
every slot.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cim as cim_lib
from repro_torch.core import deployment as dep_lib
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shlib
from repro_torch.models import lm
from repro_torch.training import steps as steps_lib

_ECC_ZERO = {"reads": 0, "corrected": 0, "uncorrectable": 0}


def _ecc_zero() -> Dict[str, int]:
    return dict(_ECC_ZERO)


class EngineError(RuntimeError):
    """Non-finite logits (under ``check_finite``) or an inconsistent
    scheduler state."""


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget."""

    rid: int
    tokens: np.ndarray                 # [L] prompt token ids
    max_new: int = 16
    arrival: float = 0.0               # open-loop arrival time (s from start)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")


@dataclasses.dataclass
class RequestResult:
    """Per-request serving record (the engine's JSON artifact rows)."""

    rid: int
    prompt_len: int
    tokens: List[int]                  # generated ids (greedy)
    finish: str                        # 'length' | 'max_len'
    queue_s: float                     # submit/arrival -> slot admission
    ttft_s: float                      # submit/arrival -> first token
    decode_s: float                    # wall time inside decode steps
    slot: int
    ecc: Dict[str, int]                # reads / corrected / uncorrectable
    finite: bool = True                # every logit of the request finite
    logits: Optional[np.ndarray] = None   # [n_tokens, V] when collected
    replica: str = ""                  # the engine's fleet replica name
    prefix_tokens: int = 0             # prompt tokens reused from the trie
    salt: int = 0                      # uint32 request salt (decode streams)
    ecc_window: List[Dict[str, int]] = dataclasses.field(
        default_factory=list)          # per-read ECC time series
    scrubs: int = 0                    # scrub events while it was in flight

    def to_json(self) -> dict:
        tok_s = len(self.tokens) / self.decode_s if self.decode_s > 0 else 0.0
        return {"rid": self.rid, "prompt_len": self.prompt_len,
                "n_tokens": len(self.tokens), "finish": self.finish,
                "queue_s": self.queue_s, "ttft_s": self.ttft_s,
                "decode_s": self.decode_s, "tok_s": tok_s, "slot": self.slot,
                "ecc": {k: int(v) for k, v in self.ecc.items()},
                "ecc_window": [{k: int(v) for k, v in w.items()}
                               for w in self.ecc_window],
                "scrubs": self.scrubs,
                "finite": self.finite, "replica": self.replica,
                "prefix_hit": self.prefix_tokens > 0,
                "prefix_tokens": self.prefix_tokens, "salt": self.salt}


@dataclasses.dataclass
class _PrefixNode:
    """One full prefill chunk in the trie: (parent, chunk tokens) -> state."""

    nid: int
    key: tuple                         # (parent nid, chunk tokens bytes)
    salt: int                          # content salt its fault streams used
    state: object                      # state chunk (lm.extract_state_chunk)
    tokens: int                        # chunk length


class PrefixCache:
    """Hash-consed token-chunk trie of prefilled state chunks.

    A node is one FULL prefill chunk keyed by ``(parent node id, chunk token
    bytes)``: the path from the root spells a prompt prefix in chunk steps,
    and inserting a chunk that exists under the same parent returns the
    existing node. A node's state was prefilled under the content salt of
    its token prefix, which is what a cold prefill of the same tokens uses,
    so reuse is exact, but only for the image and runtime it was filled
    against (:meth:`invalidate`).

    At most ``max_chunks`` nodes; least-recently-used eviction takes LEAF
    chunks only (a parent is at least as reachable as its children)."""

    def __init__(self, max_chunks: int = 256):
        if max_chunks < 1:
            raise ValueError(f"PrefixCache: max_chunks {max_chunks} < 1")
        self.max_chunks = max_chunks
        self._nodes: Dict[tuple, _PrefixNode] = {}
        self._children: Dict[int, set] = {}
        self._lru: "OrderedDict[tuple, None]" = OrderedDict()
        self._next_id = 1
        self.hits = self.misses = self.inserts = self.evictions = 0
        self.invalidations = 0

    @staticmethod
    def _key(parent: Optional[_PrefixNode], tokens) -> tuple:
        pid = 0 if parent is None else parent.nid
        return (pid, np.asarray(tokens, np.int32).tobytes())

    def lookup(self, parent: Optional[_PrefixNode], tokens):
        node = self._nodes.get(self._key(parent, tokens))
        if node is None:
            self.misses += 1
            return None
        self.hits += 1
        self._lru.move_to_end(node.key)
        return node

    def insert(self, parent: Optional[_PrefixNode], tokens, state,
               salt) -> _PrefixNode:
        key = self._key(parent, tokens)
        node = self._nodes.get(key)
        if node is not None:            # hash-consed: one copy per chunk
            self._lru.move_to_end(key)
            return node
        node = _PrefixNode(nid=self._next_id, key=key, salt=int(salt),
                           state=state, tokens=int(np.asarray(tokens).size))
        self._next_id += 1
        self._nodes[key] = node
        self._children.setdefault(key[0], set()).add(key)
        self._lru[key] = None
        self.inserts += 1
        while len(self._nodes) > self.max_chunks and self._evict_leaf():
            pass
        return node

    def _evict_leaf(self) -> bool:
        for key in self._lru:           # oldest first
            if not self._children.get(self._nodes[key].nid):
                node = self._nodes.pop(key)
                self._children.get(key[0], set()).discard(key)
                self._children.pop(node.nid, None)
                del self._lru[key]
                self.evictions += 1
                return True
        return False

    def invalidate(self) -> None:
        """Drop every cached chunk (stale against a new image/runtime)."""
        self._nodes.clear()
        self._children.clear()
        self._lru.clear()
        self.invalidations += 1

    def __len__(self) -> int:
        return len(self._nodes)

    def stats(self) -> dict:
        return {"chunks": len(self._nodes),
                "tokens": sum(n.tokens for n in self._nodes.values()),
                "hits": self.hits, "misses": self.misses,
                "inserts": self.inserts, "evictions": self.evictions,
                "invalidations": self.invalidations}


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt_len: int
    max_new: int
    submit_t: float
    admit_t: float
    req: Optional[Request] = None      # original request (drain hands it back)
    ttft_s: float = 0.0
    decode_s: float = 0.0
    finite: bool = True
    prefix_tokens: int = 0
    salt: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    ecc: Dict[str, int] = dataclasses.field(default_factory=_ecc_zero)
    ecc_window: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    scrubs: int = 0


@dataclasses.dataclass
class LoadGen:
    """Synthetic open-loop load: Poisson arrivals, uniform length ranges.

    ``rate=float('inf')`` (the default) drops every arrival at t=0; a finite
    rate draws exponential inter-arrival gaps. ``prefix_len > 0`` prepends
    one shared token prefix (drawn once from the same seed) to every prompt,
    the system-prompt workload of the prefix cache. The schedule is a pure
    function of the fields, drawn from ``np.random.default_rng`` in the
    reference's order, so it equals the reference's schedule."""

    n_requests: int = 32
    rate: float = float("inf")         # requests / second
    prompt_lens: Tuple[int, int] = (8, 32)
    gen_lens: Tuple[int, int] = (4, 16)
    vocab_size: int = 256
    seed: int = 0
    prefix_len: int = 0                # shared leading tokens (0 = none)

    def requests(self) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        if np.isinf(self.rate):
            arrivals = np.zeros(self.n_requests)
        else:
            arrivals = np.cumsum(rng.exponential(1.0 / self.rate,
                                                 self.n_requests))
        # drawn before the per-request loop, as the reference draws it
        prefix = (rng.integers(0, self.vocab_size, self.prefix_len)
                  if self.prefix_len > 0 else None)
        out = []
        for i in range(self.n_requests):
            plen = int(rng.integers(self.prompt_lens[0],
                                    self.prompt_lens[1] + 1))
            gen = int(rng.integers(self.gen_lens[0], self.gen_lens[1] + 1))
            toks = rng.integers(0, self.vocab_size, plen)
            if prefix is not None:
                toks = np.concatenate([prefix, toks])
            out.append(Request(rid=i, tokens=toks, max_new=gen,
                               arrival=float(arrivals[i])))
        return out

    def max_len(self) -> int:
        return self.prefix_len + self.prompt_lens[1] + self.gen_lens[1] + 1


class Engine:
    """Slot-based continuous-batching serving of ``model`` over ``params``
    (what :meth:`CIMDeployment.serving_params` returns; None serves the
    model's own weights). The slot states live on the model's device.

    ``prefix_cache`` attaches a :class:`PrefixCache` (pass one, or ``True``
    for a default-sized one). ``ecc_accounting=False`` skips the per-read
    ECC charges (a dynamic charge re-decodes the codeword planes of every
    store on every read). ``check_finite`` raises :class:`EngineError` on a
    non-finite logit; either way the request's ``finite`` records it.
    ``replica`` names the engine in fleet artifacts
    (``RequestResult.replica``).
    """

    def __init__(self, model: "lm.LM", params=None, *, n_slots: int = 4,
                 max_len: int = 64, chunk: int = 16,
                 collect_logits: bool = False, ecc_accounting: bool = True,
                 check_finite: bool = True, prefix_cache=None,
                 replica: str = "", mesh=None):
        cfg = model.cfg
        specs = lm.check_engine_kinds(cfg)
        if not (n_slots >= 1 and chunk >= 1 and max_len >= 2):
            raise ValueError(f"Engine: n_slots {n_slots}, chunk {chunk}, "
                             f"max_len {max_len}")
        self.device = resolve_device(model.embed.device)
        self.mesh = mesh if mesh is not None else shlib.get_mesh()
        # this rank's slots of a decode step (every slot unless the batch
        # axes divide n_slots)
        self._rows = shlib.batch_rows(n_slots, self.mesh)
        self.params = dict(params or {})
        self._check_devices()
        self.cfg = cfg
        # a chunk never writes past the cache ceiling, and a window-bound
        # kind's chunk never past its ring (W slots take W new rows at most)
        self.n_slots, self.max_len = n_slots, max_len
        self.chunk = min(chunk, max_len)
        if any(s.window_bound for s in specs):
            self.chunk = min(self.chunk, cfg.local_window)
        # capacity-coupled MoE dispatch at these shapes voids the bitwise
        # solo-vs-co-batched guarantee (moe.drop_free draws the boundary)
        self.capacity_coupled = lm.engine_capacity_coupled(
            cfg, max(n_slots, self.chunk))
        if self.capacity_coupled:
            warnings.warn(
                "engine: MoE dispatch is capacity-coupled at these shapes "
                f"(n_slots={n_slots}, chunk={self.chunk}): co-batched tokens "
                "may contend for expert capacity, voiding the bitwise "
                "solo-vs-cobatched guarantee (fault streams stay "
                "per-request). Raise capacity_factor or shrink the batch "
                "until moe.drop_free holds to restore it.")
        self.collect_logits = collect_logits
        self.check_finite = check_finite
        self.replica = replica
        self._prefill = steps_lib.make_prefill_chunk_step(model)
        self._decode = steps_lib.make_decode_slots_step(model)
        self._extract = steps_lib.make_extract_state_step(cfg)
        self._inject = steps_lib.make_inject_state_step(cfg)
        self.prefix_cache: Optional[PrefixCache] = \
            PrefixCache() if prefix_cache is True else prefix_cache
        self.caches = lm.init_slot_states(cfg, n_slots, max_len,
                                          device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.queue: deque[Tuple[Request, float]] = deque()
        self._tokens = np.zeros((n_slots, 1), np.int64)
        self._salts = np.zeros(n_slots, np.uint32)
        self.results: Dict[int, RequestResult] = {}
        self.steps = 0
        self.idle_steps = 0
        self.requeues = 0
        self._decode_wall = 0.0
        self._decoded_tokens = 0
        self._ecc_accounting = ecc_accounting
        self._runtime = self.params.get("_cim")
        # per-store cumulative ECC charges (path -> counters): what a scrub
        # policy thresholds on. They survive refresh_params; record_scrub
        # resets a scrubbed store's.
        self.store_ecc: Dict[str, Dict[str, int]] = {}
        self.scrub_events: List[dict] = []
        self._ecc_fns = self._build_ecc_fns() if ecc_accounting else []

    def _check_devices(self) -> None:
        """Every packed store must lie on the engine's device (a store on a
        card that is not there raises, as every CUDA request does)."""
        for path, leaf in self.params.items():
            if isinstance(leaf, cim_lib.CIMStore) and \
                    resolve_device(leaf.device) != self.device:
                raise ValueError(f"Engine: store {path!r} is on "
                                 f"{leaf.device}, the model on {self.device}")

    # ------------------------------------------------------------ ECC

    def _build_ecc_fns(self):
        """One per-read ECC accountant per deployed store, in path order:
        ``(path, fn, local)``, ``fn(req_salt, pos)`` -> (corrected,
        uncorrectable), ``local`` when they are a column block's, to be
        summed over ``"model"`` (:meth:`_charge_reads`).

        Static image: its corrected/uncorrectable counts are a constant,
        computed once (a block's summed over the mesh then) and charged per
        read. Dynamic runtime: each read re-derives the (request, position)
        flip streams the model's read drew, at the block's global
        coordinates, and counts the ECC events of that faulted image. The
        counts come from the codeword plane alone, so only it is flipped;
        with no codewords (``protect='none'``) they are zero."""
        fns = []
        rt = self._runtime
        for path in sorted(self.params):
            store = self.params[path]
            if not isinstance(store, cim_lib.CIMStore):
                continue
            self.store_ecc.setdefault(path, _ecc_zero())
            if rt is None or store.codewords is None:
                st = dep_lib.store_stats_placed(store, self.mesh) \
                    if store.shard is not None else cim_lib.store_stats(store)
                const = (st["corrected"], st["uncorrectable"])
                fns.append((path, lambda req_salt, pos, c=const: c, False))
                continue

            def dyn(req_salt, pos, store=store, salt=dep_lib.leaf_salt(path)):
                seeds = dep_lib.request_read_seeds(rt["seeds"], salt,
                                                   req_salt, pos)
                _, thr_meta, model = dep_lib.read_thresholds(rt, pos)
                elem, shape = cim_lib._plane_elem(store, "cw",
                                                  store.codewords)
                cw = cim_lib.counter_flip_words(
                    store.codewords, seeds["cw"], thr_meta,
                    cim_lib.codeword_valid_masks(store.cfg), model=model,
                    elem=elem, shape=shape)
                st = cim_lib.store_stats(
                    dataclasses.replace(store, codewords=cw))
                return st["corrected"], st["uncorrectable"]
            sharded = store.shard is not None and store.shard.sharded
            fns.append((path, dyn, sharded))
        return fns

    def _charge_reads(self, slot: _Slot, salt: int, pos: int) -> None:
        """Charge one CIM read of every deployed store at read index
        ``pos``: to the request's counters, its ``ecc_window`` series (one
        row per read) and the per-store totals. Column blocks' counts are
        summed over ``"model"`` in one combine."""
        if not self._ecc_fns:
            return
        slot.ecc["reads"] += 1
        counts = [fn(int(salt), int(pos)) for _, fn, _ in self._ecc_fns]
        local = [i for i, (_, _, loc) in enumerate(self._ecc_fns) if loc]
        if local:
            t = torch.tensor([counts[i] for i in local], dtype=torch.int64,
                             device=self.device)
            t = shlib.all_reduce_sum(t, shlib.MODEL_AXIS, self.mesh).cpu()
            for i, (c, u) in zip(local, t.tolist()):
                counts[i] = (c, u)
        corr = unc = 0
        for (path, _, _), (c, u) in zip(self._ecc_fns, counts):
            corr += c
            unc += u
            store = self.store_ecc[path]
            store["reads"] += 1
            store["corrected"] += c
            store["uncorrectable"] += u
        slot.ecc["corrected"] += corr
        slot.ecc["uncorrectable"] += unc
        slot.ecc_window.append({"pos": int(pos), "reads": 1,
                                "corrected": corr, "uncorrectable": unc})

    # ------------------------------------------------------------ scheduling

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        self.queue.append((req, now if now is not None else req.arrival))

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def active(self) -> np.ndarray:
        return np.asarray([s is not None for s in self.slots])

    def _admit(self, req: Request, slot_idx: int, submit_t: float) -> None:
        """Prefill the request's prompt into ``slot_idx`` chunk by chunk,
        reusing trie-cached chunks where they match, and emit its first
        token. Each chunk's reads are salted by the content of the prompt
        up through the chunk, so a cached chunk's rows and its replayed ECC
        charge are what a cold prefill would give."""
        plen = req.tokens.size
        if plen + req.max_new > self.max_len:
            raise EngineError(
                f"request {req.rid}: prompt {plen} + max_new {req.max_new} "
                f"exceeds the engine's max_len {self.max_len}")
        rsalt = dep_lib.request_salt(req.rid)
        slot = _Slot(rid=req.rid, prompt_len=plen, max_new=req.max_new,
                     submit_t=submit_t, admit_t=self._clock(), req=req,
                     salt=rsalt)
        # the trie covers the prompt's full LEADING chunks; the final one
        # always runs (its logits are the first token) and sets the slot's
        # position
        starts = list(range(0, plen, self.chunk))
        node = None
        pos = 0
        if self.prefix_cache is not None:
            for c0 in starts[:-1]:
                seg = req.tokens[c0:c0 + self.chunk]
                hit = self.prefix_cache.lookup(node, seg)
                if hit is None:
                    break
                self._inject(self.caches, slot_idx, c0, hit.state)
                self._charge_reads(slot, hit.salt, c0)
                node = hit
                pos = c0 + self.chunk
        slot.prefix_tokens = pos
        logits = None
        for c0 in range(pos, plen, self.chunk):
            seg = req.tokens[c0:c0 + self.chunk]
            length = seg.size
            csalt = dep_lib.prefix_salt(req.tokens[:c0 + length])
            # the ragged tail pads only to what still fits under max_len: an
            # index past the slot's rows would raise (a device-side assert
            # on the card); the pad length never enters the seed chain
            pad_to = min(self.chunk, self.max_len - c0)
            padded = torch.as_tensor(np.pad(seg, (0, pad_to - length)),
                                     dtype=torch.int64, device=self.device)
            logits, self.caches = self._prefill(
                self.params, self.caches, padded, slot_idx, c0, length,
                csalt)
            self._charge_reads(slot, csalt, c0)
            if self.prefix_cache is not None and length == self.chunk:
                state = self._extract(self.caches, slot_idx, c0, self.chunk)
                node = self.prefix_cache.insert(node, seg, state, csalt)
        logits = logits.cpu().numpy()
        self._check(logits, slot)
        tok = int(np.argmax(logits))
        slot.tokens.append(tok)
        if self.collect_logits:
            slot.logits.append(logits)
        slot.ttft_s = self._clock() - submit_t
        self.slots[slot_idx] = slot
        self._tokens[slot_idx, 0] = tok
        self._salts[slot_idx] = rsalt

    def _reset_slot(self, slot_idx: int) -> None:
        """Free a slot: the next admission prefills from row 0; stale rows
        and ring slots stay masked until overwritten, and the first chunk
        zeroes the fold states (``LM.prefill_chunk`` at ``pos == 0``)."""
        self.slots[slot_idx] = None
        self.caches["pos_host"][slot_idx] = 0
        self.caches["pos"][slot_idx] = 0

    def _evict(self, slot_idx: int, finish: str) -> None:
        slot = self.slots[slot_idx]
        self.results[slot.rid] = RequestResult(
            rid=slot.rid, prompt_len=slot.prompt_len, tokens=slot.tokens,
            finish=finish, queue_s=slot.admit_t - slot.submit_t,
            ttft_s=slot.ttft_s, decode_s=slot.decode_s, slot=slot_idx,
            ecc=slot.ecc, finite=slot.finite,
            logits=np.stack(slot.logits) if slot.logits else None,
            replica=self.replica, prefix_tokens=slot.prefix_tokens,
            salt=slot.salt, ecc_window=slot.ecc_window, scrubs=slot.scrubs)
        self._reset_slot(slot_idx)

    def _check(self, logits: np.ndarray, slot: _Slot) -> None:
        """Record a non-finite logit in the slot's verdict; raise on it
        under ``check_finite``."""
        if not np.isfinite(logits).all():
            slot.finite = False
            if self.check_finite:
                raise EngineError(
                    f"non-finite logits serving request {slot.rid}")

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    # ------------------------------------------------------------ fleet hooks

    @property
    def depth(self) -> int:
        """Queued + in-flight request count (a router's load signal)."""
        return len(self.queue) + int(self.active.sum())

    @property
    def busy(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def start(self, t0: Optional[float] = None) -> None:
        """Pin the engine clock origin (replicas share a router's ``t0``)."""
        self._t0 = time.perf_counter() if t0 is None else t0

    def drain(self) -> List[Request]:
        """Abandon all work and hand the requests back, in arrival order.
        Re-serving one from scratch gives the tokens, logits and fault
        streams of an uninterrupted run (every stream keys on content,
        request and position). Slots reset; the prefix trie stays."""
        back: List[Request] = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            back.append(slot.req)
            self._reset_slot(i)
        back.extend(req for req, _ in self.queue)
        self.queue.clear()
        self.requeues += len(back)
        back.sort(key=lambda r: (r.arrival, r.rid))
        return back

    def refresh_params(self, params, *, force: bool = False) -> None:
        """Swap in a new deployed image or runtime. Cached prefix state
        holds the faults of the image it was prefilled against, so the trie
        is dropped.

        The engine must be idle unless ``force``: the online scrub and aging
        path swaps with requests in flight. Their slot states stay (earlier
        reads saw the old cells), positions and salts stay on the host, and
        every later read, and its ECC charge, sees the new image. The
        per-store ``store_ecc`` counters carry over."""
        if self.busy and not force:
            raise EngineError("refresh_params on a busy engine: drain first")
        self.params = dict(params or {})
        self._check_devices()
        self._runtime = self.params.get("_cim")
        self._ecc_fns = self._build_ecc_fns() if self._ecc_accounting else []
        if self.prefix_cache is not None:
            self.prefix_cache.invalidate()

    def record_scrub(self, event: dict) -> None:
        """Log one scrub event: every in-flight request lived through it, and
        the scrubbed stores' cumulative ``store_ecc`` counters reset."""
        self.scrub_events.append(dict(event))
        for s in self.slots:
            if s is not None:
                s.scrubs += 1
        for path in event.get("paths", ()):
            if path in self.store_ecc:
                self.store_ecc[path] = _ecc_zero()

    # ------------------------------------------------------------ stepping

    def step(self, now: Optional[float] = None) -> dict:
        """Admit arrived requests into free slots, then advance every active
        slot by one token. Returns an event dict (admitted/decoded/evicted
        rids, ``idle`` when there was nothing to decode)."""
        if not hasattr(self, "_t0"):
            self._t0 = time.perf_counter()
        if now is None:
            now = shlib.first_value(self._clock(), self.mesh)
        with shlib.use_mesh(self.mesh):
            return self._step(now)

    def _step(self, now: float) -> dict:
        admitted, evicted = [], []
        while self.queue and self.free_slots():
            req, submit_t = self.queue[0]
            if submit_t > now:
                break
            self.queue.popleft()
            idx = self.free_slots()[0]
            self._admit(req, idx, submit_t)
            admitted.append(req.rid)
            if len(self.slots[idx].tokens) >= req.max_new:
                self._evict(idx, "length")
                evicted.append(req.rid)

        active = self.active
        if not active.any():
            self.idle_steps += 1
            return {"idle": True, "admitted": admitted, "evicted": evicted,
                    "decoded": []}

        t0 = time.perf_counter()
        logits = self._decode_rows(active)
        logits = logits.cpu().numpy()      # the step's one wait on the card
        dt = time.perf_counter() - t0
        self.steps += 1
        decoded = []
        n_active = int(active.sum())
        for i in np.flatnonzero(active):
            slot = self.slots[i]
            self._check(logits[i], slot)
            tok = int(np.argmax(logits[i]))
            slot.tokens.append(tok)
            if self.collect_logits:
                slot.logits.append(logits[i])
            slot.decode_s += dt / n_active
            # the read index this step consumed: the slot's pre-step
            # position (prefill left it at prompt_len; each decode adds 1)
            self._charge_reads(slot, self._salts[i],
                               slot.prompt_len + len(slot.tokens) - 2)
            self._tokens[i, 0] = tok
            decoded.append(slot.rid)
            self._decoded_tokens += 1
        self._decode_wall += dt
        for i in np.flatnonzero(active):
            slot = self.slots[i]
            done = len(slot.tokens) >= slot.max_new
            full = slot.prompt_len + len(slot.tokens) >= self.max_len
            if done or full:
                self._evict(int(i), "length" if done else "max_len")
                evicted.append(slot.rid)
        return {"idle": False, "admitted": admitted, "decoded": decoded,
                "evicted": evicted}

    def _decode_rows(self, active: np.ndarray) -> torch.Tensor:
        """One decode step: every slot, or on a mesh whose batch axes split
        the slots this rank's, in place in the slot states (views of its
        rows), with the logits [n_slots, V] gathered over those axes."""
        r = self._rows
        tokens = torch.as_tensor(self._tokens[r], device=self.device)
        if r == slice(None):
            logits, self.caches = self._decode(self.params, self.caches,
                                               tokens, active, self._salts)
            return logits
        view = {"layers": [{n: t[r] for n, t in st.items()}
                           for st in self.caches["layers"]],
                "pos": self.caches["pos"][r],
                "pos_host": self.caches["pos_host"][r]}
        with shlib.split_rows(self.mesh):
            logits, _ = self._decode(self.params, view, tokens, active[r],
                                     self._salts[r])
        return shlib.gather_rows(logits.contiguous(), self.mesh)

    def run(self, requests, *, open_loop: bool = False, on_step=None
            ) -> Tuple[Dict[int, RequestResult], dict]:
        """Serve ``requests`` to completion -> (results by rid, aggregate).

        ``open_loop=True`` gates admissions on each request's wall-clock
        ``arrival`` offset; otherwise everything is admissible at once and
        ``arrival`` only sets the queue order. ``on_step(engine, event)``
        runs after every step."""
        self._t0 = time.perf_counter()
        for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(req, now=req.arrival if open_loop else 0.0)
        while self.queue or self.active.any():
            ev = self.step(now=None if open_loop else float("inf"))
            if on_step is not None:
                on_step(self, ev)
            if ev["idle"] and self.queue:
                # open loop, nothing active, next arrival in the future
                wait = self.queue[0][1] - self._clock()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return self.results, self.aggregate()

    # ------------------------------------------------------------ reporting

    def aggregate(self) -> dict:
        res = list(self.results.values())
        ttfts = np.asarray([r.ttft_s for r in res]) if res else np.zeros(1)
        total_tok = sum(len(r.tokens) for r in res)
        wall = self._clock() if hasattr(self, "_t0") else 0.0
        return {
            "replica": self.replica,
            "n_requests": len(res),
            "n_slots": self.n_slots,
            "total_tokens": total_tok,
            "decode_steps": self.steps,
            "idle_steps": self.idle_steps,
            "wall_s": wall,
            "decode_wall_s": self._decode_wall,
            "decode_tok_s": (self._decoded_tokens / self._decode_wall
                             if self._decode_wall > 0 else 0.0),
            "tok_s": total_tok / wall if wall > 0 else 0.0,
            "ttft_s_mean": float(ttfts.mean()),
            "ttft_s_p95": float(np.percentile(ttfts, 95)),
            "slot_occupancy": (self._decoded_tokens
                               / max(self.steps * self.n_slots, 1)),
            "requeues": self.requeues,
            "prefix_hits": sum(1 for r in res if r.prefix_tokens > 0),
            "prefix_tokens": sum(r.prefix_tokens for r in res),
            "prefix_cache": (self.prefix_cache.stats()
                             if self.prefix_cache is not None else None),
            "ecc": {k: int(sum(r.ecc[k] for r in res)) for k in _ECC_ZERO},
            "store_ecc": {p: dict(v) for p, v in self.store_ecc.items()},
            "scrub": self._scrub_summary(),
        }

    def _scrub_summary(self) -> dict:
        ev = self.scrub_events
        return {
            "events": len(ev),
            "rows_reencoded": int(sum(e.get("rows", 0) for e in ev)),
            "corrected_cleared": int(sum(e.get("corrected_cleared", 0)
                                         for e in ev)),
            "uncorrectable_cleared": int(sum(e.get("uncorrectable_cleared", 0)
                                             for e in ev)),
            "wall_s": float(sum(e.get("wall_s", 0.0) for e in ev)),
        }
