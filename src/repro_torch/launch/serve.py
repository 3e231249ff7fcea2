"""Lock-step serving launcher (port of ``repro/launch/serve.py``).

Batched prefill + greedy decode of an LM whose CIM-deployed matrices are
served from the packed SRAM image:

* ``--serve-path fused`` (default): ``embed`` and ``unembed`` stay packed;
  the embed table is decoded row by row at gather time and the unembed runs
  through the fused decode-on-read kernel (``kernels/cim_read``).
  ``--inject static`` flips the image once (the unembed then serves from its
  decoded-row cache); ``--inject dynamic`` draws fresh counter-PRNG faults
  in-kernel on every read, keyed by the read index.
* ``--serve-path hbm``: inject + ECC-decode once, serve the decoded copies.

  python -m repro_torch.launch.serve --arch olmo-1b --batch 4 \\
      --prompt-len 64 --gen 32 --cim --ber 1e-4 --inject dynamic

Runs on ``cuda`` unless ``--device cpu`` is given; with no card it raises.
``--arch`` takes the ported text configs: olmo-1b (default), granite-3-8b,
codeqwen1.5-7b, command-r-35b, tinyvit-paper, rwkv6-1.6b,
recurrentgemma-9b, qwen3-moe-235b-a22b and dbrx-132b, lock-step,
``--engine`` and ``--fleet``. A stub modality (internvl2-76b,
musicgen-large) is refused, as the reference's launcher refuses it: serving
is text-only.

Seeds: weights come from ``torch.Generator(device).manual_seed(seed)``; the
fault seeds from :func:`default_seeds`. Neither equals the reference
launcher's: its weights and seeds come from ``jax.random`` (threefry), which
the port does not reimplement. :func:`serve` takes explicit seed dicts, which
is how the parity tests replay the reference's streams.

``--fault-model SPEC`` (the reference's grammar, e.g.
``burst:rate=0.25,length=4,axis=col`` or ``drift:drift_rate=0.02``) shapes
the faults: the static injection of either serve path, and the per-read
runtime of ``--inject dynamic`` (drift keyed on the read position).

``--engine`` swaps the lock-step batch for the continuous-batching engine
(:mod:`repro_torch.launch.engine`): a synthetic load of ``--requests``
requests (Poisson at ``--rate`` req/s, or all at once) with ragged prompt
and generation lengths is scheduled through ``--slots`` decode slots
(chunked prefill, per-request fault streams, per-request ECC and TTFT
accounting; ``--engine-json`` writes the per-request artifact; ``--probe
RID`` re-serves one request through a fresh engine and fails unless its
tokens and ECC match).

  python -m repro_torch.launch.serve --engine --cim --ber 1e-4 \\
      --inject dynamic --slots 4 --chunk 16 --requests 12 --probe 0

``--scrub`` (engine mode, fused path) attaches an online ECC scrubber
(:mod:`repro_torch.launch.scrub`) as the engine's step hook: a store whose
cumulative ECC events reach ``--scrub-threshold`` is re-encoded and the
params swapped mid-flight; ``--age-ber`` adds drift-aging wear under it
(``--fault-model``, default drift, every ``--age-every`` steps, seeds from
``--seed``).

  python -m repro_torch.launch.serve --engine --cim --scrub --age-ber 1e-3 \\
      --scrub-threshold 8 --slots 4 --chunk 16 --requests 8

``--fleet N`` serves the load through N engine replicas behind the SLO
router (:mod:`repro_torch.launch.fleet`): the params are spooled once and
restored per replica; ``--probe RID`` re-serves one request through a
fresh one-replica fleet from the same spool and fails unless its tokens and
ECC match the routed run.

  python -m repro_torch.launch.serve --fleet 2 --cim --ber 1e-4 \\
      --inject dynamic --slots 4 --chunk 16 --requests 12 --probe 5

``--expert-cim`` (MoE archs) deploys every expert's matrices as its own
CIM store under the launcher's protection (static faults at ``--ber``,
decoded once and restacked) before the embed/unembed deploy, and
``--engine-json`` then records each expert store's ECC counts under
``expert_ecc``:

  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --reduced \\
      --device cpu --expert-cim --cim --ber 1e-3 --engine --slots 2 \\
      --chunk 8 --requests 4 --engine-json /tmp/e.json

``--rounds R`` serves R successive MarkovLM batches (round r's prompts are
``MarkovLM.batch(r)``). ``--mesh DxM`` serves them on a ``("data",
"model")`` mesh of D x M ranks (:mod:`repro_torch.launch.mesh`, one process
a card): each data rank serves its rows of the batch (the whole batch when
D does not divide it), every CIM store is column-sharded over "model"
(``CIMDeployment.shard``; each rank reads its block through the fused
kernel at its global offsets and the blocks are gathered), block weights
and norms stay whole on every rank. The report gives aggregate and
per-device tok/s and the ECC totals over the whole image; only rank 0
prints. Under ``torchrun``, or 1x1 without it:

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1x2 \
      --rounds 2 --cim --ber 1e-4 --inject dynamic

``--engine --mesh DxM`` runs the engine on that mesh (every store
column-sharded over "model", the slots split over "data" when it divides
``--slots``; :mod:`repro_torch.launch.engine`); ``--fleet N --mesh DxM``
runs N replicas, each on its own block of D x M ranks
(``fleet.make_fleet_meshes``; the world is N x D x M ranks). Each rank
holds its blocks of the image; only rank 0 prints. ``--scrub`` and
``--expert-cim`` on a mesh raise (ROADMAP Queue 1 item 14b-3).

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --engine \
      --mesh 2x2 --cim --ber 1e-3 --inject dynamic --slots 4 --probe 0
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --fleet 2 \
      --mesh 1x2 --cim --ber 1e-3 --inject dynamic --probe 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import cim as cim_lib
from repro_torch.core import deployment as dep_lib
from repro_torch.core import faultmodels as fm_lib
from repro_torch.data.synthetic import MarkovLM
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels.cim_read import kernel as kernel_lib
from repro_torch.launch import engine as engine_lib
from repro_torch.launch import fleet as fleet_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import scrub as scrub_lib
from repro_torch.models.lm import LM

_SEED_SALT = 0x5EED


def serving_policy(*, protect: str, n_group: int, index: int,
                   field: str = "full", serve_path: str = "fused"
                   ) -> dep_lib.ReliabilityPolicy:
    """``fused``: embed (no row cache: served by row gathers) and unembed
    (row cache for static serving) deploy; ``hbm``: every deployable leaf,
    decoded once."""
    rule = dep_lib.PolicyRule(pattern="*", protect=protect, n_group=n_group,
                              index=index, field=field, serve_path=serve_path)
    if serve_path == "hbm":
        return dep_lib.ReliabilityPolicy(rules=(), default=rule)
    return dep_lib.ReliabilityPolicy(
        rules=(dataclasses.replace(rule, pattern="embed", row_cache=False),
               dataclasses.replace(rule, pattern="unembed", row_cache=True)),
        default=dep_lib.PolicyRule(deploy=False))


def expert_serving_policy(*, protect: str, n_group: int, index: int,
                          field: str = "full") -> dep_lib.ReliabilityPolicy:
    """Per-expert MoE deployment policy (``--expert-cim``): every expert
    store (``groups/blk0/moe/moe_win/g0/expert3`` and the like) takes the
    launcher's protection, decoded once."""
    return dep_lib.ReliabilityPolicy(rules=(), default=dep_lib.PolicyRule(
        pattern="*", protect=protect, n_group=n_group, index=index,
        field=field, serve_path="hbm"))


def expert_seeds(seed: int, paths) -> dict:
    """Static plane seeds of the expert stores ``paths`` (in their order):
    ``np.random.SeedSequence([seed, 0x5EED, 2]).generate_state(3n)``, three
    words (man, meta, cw) a store."""
    w = [int(v) for v in np.random.SeedSequence(
        [int(seed), _SEED_SALT, 2]).generate_state(3 * len(paths), np.uint32)]
    return {p: {"man": w[3 * i], "meta": w[3 * i + 1], "cw": w[3 * i + 2]}
            for i, p in enumerate(paths)}


def expert_deploy(leaves, *, ber: float, protect: str, n_group: int,
                  index: int, field: str = "full", seed: int = 0,
                  seeds=None, fault_model: str = "", verbose: bool = True):
    """``--expert-cim``: deploy the stacked expert leaves (reference layout,
    :func:`convert.expert_leaves`) one store an expert, inject static faults
    at ``ber`` (``seeds`` per store, default :func:`expert_seeds`) ->
    (the :class:`ExpertDeployment`, its restacked serving leaves)."""
    edep = dep_lib.ExpertDeployment.deploy(leaves, expert_serving_policy(
        protect=protect, n_group=n_group, index=index, field=field))
    if ber > 0:
        paths = [p for p, _, _ in edep.inner.store_leaves()]
        edep = edep.inject(seeds or expert_seeds(seed, paths), ber,
                           model=fault_model or None)
    restacked = edep.serving_params()
    if verbose:
        est = edep.stats_by_expert()
        print(f"expert CIM deploy: {len(est)} per-expert stores "
              f"(protect={protect} ber={ber:.1e}), corrected="
              f"{sum(v['corrected'] for v in est.values())} uncorrectable="
              f"{sum(v['uncorrectable'] for v in est.values())}")
    return edep, restacked


def default_seeds(seed: int, paths=()):
    """(static per-path plane seeds, dynamic base plane seeds) from ``seed``.

    Rule: ``np.random.SeedSequence([seed, 0x5EED]).generate_state(9 + 3n,
    np.uint32)`` gives its words in order as the (man, meta, cw) seeds of
    the embed image, of the unembed image, of the per-read dynamic runtime,
    then of each of the n other ``paths`` in their order (the stacked norm
    leaves the hbm path deploys). The first nine words do not depend on
    n."""
    extra = [p for p in paths if p not in ("embed", "unembed")]
    w = [int(v) for v in np.random.SeedSequence(
        [int(seed), _SEED_SALT]).generate_state(9 + 3 * len(extra),
                                                np.uint32)]
    planes = lambda a: {"man": a[0], "meta": a[1], "cw": a[2]}   # noqa: E731
    static = {"embed": planes(w[0:3]), "unembed": planes(w[3:6])}
    for i, p in enumerate(extra):
        static[p] = planes(w[9 + 3 * i:12 + 3 * i])
    return static, planes(w[6:9])


def check_text(cfg) -> None:
    """Serving is text-only, as the reference's launcher asserts."""
    if cfg.modality != "text":
        raise ValueError(f"{cfg.arch_id}: serving takes text archs; "
                         f"modality {cfg.modality!r} trains only")


def deploy(leaves, *, ber: float, protect: str, n_group: int, index: int,
           seeds: dict, fault_model: str = ""):
    """HBM path: align -> pack -> (inject) -> read. Returns the decoded
    leaves and the ECC stats of the read."""
    policy = serving_policy(protect=protect, n_group=n_group, index=index,
                            serve_path="hbm")
    dep = dep_lib.CIMDeployment.deploy(leaves, policy)
    if ber > 0:
        dep = dep.inject(seeds, ber, field="full", model=fault_model or None)
    return dep.read()


def make_deployment(leaves, *, ber: float, protect: str, n_group: int,
                    index: int, seeds: dict, inject_mode: str, field: str,
                    fault_model: str = "") -> dep_lib.CIMDeployment:
    """Fused path: align -> pack; static faults go into the image."""
    policy = serving_policy(protect=protect, n_group=n_group, index=index,
                            field=field, serve_path="fused")
    dep = dep_lib.CIMDeployment.deploy(leaves, policy)
    if ber > 0 and inject_mode == "static":
        dep = dep.inject(seeds, ber, field=field, model=fault_model or None)
    return dep


def serving_kw(*, ber: float, dynamic_seeds: dict, inject_mode: str,
               field: str, fault_model: str = "") -> dict:
    """The ``serving_params`` kwargs of this launch."""
    dynamic = ber > 0 and inject_mode == "dynamic"
    return dict(dynamic_seeds=dynamic_seeds if dynamic else None,
                ber=ber if dynamic else 0.0, field=field,
                model=(fault_model or None) if dynamic else None)


def fused_report(params: dict, mesh=None) -> dict:
    """Image bytes and ECC status counts of the packed leaves; on a mesh
    over the whole image (a sharded store's blocks summed over
    ``"model"``)."""
    rep = {"stores": 0, "cached": 0, "packed_bytes": 0, "fp16_bytes": 0,
           "corrected": 0, "uncorrectable": 0}
    blocks = {"packed_bytes": 0, "corrected": 0, "uncorrectable": 0}
    for leaf in params.values():
        if isinstance(leaf, cim_lib.CIMStore):
            sh = leaf.shard
            split = sh is not None and sh.sharded
            k, j = sh.global_shape if sh is not None else leaf.shape
            rep["stores"] += 1
            rep["cached"] += leaf.cache is not None
            rep["fp16_bytes"] += 2 * k * j
            st = dict(cim_lib.store_stats(leaf),
                      packed_bytes=leaf.stored_bytes)
            for key in blocks:
                (blocks if split else rep)[key] += st[key]
    if mesh is not None:
        blocks = shlib.sum_counts(blocks, shlib.MODEL_AXIS, mesh)
    return {key: v + blocks.get(key, 0) for key, v in rep.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_params(model: LM, *, seed: int = 0, cim: bool = False,
                 ber: float = 0.0, protect: str = "one4n", n_group: int = 8,
                 index: int = 2, serve_path: str = "fused",
                 inject: str = "static", field: str = "full",
                 static_seeds=None, dynamic_seeds=None, fault_model: str = "",
                 extra=None, verbose: bool = True, mesh=None):
    """The serving params of a launch -> (params or None for the model's own
    weights, ECC counts of the deployed image, fused report or None).
    ``extra`` (reference-layout leaves, e.g. :func:`expert_deploy`'s
    restacked experts) rides in the params. On a ``mesh`` the fused
    deployment is column-sharded over ``"model"`` after its static faults
    (the reference's order); the hbm path's decoded leaves stay whole on
    every rank."""
    dep_lib.check_enum("serve_path", serve_path, dep_lib.VALID_SERVE_PATHS,
                       "serve")
    dep_lib.check_enum("inject", inject, dep_lib.VALID_INJECTS, "serve")
    fm_lib.parse_fault_model(fault_model)      # validate the grammar eagerly
    check_text(model.cfg)
    params, ecc, report = None, {"corrected": 0, "uncorrectable": 0}, None
    if cim or ber > 0:
        leaves = model.cim_leaves()
        d_static, d_dynamic = default_seeds(seed, leaves)
        static_seeds = static_seeds or d_static
        dynamic_seeds = dynamic_seeds or d_dynamic
        if serve_path == "fused":
            dep = make_deployment(leaves, ber=ber, protect=protect,
                                  n_group=n_group, index=index,
                                  seeds=static_seeds, inject_mode=inject,
                                  field=field, fault_model=fault_model)
            if mesh is not None:
                dep = dep.shard(mesh, dim="j")
            params = dep.serving_params(**serving_kw(
                ber=ber, dynamic_seeds=dynamic_seeds, inject_mode=inject,
                field=field, fault_model=fault_model))
            report = fused_report(params, mesh)
            ecc = {k: report[k] for k in ecc}
            if verbose:
                print(f"CIM fused serve: {report['stores']} weight matrices "
                      f"stay packed ({report['packed_bytes'] / 1e6:.2f} MB "
                      f"image vs {report['fp16_bytes'] / 1e6:.2f} MB decoded "
                      f"fp16); {report['cached']} carry a decoded-row cache; "
                      f"corrected={ecc['corrected']} "
                      f"uncorrectable={ecc['uncorrectable']}")
        else:
            params, ecc = deploy(leaves, ber=ber, protect=protect,
                                 n_group=n_group, index=index,
                                 seeds=static_seeds, fault_model=fault_model)
            if verbose:
                print(f"CIM deploy (hbm): protect={protect} ber={ber:.1e} "
                      f"corrected={ecc['corrected']} "
                      f"uncorrectable={ecc['uncorrectable']}")
    if extra:
        params = {**extra, **(params or {})}
    return params, ecc, report


def serve(model: LM, *, batch: int = 4, prompt_len: int = 64, gen: int = 32,
          seed: int = 0, cim: bool = False, ber: float = 0.0,
          protect: str = "one4n", n_group: int = 8, index: int = 2,
          serve_path: str = "fused", inject: str = "static",
          field: str = "full", static_seeds=None, dynamic_seeds=None,
          fault_model: str = "", extra=None, verbose: bool = True,
          rounds: int = 1, mesh=None) -> dict:
    """Lock-step serve of ``rounds`` MarkovLM batches (round r's prompts
    are ``batch(r)``). Returns the last round's generated tokens [B, gen]
    and prefill logits, every round's tokens [rounds, B, gen], ECC counts,
    timings and the kernel launches of the run. ``fault_model`` (grammar
    string) shapes the static injection and the dynamic runtime.

    On a ``("data", "model")`` ``mesh`` each data rank serves its rows of
    the batch (all of it when the data axis does not divide it), the CIM
    stores are column-sharded over ``"model"``, and the rows are gathered
    back, so every rank returns the whole batch; ECC counts cover the whole
    image and ``launches`` are this rank's. A MoE layer dispatches through
    the all-to-all over ``"model"`` where the reference's conditions hold
    (prefill), and its dense dispatch gathers the global batch (decode)."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    cfg = model.cfg
    device = model.embed.device
    params, ecc, report = build_params(
        model, seed=seed, cim=cim, ber=ber, protect=protect, n_group=n_group,
        index=index, serve_path=serve_path, inject=inject, field=field,
        static_seeds=static_seeds, dynamic_seeds=dynamic_seeds,
        fault_model=fault_model, extra=extra, mesh=mesh,
        verbose=verbose and _is_rank0())
    rows = shlib.batch_rows(batch, mesh) if mesh is not None else slice(None)

    def gather(t):
        return t if rows == slice(None) \
            else shlib.all_gather_cat(t.contiguous(), "data", mesh, dim=0)

    data = MarkovLM(cfg.vocab_size, prompt_len, batch, seed=seed)
    before = dict(kernel_lib.launch_counts)
    prefill_s = decode_s = 0.0
    all_tokens = []
    with torch.inference_mode(), shlib.use_mesh(mesh), shlib.split_rows(
            mesh if rows != slice(None) else None):
        for r in range(rounds):
            prompts = torch.as_tensor(data.batch(r)["tokens"][rows],
                                      dtype=torch.int64, device=device)
            _sync(device)
            t0 = time.perf_counter()
            first_logits, caches = model.prefill(prompts, params,
                                                 max_len=prompt_len + gen)
            _sync(device)
            prefill_s += time.perf_counter() - t0
            toks = first_logits.argmax(-1)[:, None]
            out = [toks]
            t1 = time.perf_counter()
            for _ in range(gen - 1):
                logits, caches = model.decode(caches, toks, params)
                toks = logits.argmax(-1)[:, None]
                out.append(toks)
            _sync(device)
            decode_s += time.perf_counter() - t1
            all_tokens.append(gather(torch.cat(out, dim=1)).cpu().numpy())
        first_logits = gather(first_logits)
    launches = {k: v - before[k] for k, v in kernel_lib.launch_counts.items()}
    n_tok = rounds * batch * (gen - 1)
    tok_per_s = n_tok / max(decode_s, 1e-9)
    n_dev = 1 if mesh is None else mesh.size()
    res = {"tokens": all_tokens[-1], "round_tokens": np.stack(all_tokens),
           "prefill_logits": first_logits, "ecc": ecc, "report": report,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "tok_per_s": tok_per_s, "tok_per_s_device": tok_per_s / n_dev,
           "launches": launches}
    if verbose and _is_rank0():
        msg = (f"prefill: {rounds}x{batch}x{prompt_len} in "
               f"{prefill_s * 1e3:.1f} ms; decode: {tok_per_s:.1f} tok/s")
        if mesh is not None:
            msg += (f" aggregate / {res['tok_per_s_device']:.1f} tok/s/device "
                    f"(mesh {shlib.batch_ranks(mesh)}x"
                    f"{shlib.axis_size('model', mesh)} data x "
                    f"model, {n_dev} devices; ECC over the image: corrected="
                    f"{ecc['corrected']} uncorrectable="
                    f"{ecc['uncorrectable']})")
        print(msg + f"; kernel launches {launches}; "
              f"sample: {res['tokens'][0, :16].tolist()}")
    return res


def _is_rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _parse_range(spec: str) -> tuple:
    lo, hi = (int(v) for v in spec.split(","))
    if not 1 <= lo <= hi:
        raise ValueError(f"bad length range {spec!r}")
    return lo, hi


def _load(model: LM, requests, rate, prompt_range, gen_range, seed,
          shared_prefix) -> engine_lib.LoadGen:
    return engine_lib.LoadGen(
        n_requests=requests, rate=rate if rate > 0 else float("inf"),
        prompt_lens=tuple(prompt_range), gen_lens=tuple(gen_range),
        vocab_size=model.cfg.vocab_size, seed=seed, prefix_len=shared_prefix)


def _probe_record(rid: int, routed, solo, what: str, verbose: bool) -> dict:
    """Compare a re-served request with the run's -> the probe record;
    raises unless tokens and ECC charges match."""
    record = {"rid": rid, "tokens_equal": routed.tokens == solo.tokens,
              "ecc_equal": routed.ecc == solo.ecc}
    record["ok"] = record["tokens_equal"] and record["ecc_equal"]
    if verbose:
        print(f"probe rid={rid}: {what} "
              f"{'MATCHES' if record['ok'] else 'DIVERGES'} (tokens "
              f"{record['tokens_equal']}, ecc {record['ecc_equal']})")
    if not record["ok"]:
        raise engine_lib.EngineError(f"{what} probe failed: {record}")
    return record


def serve_engine(model: LM, params, *, slots: int = 4, chunk: int = 16,
                 max_len: int = 0, requests: int = 16, rate: float = 0.0,
                 prompt_range=(8, 32), gen_range=(4, 16), seed: int = 0,
                 shared_prefix: int = 0, ecc_accounting: bool = True,
                 probe: int = -1, scrubber=None, verbose: bool = True,
                 mesh=None):
    """Serve a synthetic load through the continuous-batching engine ->
    (results by rid, aggregate, probe record or None). ``rate`` 0 means all
    requests arrive at once; ``shared_prefix`` > 0 prepends one shared
    prefix to every prompt and attaches a prefix cache. ``probe`` >= 0
    re-serves that request through a fresh engine of the same shape and
    raises unless its tokens and ECC charges match the co-batched run.
    ``scrubber`` (a :class:`~repro_torch.launch.scrub.ScrubController`)
    runs after every engine step. On a ``mesh`` the engine (and the probe's)
    runs on it, over ``params`` placed there."""
    if scrubber is not None and probe >= 0:
        raise ValueError("--probe replays against the launch image; "
                         "--scrub rewrites it")
    if scrubber is not None and not ecc_accounting:
        raise ValueError("--scrub thresholds on the per-store ECC "
                         "accounting; drop --no-ecc-accounting")
    load = _load(model, requests, rate, prompt_range, gen_range, seed,
                 shared_prefix)
    max_len = max_len or load.max_len()
    kw = dict(n_slots=slots, max_len=max_len, chunk=chunk,
              ecc_accounting=ecc_accounting,
              prefix_cache=True if shared_prefix > 0 else None, mesh=mesh)
    eng = engine_lib.Engine(model, params, **kw)
    reqs = load.requests()
    with torch.inference_mode():
        results, agg = eng.run(reqs, open_loop=rate > 0, on_step=scrubber)
    missing = [r.rid for r in reqs if r.rid not in results]
    if missing:
        raise engine_lib.EngineError(f"engine dropped requests: {missing}")
    if verbose:
        print(f"engine: {agg['n_requests']} requests over {slots} slots "
              f"(chunk {eng.chunk}, max_len {max_len}); "
              f"{agg['total_tokens']} tokens in {agg['decode_steps']} decode "
              f"steps, occupancy {agg['slot_occupancy']:.2f}; prefix hits "
              f"{agg['prefix_hits']}")
        print(f"decode: {agg['decode_tok_s']:.1f} tok/s aggregate; TTFT mean "
              f"{agg['ttft_s_mean'] * 1e3:.0f} ms p95 "
              f"{agg['ttft_s_p95'] * 1e3:.0f} ms; ECC reads="
              f"{agg['ecc']['reads']} corrected={agg['ecc']['corrected']} "
              f"uncorrectable={agg['ecc']['uncorrectable']}")
        if scrubber is not None:
            sc = agg["scrub"]
            print(f"scrub: {sc['events']} events, {sc['rows_reencoded']} "
                  f"rows re-encoded, corrected cleared "
                  f"{sc['corrected_cleared']}, uncorrectable cleared "
                  f"{sc['uncorrectable_cleared']} ({sc['wall_s'] * 1e3:.0f} "
                  f"ms scrub wall)")
    record = None
    if probe >= 0:
        preq = [r for r in reqs if r.rid == probe]
        if not preq:
            raise ValueError(f"--probe {probe}: no such rid in the load")
        solo_eng = engine_lib.Engine(model, params, **kw)
        with torch.inference_mode():
            solo = solo_eng.run(preq)[0][probe]
        record = _probe_record(probe, results[probe], solo, "solo replay",
                               verbose)
    return results, agg, record


def serve_fleet(model: LM, params, *, fleet: int = 2, slots: int = 4,
                chunk: int = 16, max_len: int = 0, requests: int = 16,
                rate: float = 0.0, prompt_range=(8, 32), gen_range=(4, 16),
                seed: int = 0, shared_prefix: int = 0,
                prefix_cache: bool = True, ecc_accounting: bool = True,
                probe: int = -1, spool_dir=None, verbose: bool = True,
                meshes=None):
    """Serve a synthetic load through ``fleet`` engine replicas behind the
    SLO router -> (results by rid, aggregate, probe record or None).
    ``probe`` >= 0 re-serves that request through a fresh one-replica fleet
    restored from the same spool and raises unless its tokens and ECC
    charges match the routed run. ``meshes`` (``fleet.make_fleet_meshes``)
    puts each replica on its block; the probe then runs on every block,
    each on its own replica's mesh."""
    load = _load(model, requests, rate, prompt_range, gen_range, seed,
                 shared_prefix)
    max_len = max_len or load.max_len()
    kw = dict(spool_dir=spool_dir, prefix_cache=prefix_cache, n_slots=slots,
              max_len=max_len, chunk=chunk, ecc_accounting=ecc_accounting)
    fl = fleet_lib.Fleet.from_serving_params(model, params, n_replicas=fleet,
                                             meshes=meshes, **kw)
    reqs = load.requests()
    with torch.inference_mode():
        results, agg = fl.run(reqs, open_loop=rate > 0)
    missing = [r.rid for r in reqs if r.rid not in results]
    if missing:
        raise fleet_lib.FleetError(f"fleet dropped requests: {missing}")
    if verbose:
        by_rep = " ".join(f"{k}={v}" for k, v in
                          sorted(agg["requests_by_replica"].items()))
        sp = agg["spool"]
        print(f"fleet: {agg['n_requests']} requests over "
              f"{agg['n_replicas']} replicas x {slots} slots (chunk "
              f"{chunk}, max_len {max_len}); routed {by_rep}; spool "
              f"{sp['bytes'] / 1e6:.2f} MB, saved in {sp['save_s']:.2f} s, "
              f"restored {1 if meshes is not None else fleet}x here in "
              f"{sp['restore_s']:.2f} s")
        print(f"fleet: {agg['tok_s']:.1f} tok/s wall, "
              f"{agg['tok_s_virtual']:.1f} tok/s virtual (busy wall "
              f"{agg['busy_wall_s']:.2f} s of {agg['wall_s']:.2f} s); TTFT "
              f"mean {agg['ttft_s_mean'] * 1e3:.0f} ms p95 "
              f"{agg['ttft_s_p95'] * 1e3:.0f} ms; prefix hits "
              f"{agg['prefix_hits']} ({agg['prefix_tokens']} tokens reused)")
    record = None
    if probe >= 0:
        preq = [r for r in reqs if r.rid == probe]
        if not preq:
            raise ValueError(f"--probe {probe}: no such rid in the load")
        kw["spool_dir"] = fl.spool_dir
        if meshes is not None:
            kw["mesh"] = meshes[meshes.replica]
        pf = fleet_lib.Fleet.from_serving_params(model, params, n_replicas=1,
                                                 **kw)
        with torch.inference_mode():
            solo = pf.run(preq)[0][probe]
        routed = results[probe]
        record = _probe_record(probe, routed, solo,
                               f"routed via {routed.replica!r}, solo replay",
                               verbose)
        record["replica_routed"] = routed.replica
    return results, agg, record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cim", action="store_true", help="serve via CIM image")
    ap.add_argument("--ber", type=float, default=0.0)
    ap.add_argument("--protect", default="one4n",
                    choices=["one4n", "per_weight", "none"])
    ap.add_argument("--n-group", type=int, default=8)
    ap.add_argument("--index", type=int, default=2)
    ap.add_argument("--serve-path", default="fused", choices=["fused", "hbm"])
    ap.add_argument("--inject", default="static", choices=["static", "dynamic"])
    ap.add_argument("--field", default="full",
                    choices=["full", "mantissa", "exponent_sign"])
    ap.add_argument("--fault-model", default="", metavar="SPEC",
                    help="fault process of the injected errors (default "
                         "i.i.d.): burst[:rate=,length=,axis=row|col|bank], "
                         "correlated[:strength=,period=], "
                         "drift[:drift_rate=,tick=]")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a (data, model) mesh of D x M ranks, one "
                         "process a device (torchrun; 1x1 without it): "
                         "request rows split over 'data', CIM stores "
                         "column-shard over 'model' (NCCL on cuda, gloo on "
                         "cpu)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="number of successive request batches to serve")
    # continuous-batching engine mode (repro_torch.launch.engine)
    ap.add_argument("--engine", action="store_true",
                    help="serve a synthetic request stream through the "
                         "continuous-batching engine instead of one "
                         "lock-step batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine decode slots (the fixed co-batch width)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="engine prefill chunk length (ragged prompts)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="engine per-slot K/V rows (0: fit the load)")
    ap.add_argument("--requests", type=int, default=16,
                    help="engine load: number of requests")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="engine load: Poisson arrival rate in req/s "
                         "(0: all arrive at t=0)")
    ap.add_argument("--prompt-range", default="8,32", metavar="LO,HI",
                    help="engine load: uniform prompt-length range")
    ap.add_argument("--gen-range", default="4,16", metavar="LO,HI",
                    help="engine load: uniform generation-length range")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="L",
                    help="engine load: prepend one shared L-token prefix to "
                         "every prompt and serve it through a prefix cache")
    ap.add_argument("--engine-json", default=None, metavar="PATH",
                    help="write the engine's per-request ECC/latency JSON")
    ap.add_argument("--no-ecc-accounting", action="store_true",
                    help="skip per-read ECC accounting (a dynamic charge "
                         "re-decodes the codeword planes on every read)")
    ap.add_argument("--probe", type=int, default=-1, metavar="RID",
                    help="engine: re-serve request RID through a fresh "
                         "engine (fleet: a fresh one-replica fleet from the "
                         "same spool) and fail unless its tokens and ECC "
                         "match the co-batched (routed) run")
    # online ECC scrubbing (repro_torch.launch.scrub, engine mode)
    ap.add_argument("--scrub", action="store_true",
                    help="engine: when a store's cumulative ECC events reach "
                         "--scrub-threshold, re-encode its image and swap "
                         "the params mid-flight (fused CIM path only)")
    ap.add_argument("--scrub-threshold", type=int, default=16,
                    help="scrub: per-store cumulative ECC events before a "
                         "re-encode")
    ap.add_argument("--scrub-interval", type=int, default=1,
                    help="scrub: check cadence in engine steps")
    ap.add_argument("--age-ber", type=float, default=0.0,
                    help="scrub soak: static wear injected at this BER under "
                         "--fault-model (default drift) every --age-every "
                         "engine steps; damage stays until scrubbed")
    ap.add_argument("--age-every", type=int, default=1,
                    help="scrub soak: age every N engine steps")
    # fleet mode (repro_torch.launch.fleet)
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve the engine load through N replicas behind "
                         "the SLO router (one image, spooled once and "
                         "restored per replica)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="fleet: no per-replica prefix cache")
    ap.add_argument("--expert-cim", action="store_true",
                    help="MoE archs: deploy every expert's matrices as its "
                         "own per-expert CIM store (static faults, decode-"
                         "once restack; per-expert ECC in the artifact)")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        raise ValueError("--rounds must be >= 1")
    if args.mesh and (args.engine or args.fleet > 0) and \
            (args.scrub or args.expert_cim):
        raise NotImplementedError(
            "--mesh with --scrub or --expert-cim: the scrubber and the "
            "expert deployment on a mesh wait for ROADMAP Queue 1 item 14b-3")
    mesh = meshes = None
    dev_type = "cuda" if torch.device(args.device).type == "cuda" else "cpu"
    # the mesh first: under torchrun it binds this process to its card
    if args.mesh and args.fleet > 0:
        meshes = fleet_lib.make_fleet_meshes(args.mesh, args.fleet, dev_type)
        mesh = meshes[meshes.replica]
    elif args.mesh:
        mesh = mesh_lib.make_serve_mesh(args.mesh, dev_type)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    check_text(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = LM(cfg, generator=gen, device=device)
    args.edep = None
    if args.expert_cim:
        # runs before the embed/unembed deploy, as the reference's launcher:
        # the serving params carry the experts the macros would serve
        args.edep, args.extra = expert_deploy(
            convert.expert_leaves(model), ber=args.ber, protect=args.protect,
            n_group=args.n_group, index=args.index, field=args.field,
            seed=args.seed, fault_model=args.fault_model)
    else:
        args.extra = None
    try:
        if args.fleet > 0:
            return _main_fleet(args, model, mesh, meshes)
        if args.engine:
            return _main_engine(args, model, mesh)
        return serve(model, batch=args.batch, prompt_len=args.prompt_len,
                     gen=args.gen, seed=args.seed, cim=args.cim, ber=args.ber,
                     protect=args.protect, n_group=args.n_group,
                     index=args.index, serve_path=args.serve_path,
                     inject=args.inject, field=args.field,
                     fault_model=args.fault_model, extra=args.extra,
                     rounds=args.rounds, mesh=mesh)
    finally:
        if mesh is not None:
            mesh_lib.destroy_world()



def _scrubber(args, model: LM):
    """``--scrub``: the fused deployment, its serving params and the
    controller that ages and scrubs it -> (params, controller)."""
    if not (args.cim or args.ber > 0) or args.serve_path != "fused":
        raise ValueError("--scrub needs the fused CIM serve path "
                         "(--cim --serve-path fused)")
    if args.expert_cim:
        raise ValueError("--scrub rewrites the embed/unembed image; with "
                         "--expert-cim it is not ported")
    static, dynamic = default_seeds(args.seed)
    dep = make_deployment(model.cim_leaves(), ber=args.ber,
                          protect=args.protect, n_group=args.n_group,
                          index=args.index, seeds=static,
                          inject_mode=args.inject, field=args.field,
                          fault_model=args.fault_model)
    kw = serving_kw(ber=args.ber, dynamic_seeds=dynamic,
                    inject_mode=args.inject, field=args.field,
                    fault_model=args.fault_model)
    aging = None
    if args.age_ber > 0:
        aging = scrub_lib.DriftAging(seeds=args.seed, ber=args.age_ber,
                                     model=args.fault_model or "drift",
                                     every=args.age_every)
    ctl = scrub_lib.ScrubController(
        dep, scrub_lib.ScrubPolicy(threshold=args.scrub_threshold,
                                   interval=args.scrub_interval),
        aging=aging, serving_kw=kw)
    return dep.serving_params(**kw), ctl


def _write_json(args, keys, agg, probe, results) -> None:
    os.makedirs(os.path.dirname(args.engine_json) or ".", exist_ok=True)
    payload = {"config": {k: getattr(args, k) for k in keys},
               "aggregate": agg, "probe": probe,
               "expert_ecc": (args.edep.stats_by_expert()
                              if args.edep is not None else None),
               "requests": [results[r].to_json() for r in sorted(results)]}
    with open(args.engine_json, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {args.engine_json}")


_JSON_KEYS = ("arch", "reduced", "slots", "chunk", "max_len", "requests",
              "rate", "ber", "protect", "inject", "serve_path", "seed",
              "fault_model", "shared_prefix", "device", "expert_cim")


def _main_engine(args, model: LM, mesh=None):
    """``--engine``: deploy as the lock-step launch does (placed on
    ``mesh``), then serve the load through the engine (and write
    ``--engine-json``, rank 0)."""
    scrubber = None
    if args.scrub:
        params, scrubber = _scrubber(args, model)
    else:
        params, _, _ = build_params(
            model, seed=args.seed, cim=args.cim, ber=args.ber,
            protect=args.protect, n_group=args.n_group, index=args.index,
            serve_path=args.serve_path, inject=args.inject, field=args.field,
            fault_model=args.fault_model, extra=args.extra, mesh=mesh,
            verbose=_is_rank0())
    results, agg, probe = serve_engine(
        model, params, slots=args.slots, chunk=args.chunk,
        max_len=args.max_len, requests=args.requests, rate=args.rate,
        prompt_range=_parse_range(args.prompt_range),
        gen_range=_parse_range(args.gen_range), seed=args.seed,
        shared_prefix=args.shared_prefix,
        ecc_accounting=not args.no_ecc_accounting, probe=args.probe,
        scrubber=scrubber, mesh=mesh, verbose=_is_rank0())
    if args.engine_json and _is_rank0():
        _write_json(args, _JSON_KEYS + ("scrub", "age_ber"), agg, probe,
                    results)
    return results, agg


def _main_fleet(args, model: LM, mesh=None, meshes=None):
    """``--fleet N``: deploy as the lock-step launch does (placed on this
    rank's replica mesh), then serve the load through N replicas (and write
    ``--engine-json``, rank 0)."""
    params, _, _ = build_params(
        model, seed=args.seed, cim=args.cim, ber=args.ber,
        protect=args.protect, n_group=args.n_group, index=args.index,
        serve_path=args.serve_path, inject=args.inject, field=args.field,
        fault_model=args.fault_model, extra=args.extra, mesh=mesh,
        verbose=_is_rank0())
    results, agg, probe = serve_fleet(
        model, params, fleet=args.fleet, slots=args.slots, chunk=args.chunk,
        max_len=args.max_len, requests=args.requests, rate=args.rate,
        prompt_range=_parse_range(args.prompt_range),
        gen_range=_parse_range(args.gen_range), seed=args.seed,
        shared_prefix=args.shared_prefix,
        prefix_cache=not args.no_prefix_cache,
        ecc_accounting=not args.no_ecc_accounting, probe=args.probe,
        meshes=meshes, verbose=_is_rank0())
    if args.engine_json and _is_rank0():
        _write_json(args, _JSON_KEYS + ("fleet", "no_prefix_cache"), agg,
                    probe, results)
    return results, agg


if __name__ == "__main__":
    main()
