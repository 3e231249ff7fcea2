"""The port's device mesh against the reference's single-device image.

Single process (every shard of an n-way mesh in turn, as the plain functions
of ``(store, n_shards, index, dim)`` allow): for one4n, none and per_weight
stores, ``dim`` j and k, n in {2, 4},

* ``can_shard_store`` equals the reference's;
* each shard's planes equal the numpy block of the reference's packed planes;
* ``inject_sharded`` under i.i.d., burst row/col/bank, correlated and drift
  equals the block of the reference's single-device ``inject_with_seeds`` at
  the same seeds, bit for bit, and each shard's decode the block of the
  single-device decode;
* ``read_reference`` equals the reference's and ``read``, bitwise;
* the plain version's reads at shard offsets, gathered (j) or summed in shard
  order (k), agree with the reference's single-device ``cim_linear_store``
  within fp32 tolerance, static and dynamic;
* the stores the sharded route does not take report ``sharded=False``
  (``tests/test_serve_paths.py::test_sharded_linear_falls_back_without_
  kernel_support``), and a mesh that is not the world's size, a CUDA mesh
  without a card, and ``--scrub`` or ``--expert-cim`` on a mesh raise.

Several processes (4 gloo ranks, launched with torchrun's environment):
``serve --mesh 2x2 --rounds 2 --cim --serve-path fused --inject dynamic`` on
reduced olmo-1b, one4n and none, gives the reference's single-device tokens
and ECC totals (the serve report's and ``CIMDeployment.stats()`` of the
placed image); so does a one4n ``--inject static`` arm, whose image holds
corrected codewords, so its totals show the sum over the ``"model"`` axis.
The same spawn runs the engine on the 2x2 mesh (``serve --engine --mesh
2x2``: stores over "model", 4 slots split over "data", a shared prefix and
a solo probe), a fleet of 2 replicas on 1x2 blocks (``--fleet 2 --mesh
1x2``) and the 2-D (trial, model) sweep on 2x2; each gives the port's
single-device tokens and ECC charges, or cells. The trial mesh is
``tests/test_torch_mesh_trials.py``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import align as j_align  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import faultmodels as j_fm  # noqa: E402
from repro.data.synthetic import MarkovLM as JMarkovLM  # noqa: E402
from repro.kernels.cim_read import ops as j_cr_ops  # noqa: E402
from repro.kernels.fault_inject.ops import ber_to_threshold  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.kernels.cim_read import ops as t_ops  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from test_torch_serve import _reference_seeds  # noqa: E402

O0 = {"xla_backend_optimization_level": 0}
jit = functools.partial(jax.jit, compiler_options=O0)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

K, J = 128, 120                      # J pads to 128: the last column shard
PROTECTS = ("one4n", "none", "per_weight")  # holds padding
CASES = [(p, d, n) for p in PROTECTS for d in ("j", "k") for n in (2, 4)]
BER = 2e-3
MODELS = ("iid", "burst:rate=0.5,length=4,axis=row",
          "burst:rate=0.5,length=4,axis=col",
          "burst:rate=0.5,length=4,axis=bank",
          "correlated:strength=0.9,period=4", "drift:drift_rate=0.05,tick=3")
SEEDS = {"man": 0x1234567, "meta": 0x89ABCDE, "cw": 0x2468ACE}
PLANES = {"man": "man", "sign": "sign", "exp": "exp", "cw": "codewords"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def _block(a, n, i, sdim):
    a = np.asarray(a)
    size = a.shape[sdim] // n
    return np.take(a, np.arange(i * size, (i + 1) * size), axis=sdim)


def _planes(store) -> dict:
    return {k: getattr(store, v) for k, v in PLANES.items()
            if getattr(store, v) is not None}


@pytest.fixture(scope="module")
def reference():
    """Per protect: the reference's packed image, its injected images under
    every process, their decodes, its per-bit oracle read, and its
    single-device reads (static and dynamic) of one x; each computed once,
    the three protects side by side."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((K, J)) * 0.1).astype(np.float16) \
        .astype(np.float32)
    x = rng.standard_normal((4, K)).astype(np.float32)
    seeds = {k: jnp.uint32(v) for k, v in SEEDS.items()}
    thr = ber_to_threshold(BER)

    def one(protect):
        cfg = j_cim.CIMConfig(protect=protect)

        def run(w, x, cfg=cfg):
            al, _ = j_align.align_matrix(w, j_align.AlignmentConfig())
            store = j_cim.pack(al, cfg)
            inj = {m: j_cim.inject_with_seeds(
                store, seeds, thr, thr, model=j_fm.parse_fault_model(m))
                for m in MODELS}
            reads = {m: j_cim.read(s)[0] for m, s in inj.items()}
            sc = j_cr_ops.make_scalars(seeds, thr, thr)
            lin = {"static": j_cr_ops.cim_linear_store(x, store,
                                                       use_kernel=False),
                   "dynamic": j_cr_ops.cim_linear_store(
                       x, store, scalars=sc, use_kernel=False)}
            return store, inj, reads, j_cim.read_reference(inj["iid"]), lin
        # eagerly: one op at a time compiles less than one program at O0
        store, inj, reads, oracle, lin = run(jnp.asarray(w), jnp.asarray(x))
        return dict(store=store, inj=inj, reads=reads, oracle=oracle,
                    lin=lin, x=x)
    with ThreadPoolExecutor(len(PROTECTS)) as pool:   # compiles side by side
        return dict(zip(PROTECTS, pool.map(one, PROTECTS)))


def _t_store(js):
    planes = {v: None if getattr(js, v) is None else np.asarray(getattr(js, v))
              for v in PLANES.values()}
    cfg = t_cim.CIMConfig(protect=js.cfg.protect)
    return convert.store_from_numpy(planes, js.shape, cfg)


def test_can_shard_store_matches_reference(reference):
    for protect in PROTECTS:
        js = reference[protect]["store"]
        for k, j in ((128, 120), (72, 50), (96, 64), (256, 48)):
            jst = jax.eval_shape(lambda: j_cim.pack(
                jnp.zeros((k, j), jnp.float32), js.cfg))
            tst = t_cim.CIMStore(
                man=torch.empty(jst.man.shape, dtype=torch.uint16),
                sign=None if jst.sign is None else torch.empty(
                    jst.sign.shape, dtype=torch.int32),
                exp=None, codewords=None, shape=(k, j), cfg=t_cim.CIMConfig(
                    protect=protect))
            for n in (1, 2, 3, 4, 8):
                for dim in ("j", "k"):
                    assert t_cim.can_shard_store(tst, n, dim) == \
                        j_cim.can_shard_store(jst, n, dim), (protect, k, j,
                                                             n, dim)


@pytest.mark.parametrize("protect,dim,n", CASES)
def test_shard_planes_flips_and_decode(reference, protect, dim, n):
    """Planes, every process's flips, the decode and the oracle read of
    each shard against the blocks of the single-device image."""
    r = reference[protect]
    full = _t_store(r["store"])
    sdim = 0 if dim == "k" else 1
    assert t_cim.can_shard_store(full, n, dim)
    for i in range(n):
        shard = t_cim.shard_store(full, n, i, dim)
        assert shard.shard.sharded and shard.shard.offsets == (
            (i * K // n, 0) if dim == "k" else (0, i * 128 // n))
        for name, p in _planes(shard).items():
            want = _block(_planes(r["store"])[name], n, i, sdim)
            assert np.array_equal(_np(p.numpy()), _np(want)), (name, i)
        for m in MODELS:
            got = t_cim.inject_sharded(SEEDS, shard, BER, model=m)
            assert got.shard == shard.shard
            for name, p in _planes(got).items():
                want = _block(_planes(r["inj"][m])[name], n, i, sdim)
                assert np.array_equal(_np(p.numpy()), _np(want)), (m, name, i)
            # the decode's logical cells (the padding columns of the last
            # column shard hold flipped pad cells, which no read returns)
            w, _ = t_cim.read(got)
            want = np.asarray(r["reads"][m])
            if dim == "j":
                c0 = i * w.shape[1]
                w, want = w[:, :J - c0], want[:, c0:c0 + w.shape[1]]
            else:
                want = _block(want, n, i, 0)
            assert np.array_equal(_np(w.numpy()), _np(want)), (m, i)
        oracle, _ = t_cim.read_reference(t_cim.inject_sharded(SEEDS, shard,
                                                              BER))
        assert np.array_equal(_np(oracle.numpy()),
                              _np(t_cim.read(t_cim.inject_sharded(
                                  SEEDS, shard, BER))[0].numpy()))


@pytest.mark.parametrize("protect", PROTECTS)
def test_read_reference_matches_reference(reference, protect):
    r = reference[protect]
    inj = t_cim.inject(SEEDS, _t_store(r["store"]), BER)
    got, st = t_cim.read_reference(inj)
    assert np.array_equal(_np(got.numpy()), _np(r["oracle"][0]))
    assert st == {k: int(v) for k, v in r["oracle"][1].items()}
    w, st2 = t_cim.read(inj)
    assert np.array_equal(_np(got.numpy()), _np(w.numpy())) and st == st2


@pytest.mark.parametrize("protect,dim,n", CASES)
def test_offset_reads_combine_to_reference(reference, protect, dim, n):
    """The plain version at each shard's offsets, gathered (j) or summed in
    shard order (k), against the reference's single-device read."""
    r = reference[protect]
    full = _t_store(r["store"])
    x = torch.from_numpy(r["x"])
    thr = ber_to_threshold(BER)
    for mode, sc in (("static", None),
                     ("dynamic", t_ops.make_scalars(SEEDS, thr, thr))):
        parts = []
        for i in range(n):
            shard = t_cim.shard_store(full, n, i, dim)
            if dim == "j":
                parts.append(t_ops.cim_linear_store(x, shard, scalars=sc,
                                                    device="cpu"))
            else:
                xs = x[:, i * K // n:(i + 1) * K // n]
                parts.append(t_ops.cim_linear_store(xs, shard, scalars=sc,
                                                    device="cpu"))
        if dim == "j":
            got = torch.cat(parts, dim=-1)[:, :J]
        else:
            got = parts[0]
            for p in parts[1:]:
                got = got + p
        want = np.asarray(r["lin"][mode])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{mode}")
        if dim == "j":   # a column's K loop is its shard's: the same sums
            unsharded = t_ops.cim_linear_store(x, full, scalars=sc,
                                               device="cpu")
            np.testing.assert_allclose(got.numpy(), unsharded.numpy(),
                                       rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A 1x1 gloo mesh over a world-size-1 group (no torchrun)."""
    mesh = t_mesh.make_serve_mesh("1x1", "cpu")
    yield mesh
    t_mesh.destroy_world()


def test_unshardable_reads_report_unsharded(reference, one_rank_mesh):
    x = torch.from_numpy(reference["one4n"]["x"])
    pw = _t_store(reference["per_weight"]["store"])
    one4n = _t_store(reference["one4n"]["store"])
    placed = t_dep.place_stores({"pw": pw, "one4n": one4n}, one_rank_mesh)
    out, info = t_ops.cim_linear_store_sharded(x, placed["pw"],
                                               mesh=one_rank_mesh,
                                               with_info=True, device="cpu")
    assert not info["sharded"] and not info["used_kernel"]
    assert torch.equal(out, t_ops.cim_linear_store(x, pw, device="cpu"))
    out, info = t_ops.cim_linear_store_sharded(x, placed["one4n"],
                                               mesh=one_rank_mesh,
                                               with_info=True, device="cpu")
    assert info["sharded"]
    assert torch.equal(out, t_ops.cim_linear_store(x, one4n, device="cpu"))
    with pytest.raises(ValueError, match="not placed"):
        t_ops.cim_linear_store_sharded(x, one4n, mesh=one_rank_mesh,
                                       device="cpu")
    # the reference's rule: per_weight, a non-fp16 format, planes that do
    # not split evenly, a K shard over padded word lines
    assert not t_ops.sharded_route(pw, 2, "j")
    bf16 = t_cim.FloatFormat("bf16", 16, 8, 7, torch.bfloat16, torch.int16)
    bf = dataclasses.replace(one4n, cfg=t_cim.CIMConfig(fmt=bf16))
    assert not t_ops.sharded_route(bf, 2, "j")
    assert not t_ops.sharded_route(one4n, 3, "j")
    ragged = dataclasses.replace(one4n, shape=(K - 8, J))
    assert not t_ops.sharded_route(ragged, 2, "k")
    assert t_ops.sharded_route(ragged, 2, "j")


def test_mesh_refusals(one_rank_mesh):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        t_mesh.make_serve_mesh("2x2", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a card"):
            t_mesh.make_serve_mesh("1x1", "cuda")
    # the engine and the fleet run on meshes; the scrubber and the expert
    # deployment on a mesh do not yet
    for extra in (["--engine", "--scrub"], ["--fleet", "2", "--expert-cim"]):
        with pytest.raises(NotImplementedError, match="item 14b-3"):
            t_serve.main(["--reduced", "--device", "cpu", "--mesh", "1x1"]
                         + extra)


# ----------------------------------------------------- several processes

_WORKER = textwrap.dedent('''
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    payload = torch.load(sys.argv[1], weights_only=False)
    out = {}
    if payload["mode"] == "serve":
        from repro_torch.configs import get_config
        from repro_torch.launch import serve as t_serve
        from repro_torch.models.lm import LM
        mesh = mesh_lib.make_serve_mesh("2x2", "cpu")
        model = LM(get_config("olmo-1b").reduced(), device="cpu")
        model.load_state_dict(payload["state"])
        for arm, (protect, inject) in payload["arms"].items():
            static, dynamic = payload["seeds"][protect]
            res = t_serve.serve(model, mesh=mesh, static_seeds=static,
                                dynamic_seeds=dynamic, protect=protect,
                                inject=inject, verbose=False, **payload["kw"])
            out[arm] = {"tokens": res["round_tokens"], "ecc": res["ecc"]}
            # the deployment's own totals over the placed image
            dep = t_serve.make_deployment(
                model.cim_leaves(), ber=payload["kw"]["ber"], protect=protect,
                n_group=8, index=2, seeds=static, inject_mode=inject,
                field="full").shard(mesh)
            out[arm]["stats"] = dep.stats()
        # the engine on the 2x2 mesh: stores over "model", slots over "data"
        eng_kw = payload["engine"]
        static, dynamic = payload["seeds"]["one4n"]
        params = t_serve.build_params(
            model, cim=True, ber=payload["kw"]["ber"], inject="dynamic",
            static_seeds=static, dynamic_seeds=dynamic, mesh=mesh,
            verbose=False)[0]
        res, agg, probe = t_serve.serve_engine(model, params, mesh=mesh,
                                               verbose=False, **eng_kw)
        out["engine"] = {r: (v.tokens, v.ecc, v.ecc_window)
                         for r, v in res.items()}
        out["engine_probe"] = probe
        # a fleet of 2 replicas on 1x2 blocks of the same world
        from repro_torch.launch import fleet as t_fleet
        meshes = t_fleet.make_fleet_meshes("1x2", 2, "cpu")
        params = t_serve.build_params(
            model, cim=True, ber=payload["kw"]["ber"], inject="dynamic",
            static_seeds=static, dynamic_seeds=dynamic,
            mesh=meshes[meshes.replica], verbose=False)[0]
        res, agg, probe = t_serve.serve_fleet(
            model, params, fleet=2, meshes=meshes, verbose=False, **eng_kw)
        out["fleet"] = {r: (v.tokens, v.ecc, v.ecc_window)
                        for r, v in res.items()}
        out["fleet_by_replica"] = agg["requests_by_replica"]
        # the 2-D (trial, model) sweep
        from repro_torch.core import sweep as t_sweep
        from repro_torch.models import lm as t_lm
        from repro_torch.models.losses import lm_loss
        toks, labels = payload["sweep"]["data"]
        ev = lambda p: lm_loss(t_lm.forward(model, p, toks),
                               labels)[1]["accuracy"]
        eng = t_sweep.SweepEngine(payload["sweep"]["plan"], device="cpu",
                                  mesh=mesh_lib.make_sweep_mesh(2, 0, "cpu"))
        out["sweep"] = eng.run_protection(
            payload["sweep"]["seeds"], payload["sweep"]["flat"], ev)
    else:
        from repro_torch.core import sweep as t_sweep
        from repro_torch.models import cnn as t_cnn
        mesh = mesh_lib.make_trial_mesh(0, "cpu")
        xt, yt = payload["data"]
        ev = lambda p: (t_cnn.apply_cnn(p, xt).argmax(-1)
                        == yt).to(torch.float32).mean()
        eng = t_sweep.SweepEngine(payload["plan"], device="cpu", mesh=mesh)
        out = eng.run_protection(payload["seeds"], payload["params"], ev)
    if torch.distributed.get_rank() == 0:
        torch.save(out, sys.argv[2])
    mesh_lib.destroy_world()
''')


# Every rank runs its worker under this runner. It joins the default group
# through a file rendezvous in the test's directory, so no port is picked
# and handed on (the number a free-port probe returns can be taken by
# another process before rank 0 binds it). It ends with ``os._exit`` after
# flushing: torch's process-group teardown at interpreter exit aborts now
# and then ("terminate called without an active exception", SIGABRT) when
# several spawns load the machine at once, after the worker's work is done
# and written.
_RUNNER = textwrap.dedent('''
    import os, sys, traceback
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="file://" + os.environ["SPAWN_RENDEZVOUS"],
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    code = 0
    try:
        with open(os.environ["SPAWN_WORKER"]) as f:
            exec(compile(f.read(), os.environ["SPAWN_WORKER"], "exec"),
                 {"__name__": "__main__"})
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
''')

SPAWN_DEADLINE = 400.0     # seconds from the spawn to the last rank's exit


def _spawn(payload, tmp_path, world=4, worker=None,
           deadline=SPAWN_DEADLINE):
    """Start ``worker`` (default ``_WORKER``) on ``world`` gloo ranks with
    torchrun's rank environment -> a function that waits for them and
    returns rank 0's result (the caller computes the reference meanwhile).
    The ranks meet through a file rendezvous in ``tmp_path`` (``_RUNNER``)
    and write their output to ``rank{r}.log`` there; ``deadline`` seconds
    after the spawn every rank still running is killed, and a failure
    reports each rank's exit code and log."""
    src, dst = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save(payload, src)
    body = tmp_path / "worker.py"
    body.write_text(worker or _WORKER)
    end = time.monotonic() + deadline
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   SPAWN_RENDEZVOUS=str(tmp_path / "rendezvous"),
                   SPAWN_WORKER=str(body),
                   PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                                ""))
        for k in ("MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        logs.append(tmp_path / f"rank{rank}.log")
        with open(logs[-1], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RUNNER, str(src), str(dst)],
                env=env, stdout=log, stderr=subprocess.STDOUT))

    def result():
        late = []
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(end - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                late.append(rank)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if late or any(p.returncode for p in procs):
            raise AssertionError("\n".join(
                f"rank {r}: exit {p.returncode}"
                f"{' (killed at the deadline)' if r in late else ''}\n"
                f"{logs[r].read_text(errors='replace')[-4000:]}"
                for r, p in enumerate(procs)))
        return torch.load(dst, weights_only=False)
    return result


_PAIR_WORKER = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_trial_mesh(0, "cpu")
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    if dist.get_rank() == 0:
        torch.save(t, sys.argv[2])
''')


def test_spawn_takes_no_port(tmp_path, monkeypatch):
    """The ranks meet without a port: the one a free-port probe would hand
    out is held by a listening socket here, as another process could hold
    it, and the spawn still runs (a harness that handed that port to rank
    0's store fails here)."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as held:
        held.bind(("localhost", 0))
        held.listen()
        monkeypatch.setattr(t_mesh, "_free_port",
                            lambda: held.getsockname()[1])
        got = _spawn({}, tmp_path, world=2, worker=_PAIR_WORKER)()
    assert float(got) == 3.0


SERVE_KW = dict(batch=4, prompt_len=8, gen=4, seed=0, cim=True, ber=1e-3,
                serve_path="fused", rounds=2)
# the engine and fleet arms' load (4 slots split 2 a data rank) and the
# sweep arm's plan
ENGINE_KW = dict(slots=4, chunk=8, requests=6, prompt_range=(3, 12),
                 gen_range=(2, 4), seed=2, shared_prefix=8, probe=1)
# arm -> (protect, inject); the static arm's image holds corrected codewords
SERVE_ARMS = {"one4n": ("one4n", "dynamic"), "none": ("none", "dynamic"),
              "one4n-static": ("one4n", "static")}


def _jax_serve_rounds(jcfg, params, dkey, arms):
    """The reference launcher's lock-step rounds on one device, per arm:
    tokens [rounds, B, gen] and its fused report's ECC totals. Its fused
    reads run through their plain packed-jnp version (``use_kernel=False``),
    as ``tests/test_torch_arch_serve.py`` runs them: the same streams
    without the Pallas interpret compile. The arms compile side by side."""
    plain = functools.partial(j_cr_ops.cim_linear_store, use_kernel=False)
    with mock.patch.object(j_cr_ops, "cim_linear_store", plain), \
            ThreadPoolExecutor(len(arms)) as pool:
        return dict(zip(arms, pool.map(
            lambda a: _jax_rounds(jcfg, params, dkey, *arms[a]), arms)))


def _jax_rounds(jcfg, params, dkey, protect, inject):
    kw = SERVE_KW
    sp = jit(lambda p, k: j_serve.make_deployment(
        p, ber=kw["ber"], protect=protect, n_group=8, index=2, key=k,
        inject_mode=inject, field="full").serving_params(
            **j_serve.serving_kw(ber=kw["ber"], key=k,
                                 inject_mode=inject, field="full")))(
        params, dkey)
    prefill = jit(j_steps.make_prefill_step(jcfg))
    step = jit(j_steps.make_serve_step(jcfg))
    data = JMarkovLM(jcfg.vocab_size, kw["prompt_len"], kw["batch"],
                     seed=kw["seed"])

    def grow(a):
        if a.ndim >= 4 and a.shape[-3] == kw["prompt_len"]:
            pad = [(0, 0)] * a.ndim
            pad[-3] = (0, kw["gen"])
            return jnp.pad(a, pad)
        return a
    rounds = []
    for r in range(kw["rounds"]):
        logits, caches = prefill(sp, {"tokens": data.batch(r)["tokens"]})
        caches = jax.tree_util.tree_map(grow, caches)
        toks = jnp.argmax(logits, -1)[:, None]
        out = [toks]
        for _ in range(kw["gen"] - 1):
            logits, caches = step(sp, caches, toks)
            toks = jnp.argmax(logits, -1)[:, None]
            out.append(toks)
        rounds.append(np.asarray(jnp.concatenate(out, axis=1)))
    ecc = {"corrected": 0, "uncorrectable": 0}
    for leaf in jax.tree_util.tree_leaves(sp, is_leaf=j_cim._is_store):
        if isinstance(leaf, j_cim.CIMStore):
            st = j_cim.store_stats(leaf)
            ecc = {k: ecc[k] + int(st[k]) for k in ecc}
    return np.stack(rounds), ecc


def test_serve_2x2_mesh_rounds_match_reference(tmp_path):
    jcfg = j_get_config("olmo-1b").reduced()
    key = jax.random.PRNGKey(0)
    params = jit(j_lm.init_lm, static_argnums=1)(key, jcfg)
    dkey = jax.random.fold_in(key, 1)
    from repro_torch.configs import get_config
    state = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params),
                                    get_config("olmo-1b").reduced())
    seeds = {p: _reference_seeds(params, dkey, "fused", p)
             for p in ("one4n", "none")}
    model, sweep = _sweep_payload(state)
    result = _spawn({"mode": "serve", "state": state, "seeds": seeds,
                     "arms": SERVE_ARMS, "kw": SERVE_KW,
                     "engine": ENGINE_KW, "sweep": sweep}, tmp_path)
    want = _jax_serve_rounds(jcfg, params, dkey, SERVE_ARMS)
    single = _single_device_arms(model, seeds["one4n"], sweep)
    got = result()
    # the engine on 2x2 and the fleet of 2 x 1x2: the single-device engine's
    # tokens and ECC charges (every read's window) for every request; the
    # probe replays solo on the mesh
    for arm in ("engine", "fleet"):
        assert got[arm] == single["engine"], arm
    assert got["engine_probe"]["ok"]
    assert sum(got["fleet_by_replica"].values()) == ENGINE_KW["requests"]
    # the sweep on a 2x2 (trial, model) mesh: the single-device cells
    assert [(c.protect, c.accuracies, c.trial_corrected,
             c.trial_uncorrectable) for c in got["sweep"]] == \
        [(c.protect, c.accuracies, c.trial_corrected, c.trial_uncorrectable)
         for c in single["sweep"]]
    assert single["sweep"][-1].corrected > 0
    # a report that forgot the sum over "model", or summed over another
    # axis, would count half of these
    assert want["one4n-static"][1]["corrected"] > 0
    for arm in SERVE_ARMS:
        want_tokens, want_ecc = want[arm]
        assert got[arm]["tokens"].shape == (2, 4, 4)
        assert np.array_equal(got[arm]["tokens"], want_tokens), arm
        assert got[arm]["ecc"] == want_ecc, arm
        assert got[arm]["stats"] == want_ecc, arm


def _sweep_payload(state):
    """The port's reduced olmo-1b and the sweep arm's inputs: the plan (one4n
    and none, 2 trials), trial seeds, the flat params and the eval batch."""
    from repro_torch.configs import get_config
    from repro_torch.core import sweep as t_sweep
    from repro_torch.models import lm as t_lm
    model = t_lm.LM(get_config("olmo-1b").reduced(), device="cpu")
    model.load_state_dict(state)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (2, 8))).long()
    with torch.no_grad():
        labels = t_lm.forward(model, convert.flat_from_lm(model),
                              toks).argmax(-1)
    plan = t_sweep.SweepPlan(bers=(1e-2,), n_trials=2,
                             protects=("none", "one4n"))
    seeds = t_sweep.default_seeds(3, 2, 1, 2)
    return model, {"plan": plan, "seeds": seeds, "data": (toks, labels),
                   "flat": convert.flat_from_lm(model)}


def _single_device_arms(model, seeds, sweep):
    """The engine (and fleet) arms' and the sweep arm's single-device
    results in the port."""
    from repro_torch.core import sweep as t_sweep
    from repro_torch.models import lm as t_lm
    from repro_torch.models.losses import lm_loss
    static, dynamic = seeds
    params = t_serve.build_params(
        model, cim=True, ber=SERVE_KW["ber"], inject="dynamic",
        static_seeds=static, dynamic_seeds=dynamic, verbose=False)[0]
    kw = {k: v for k, v in ENGINE_KW.items() if k != "probe"}
    res = t_serve.serve_engine(model, params, verbose=False, **kw)[0]
    toks, labels = sweep["data"]
    ev = lambda p: lm_loss(t_lm.forward(model, p, toks),  # noqa: E731
                           labels)[1]["accuracy"]
    cells = t_sweep.SweepEngine(sweep["plan"], device="cpu").run_protection(
        sweep["seeds"], sweep["flat"], ev)
    return {"engine": {r: (v.tokens, v.ecc, v.ecc_window)
                       for r, v in res.items()}, "sweep": cells}
