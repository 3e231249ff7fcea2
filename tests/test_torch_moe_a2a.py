"""The expert-parallel all-to-all (``repro_torch.models.moe_a2a``) in one
process, every rank of a ``data x model`` mesh emulated through the
exchanges' in-process forms, against the reference.

At the widths of the reference's own all-to-all test
(``tests/test_distributed.py``: d_model 64, 8 experts, top-2, d_ff_expert
32), capacity factor 8.0 (no drops) and 1.25 (64 or 128 local tokens,
20 or 40 slots an expert: drops), over (data, model) meshes (1, 2), (1, 4)
and (2, 2):

* every rank's output equals the reference's ``repro.models.moe.apply_moe``
  on that rank's token slice alone, with no mesh, within allclose(1e-5,
  1e-5); its dropped assignments equal the reference's ranking on that
  slice (``moe_a2a._local_rank`` of ``jax.lax.top_k``'s ids at the local
  capacity) bitwise;
* the aux equals the mean of the per-slice auxes;
* gradients through both exchanges (input, router, experts) equal the
  port's dense dispatch's autograd on the slices;
* the route follows the reference's conditions over (E, ep, B, S), S = 1
  included: the reference's ``apply_moe`` is asked under a stand-in mesh
  which branch it takes.
"""
import dataclasses
import functools
import itertools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as j_shlib  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import moe_a2a as j_a2a  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import moe_a2a  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
WIDTHS = dict(d_model=64, n_experts=8, top_k=2, d_ff_expert=32)
B, S = 4, 64
MESHES = ((1, 2), (1, 4), (2, 2))
FACTORS = (8.0, 1.25)
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(cf: float):
    kw = dict(WIDTHS, capacity_factor=cf, moe_dispatch="a2a")
    return (dataclasses.replace(j_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(11)
    d, e, f = WIDTHS["d_model"], WIDTHS["n_experts"], WIDTHS["d_ff_expert"]
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "moe_wgate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "moe_win": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "moe_wout": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return w, x


def _weights(w, grad: bool = False):
    return tuple(torch.from_numpy(w[n]).clone().requires_grad_(grad)
                 for n in ("router", "moe_wgate", "moe_win", "moe_wout"))


@functools.lru_cache(maxsize=None)
def _reference(cf: float, data: int, model: int):
    """Per rank (d, m): the reference's apply_moe on its slice alone
    (output, aux) and its dropped assignments."""
    jcfg, _ = _cfgs(cf)
    w, x = _inputs()
    pb, ps = B // data, S // model
    apply = jax.jit(lambda p, xx: j_moe.apply_moe(p, jcfg, xx),
                    compiler_options=O0)

    @functools.partial(jax.jit, compiler_options=O0)
    def dropped(router, xx):
        probs = jax.nn.softmax((xx.reshape(-1, xx.shape[-1]) @ router), -1)
        _, ids = jax.lax.top_k(probs, jcfg.top_k)
        rank = j_a2a._local_rank(ids.reshape(-1), jcfg.n_experts)
        return rank >= j_moe.capacity(jcfg, xx.shape[0] * xx.shape[1])
    out = {}
    for d, m in itertools.product(range(data), range(model)):
        xs = x[d * pb:(d + 1) * pb, m * ps:(m + 1) * ps]
        o, aux = apply(w, xs)
        out[d, m] = (np.asarray(o), float(aux),
                     np.asarray(dropped(w["router"], xs)))
    return out


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_every_rank_is_the_reference_on_its_slice(cf, mesh):
    data, model = mesh
    _, cfg = _cfgs(cf)
    w, x = _inputs()
    want = _reference(cf, data, model)
    with torch.no_grad():
        out, aux, keeps = moe_a2a.apply_moe_a2a_local(
            _weights(w), cfg, torch.from_numpy(x), data, model)
    pb, ps = B // data, S // model
    drops = 0
    for (d, m), (o, _, j_drop) in want.items():
        np.testing.assert_allclose(
            out[d * pb:(d + 1) * pb, m * ps:(m + 1) * ps].numpy(), o,
            rtol=1e-5, atol=1e-5, err_msg=f"rank {(d, m)}")
        assert np.array_equal((~keeps[d][m]).numpy(), j_drop), (d, m)
        drops += int(j_drop.sum())
    # 8.0 never drops; at 1.25 a rank's 64 (128) tokens meet 20 (40)
    # slots an expert, and some expert draws more
    assert (drops > 0) == (cf == 1.25), drops
    np.testing.assert_allclose(float(aux), np.mean([a for _, a, _ in
                                                    want.values()]),
                               rtol=1e-6)
    # the MoE layer hands its leaves (here ``over``) to the all-to-all
    # where it routes there: the same bits
    layer = t_moe.MoE(cfg)
    over = dict(zip(("router", "moe_wgate", "moe_win", "moe_wout"),
                    _weights(w)))

    def in_process(weights, cfg, x):
        return moe_a2a.apply_moe_a2a_local(weights, cfg, x, data, model)[:2]
    with torch.no_grad(), \
            mock.patch.object(moe_a2a, "route", lambda *_: True), \
            mock.patch.object(moe_a2a, "apply_moe_a2a", in_process):
        got, got_aux = layer(torch.from_numpy(x), over)
    assert torch.equal(got, out) and torch.equal(got_aux, aux)


@pytest.mark.parametrize("cf", FACTORS)
def test_gradients_match_the_dense_dispatch(cf):
    """d/d(x, router, experts) of sum(out * r) + aux through both
    exchanges, against the dense dispatch of each slice with the mean of
    the slices' auxes, on a 2 x 2 mesh."""
    data, model = 2, 2
    _, cfg = _cfgs(cf)
    w, x = _inputs()
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(
        x.shape).astype(np.float32))

    def grads(fn):
        ws = _weights(w, grad=True)
        xt = torch.from_numpy(x).clone().requires_grad_(True)
        out, aux = fn(ws, xt)
        ((out * r).sum() + aux).backward()
        return [xt.grad] + [v.grad for v in ws]

    def a2a(ws, xt):
        out, aux, _ = moe_a2a.apply_moe_a2a_local(ws, cfg, xt, data, model)
        return out, aux

    def dense(ws, xt):
        pb, ps = B // data, S // model
        rows, auxes = [], []
        for d in range(data):
            cols = []
            for m in range(model):
                xs = xt[d * pb:(d + 1) * pb, m * ps:(m + 1) * ps]
                o, a, _ = t_moe.dense_dispatch(ws, cfg,
                                               xs.reshape(-1, xs.shape[-1]))
                cols.append(o.reshape(xs.shape))
                auxes.append(a)
            rows.append(torch.cat(cols, 1))
        return torch.cat(rows, 0), torch.stack(auxes).mean()
    for name, g, h in zip(("x", "router", "moe_wgate", "moe_win",
                           "moe_wout"), grads(a2a), grads(dense)):
        scale = float(h.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


class _Branch(Exception):
    pass


class _Router:
    """A router leaf that names the dense branch when the reference reads
    it."""

    def astype(self, _):
        raise _Branch("dense")


def _reference_branch(e: int, data: int, ep: int, b: int, s: int) -> str:
    class StandIn:                       # the reference reads these only
        axis_names = ("data", "model")
        shape = {"data": data, "model": ep}

    def a2a(*_):
        raise _Branch("a2a")
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), n_experts=e,
                               moe_dispatch="a2a")
    with mock.patch.object(j_a2a, "apply_moe_a2a", a2a), \
            j_shlib.use_mesh(StandIn()):
        try:
            j_moe.apply_moe({"router": _Router()}, jcfg,
                            np.zeros((b, s, 4), np.float32))
        except _Branch as got:
            return str(got)
    raise AssertionError("the reference took neither branch")


class _PortMesh:
    """What the port's sharding reads of a ``("data", "model")``
    DeviceMesh."""
    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, ep: int):
        self.shape = (data, ep)

    def size(self, mesh_dim=None) -> int:
        return self.shape[mesh_dim] if mesh_dim is not None \
            else self.shape[0] * self.shape[1]


def test_route_follows_the_reference_conditions():
    seen = set()
    for e, data, ep, b, s in itertools.product((4, 6, 8), (1, 2), (1, 2, 4),
                                               (1, 2, 3, 4), (1, 2, 6)):
        want = _reference_branch(e, data, ep, b, s)
        _, cfg = _cfgs(8.0)
        cfg = dataclasses.replace(cfg, n_experts=e)
        with shlib.use_mesh(_PortMesh(data, ep)):
            got = moe_a2a.route(cfg, b, s)
        assert got == (want == "a2a"), (e, data, ep, b, s)
        seen.add(want)
        # S = 1 (decode) never takes the all-to-all past one model rank
        if s == 1 and ep > 1:
            assert not got
    assert seen == {"a2a", "dense"}
    _, cfg = _cfgs(8.0)
    # under split_rows a rank's rows are its block of the global batch
    mesh = _PortMesh(2, 2)
    with shlib.use_mesh(mesh):
        assert not moe_a2a.route(cfg, 1, 4)
        with shlib.split_rows(mesh):
            assert moe_a2a.route(cfg, 1, 4)
        # another dispatch: the dense dispatch
        assert not moe_a2a.route(
            dataclasses.replace(cfg, moe_dispatch="sort"), 4, 4)
    # no mesh: the dense dispatch
    assert shlib.get_mesh() is None and not moe_a2a.route(cfg, 4, 4)


def test_in_process_exchanges():
    """The in-process all-to-all is its own inverse, and the all-gather
    gives every rank the concatenation."""
    parts = [torch.arange(12.).reshape(3, 4) + 100 * r for r in range(3)]
    swapped = shlib.all_to_all_local(parts)
    assert torch.equal(swapped[1][2], parts[2][1])
    back = shlib.all_to_all_local(swapped)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    whole = shlib.all_gather_local(parts, dim=1)
    assert all(torch.equal(g, torch.cat(parts, 1)) for g in whole)
