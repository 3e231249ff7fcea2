"""The port's parameter sharding specs against the reference's.

For every leaf path of every config the port registers (reduced widths),
at the meshes 1x1, 2x2, 4x1, 8x1 and 1x4 of ``("data", "model")``:
``param_spec`` equals the reference's (whose ``logical`` runs under
``set_mesh`` of a one-device ``("data", "model")`` jax mesh: the names of
the axes are all it reads), ``sanitize_spec`` equals the reference's (given
a stand-in mesh that holds only a ``shape`` mapping), and
``launch.specs.state_shardings`` of an aligned state with its
error-feedback residuals equals the reference's ``state_shardings`` (its
``NamedSharding`` patched to hand back the spec), and
``sharding.param_shardings``'s specs the reference's ``param_shardings``
sanitized. Where the port's own
rule drops an axis that would cut an exponent group of 8 rows on a leaf's
alignment dim, the port's spec is the reference's with that axis dropped,
and nothing else differs. The rule's own test cuts a leaf of 24 rows on
a 4-way axis (6 rows a block).
"""
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from repro.distributed import sharding as j_sharding  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.configs.base import _REGISTRY  # noqa: E402
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training import steps  # noqa: E402

MESHES = ((1, 1), (2, 2), (4, 1), (8, 1), (1, 4))
ARCHS = tuple(sorted(_REGISTRY))
NAMES = ("data", "model")


@pytest.fixture(scope="module")
def one_device_mesh():
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), NAMES)
    with j_sharding.use_mesh(mesh):
        yield


def _standin(dims):
    return SimpleNamespace(shape=dict(zip(NAMES, dims)))


def _tuple(spec) -> tuple:
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _state(arch: str):
    """An aligned state of the reduced config with its residuals."""
    cfg = get_config(arch).reduced()
    model = lm.LM(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    run = RunConfig(checkpoint_dir="", grad_compression=True,
                    policy=ReliabilityPolicy(default=PolicyRule(
                        protect="one4n", n_group=8, index=2)))
    return steps.init_train_state(None, cfg, run,
                                  params=convert.flat_from_lm(model))


def _j_state(state):
    """The port's state as the reference's TrainState of shape structs."""
    def nest(flat):
        out = {}
        for p, t in flat.items():
            node = out
            *head, last = p.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = None if t is None else jax.ShapeDtypeStruct(
                tuple(t.shape), np.float32)
        return out
    return j_steps.TrainState(
        params=nest(state.params),
        opt={"m": nest(state.opt["m"]), "v": nest(state.opt["v"]),
             "step": jax.ShapeDtypeStruct((), np.int32)},
        exps=nest(state.exps), signs=nest(state.signs),
        ef_error=nest(state.ef_error))


def _flat_specs(tree) -> dict:
    """The reference's nested tree of specs -> ``{path: spec tuple}``
    (``None`` leaves kept)."""
    out = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, key + (k,))
        else:
            out["/".join(key)] = None if node is None else _tuple(node)
    walk(tree, ())
    return out


def _dropped(ref: tuple, port: tuple, shape, dims) -> bool:
    """True iff ``port`` is ``ref`` less its axis on dim ``ndim - 2``,
    whose blocks would hold a part of an 8-row exponent group."""
    g = len(shape) - 2
    if len(shape) < 2 or ref[g] is None or port[g] is not None:
        return False
    parts = 1
    for a in shlib._spec_axes(ref[g]):
        parts *= dict(zip(NAMES, dims))[a]
    return (shape[g] // parts) % 8 != 0 and \
        port == ref[:g] + (None,) + ref[g + 1:]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, one_device_mesh):
    state = _state(arch)
    jstate = _j_state(state)
    fired = 0
    for dims in MESHES:
        rank = shlib.VirtualMesh(NAMES, dims)
        standin = _standin(dims)
        for p, t in state.params.items():
            spec = shlib.param_spec(p, t.ndim, rank)
            assert spec == _tuple(j_sharding.param_spec(p, t.ndim)), (p, dims)
            assert shlib.sanitize_spec(rank, spec, t.shape) == _tuple(
                j_sharding.sanitize_spec(standin, j_sharding.param_spec(
                    p, t.ndim), t.shape)), (p, dims)
        spec_of = lambda mesh, spec: spec    # noqa: E731
        with mock.patch.object(j_specs, "NamedSharding", spec_of), \
                mock.patch.object(j_sharding, "NamedSharding", spec_of):
            want = j_specs.state_shardings(standin, jstate)
            rules = _flat_specs(j_sharding.param_shardings(standin,
                                                           jstate.params))
        got = specs.state_shardings(rank, state)
        # the inference layout: weights replicated over "data"
        with mock.patch.object(j_specs, "NamedSharding", spec_of), \
                mock.patch.object(j_sharding, "NamedSharding", spec_of):
            serve = _flat_specs(j_specs.param_shardings_sane(
                standin, jstate.params, serve_replicated=True))
        for p, lay in specs.param_shardings_sane(
                rank, state.params, serve_replicated=True).items():
            assert all(ax != "data" for ax in lay.spec), (p, dims)
            if lay.spec != serve[p]:
                assert _dropped(serve[p], lay.spec, state.params[p].shape,
                                dims), (p, dims, lay.spec, serve[p])
                fired += 1
        # param_shardings: the reference's (rule specs) sanitized
        for p, lay in shlib.param_shardings(rank, state.params).items():
            assert lay.spec == _tuple(j_sharding.sanitize_spec(
                standin, rules[p], state.params[p].shape)), (p, dims)
        trees = (("params", got.params, want.params),
                 ("m", got.opt["m"], want.opt["m"]),
                 ("v", got.opt["v"], want.opt["v"]),
                 ("exps", got.exps, want.exps),
                 ("signs", got.signs, want.signs),
                 ("ef_error", got.ef_error, want.ef_error))
        for name, g_tree, w_tree in trees:
            w_flat = _flat_specs(w_tree)
            assert set(w_flat) == set(g_tree), (name, dims)
            for p, lay in g_tree.items():
                ref = w_flat[p]
                if lay is None or ref is None:
                    assert lay is None and ref is None, (name, p)
                    continue
                if lay.spec != ref:
                    shape = state.params[p].shape
                    assert _dropped(ref, lay.spec, shape, dims), \
                        (name, p, dims, lay.spec, ref)
                    fired += 1
        assert got.opt["step"].spec == () and _tuple(want.opt["step"]) == ()
    assert fired == 0      # at reduced widths every block holds whole groups


def test_group_rule_drops_an_axis_that_cuts_a_group():
    """A [2, 24, 16] stacked w_gate on a 4-way "data" axis: the reference
    keeps "data" on its 24 rows (6 a block), the port drops it, keeping
    "model" on the columns; at 8 x 4 = 32 rows it keeps both."""
    rank = shlib.VirtualMesh(NAMES, (4, 2))
    for rows, want in ((24, (None, None, "model")),
                       (64, (None, "data", "model"))):
        t = torch.zeros((2, rows, 16))
        spec = specs.leaf_spec(rank, "groups/blk0/mlp/w_gate", t)
        assert spec == want, rows
        assert shlib.sanitize_spec(rank, shlib.param_spec(
            "groups/blk0/mlp/w_gate", 3, rank), t.shape) == \
            (None, "data", "model")
    # a 16-row group (a policy's n_group) cuts where 8 rows would not
    t = torch.zeros((2, 32, 16))
    assert specs.leaf_spec(rank, "groups/blk0/mlp/w_gate", t,
                           n_group=16) == (None, None, "model")


def test_layouts_tile_each_leaf():
    """The blocks of every rank of a mesh tile each leaf exactly once per
    replica group, and ``Layout.cut`` then ``specs.assemble`` give the leaf
    back; granite-3-8b's vocab of 49155 stays whole on "model"."""
    state = _state("olmo-1b")
    for dims in MESHES:
        ranks = shlib.ranks_of(NAMES, dims)
        for p, t in state.params.items():
            lays = [specs.param_shardings_sane(r, {p: t})[p] for r in ranks]
            cover = torch.zeros(t.shape, dtype=torch.int64)
            for lay in lays:
                lay.cut(cover).add_(1)
            reps = len(ranks) // len({lay.offsets for lay in lays})
            assert int(cover.min()) == int(cover.max()) == reps, (p, dims)
            got = specs.assemble([lay.cut(t) for lay in lays], lays)
            assert torch.equal(got, t)
    rank = shlib.VirtualMesh(NAMES, (1, 2))
    emb = torch.zeros((49155, 64))
    assert shlib.sanitize_spec(rank, shlib.param_spec("embed", 2, rank),
                               emb.shape) == (None, "data")
