"""The block kinds beyond ``attn`` (``local``, ``rwkv``, ``rec``, ``moe``)
against the JAX reference, at the model level, on reduced configs.

Both packages start from one set of weights in the reference's
``init_lm`` layout, drawn from a numpy seed, every leaf the reference
initialises to a constant (norms, RWKV's token-shift and channel-mix
lerps, its group-norm scale and decay base, RG-LRU's gates and conv bias)
drawn too, so a swapped or missing term shows. The kinds:
rwkv6-1.6b, recurrentgemma-9b at 5 layers (12 groups of (rec, rec, local)
reduce to one group plus a 2-block tail), qwen3-moe-235b-a22b, dbrx-132b
and a pure ``local`` olmo-1b with an 8-token window (the ring wraps).

Tolerances, as ROADMAP's north star sets them: floats within
allclose(rtol=1e-4, atol=1e-5) (the chunked WKV, the scan and the MoE
sums run in another order than XLA's), greedy tokens equal, ring
positions and MoE ranks bitwise. Flatten order and the 2-D leaf set (what
a ``pattern="*"`` deployment packs) must equal the reference's for all
four new configs.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.common import CONSTANT_LEAF_DRAWS  # noqa: E402
from repro_torch.models.rglru import associative_scan  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
NEW = ("rwkv6-1.6b", "recurrentgemma-9b", "qwen3-moe-235b-a22b", "dbrx-132b")
KINDS = {   # kind -> (arch, config overrides)
    "local": ("olmo-1b", dict(block_pattern=("local",), local_window=8)),
    "rwkv": ("rwkv6-1.6b", {}),
    "rec": ("recurrentgemma-9b", dict(n_layers=5)),
    "moe": ("qwen3-moe-235b-a22b", {}),
    "dbrx": ("dbrx-132b", {}),
}
SLOTS, MAX_LEN, CHUNK = 3, 24, 8
# XLA options of the reference's programs: each runs once on toy shapes, so
# LLVM's optimisation passes cost more than they save; at level 0 the
# results move by an ulp or two, well inside RTOL/ATOL, at half the compile
O0 = {"xla_backend_optimization_level": 0}
jit = functools.partial(jax.jit, compiler_options=O0)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _paths(tree_):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree_)[0]]


def init_params(jcfg, seed: int):
    """Weights in the reference's ``init_lm`` layout (its tree, taken from
    ``jax.eval_shape``: nothing compiles), drawn from a numpy seed as its
    initialisers draw them (fan-in normals for the matrices, 0.02 for the
    embeddings, its scales for the LoRAs, the bonus and the conv), except
    that every leaf it initialises to a constant is drawn too (scale s
    around mean m, ``CONSTANT_LEAF_DRAWS``); the decay base spread over
    [-9, 3] hits the decay clamp at both ends."""
    rng = np.random.default_rng(seed)
    small = {"ts_lora_b": 0.01, "decay_lora_b": 0.01, "conv_w": 0.1,
             "embed": 0.02, "unembed": 0.02}

    def draw(path, a):
        name = str(getattr(path[-1], "key", ""))
        z = rng.standard_normal(a.shape)
        if name in CONSTANT_LEAF_DRAWS:
            s, m = CONSTANT_LEAF_DRAWS[name]
            z = m + s * z
        elif name == "rg_lambda":
            u = rng.uniform(0.9, 0.999, a.shape)
            z = np.log(np.expm1(-np.log(u) / 8.0))
        else:
            z = z * small.get(name, a.shape[-2] ** -0.5)
        return z.astype(a.dtype)
    shapes = jax.eval_shape(lambda: j_lm.init_lm(jax.random.PRNGKey(0),
                                                 jcfg))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@dataclasses.dataclass
class Ref:
    jcfg: object
    jp: dict
    cfg: object
    model: object


@functools.lru_cache(maxsize=None)
def reference(arch: str, seed: int = 0, **overrides) -> Ref:
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jp = init_params(jcfg, seed + 100)
    model = t_lm.LM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jp, cfg))
    return Ref(jcfg, jp, cfg, model)


def _kind(kind: str) -> Ref:
    arch, ov = KINDS[kind]
    return reference(arch, **ov)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", NEW)
def test_config_fields_match_reference(arch):
    """Every field the port carries, full and reduced, and the tag."""
    for t, j in ((get_config(arch), j_get_config(arch)),
                 (get_config(arch).reduced(), j_get_config(arch).reduced())):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
        assert [t.layer_kind(i) for i in range(t.n_layers)] == \
            [j.layer_kind(i) for i in range(j.n_layers)]


@pytest.mark.parametrize("kind", ["rwkv", "rec", "moe", "dbrx"])
def test_flatten_order_two_d_leaves_and_round_trip(kind):
    """``flat_from_lm`` lists the reference's leaves in its flatten order
    (the order that salts each leaf's fault stream), ``cim_leaves`` its 2-D
    leaves (stacked 1-D group leaves, the tail's matrices), and
    ``params_from_jax`` -> ``LM`` -> ``flat_from_lm`` is the identity,
    bitwise. recurrentgemma runs at 5 layers: one group of (rec, rec,
    local) and a tail of 2 unstacked blocks."""
    r = _kind(kind)
    paths = _paths(r.jp)
    leaves = jax.tree_util.tree_leaves(r.jp)
    flat = convert.flat_from_lm(r.model)
    assert list(flat) == paths
    for p, a in zip(paths, leaves):
        assert np.array_equal(flat[p].numpy(), a), p
    two_d = [p for p, a in zip(paths, leaves) if a.ndim == 2]
    assert list(r.model.cim_leaves()) == two_d
    if kind == "rec":
        assert "tail/1/rec/w_x" in two_d and "tail/0/norm1/scale" not in \
            two_d and "groups/blk2/norm1/scale" in two_d
    assert t_lm.param_count(flat) == j_lm.param_count(r.jp)


# ------------------------------------------------------------ sequences


MOE_KINDS = ("moe", "dbrx")


@functools.lru_cache(maxsize=None)
def _reference_runs(kind: str):
    """The reference's forward (logits, aux) over 2 x 21 tokens, and, for a
    MoE (whose capacity follows the token count), its prefill of the first
    20 followed by one decode step; other kinds' prefill and decode are
    held to the forward's logits."""
    r = _kind(kind)
    toks = _tokens(2, 2, 21)

    def fwd():
        f = jit(lambda p, t: j_lm.forward(p, r.jcfg, {"tokens": t},
                                              remat=False)[:2])
        return _np_tree(f(r.jp, toks))

    def pre_dec():
        pre, c = jit(lambda p, t: j_lm.prefill(
            p, r.jcfg, {"tokens": t}))(r.jp, toks[:, :20])

        def grow(a):
            if a.ndim >= 4 and a.shape[-3] == 20:
                pad = [(0, 0)] * a.ndim
                pad[-3] = (0, 1)
                return np.pad(a, pad)
            return a
        c = jax.tree_util.tree_map(grow, _np_tree(c))
        dec, _ = jit(lambda p, c, t: j_lm.decode(p, r.jcfg, c, t))(
            r.jp, c, toks[:, 20:])
        return np.asarray(pre), np.asarray(dec)
    if kind not in MOE_KINDS:
        return toks, fwd(), None
    with ThreadPoolExecutor(2) as ex:
        a, b = ex.submit(fwd), ex.submit(pre_dec)
        return toks, a.result(), b.result()


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_prefill_decode_match_reference(kind):
    """Forward logits and the MoE aux loss; lock-step prefill of 20 tokens
    then a decode step (the WKV's 20 tokens leave a ragged 4-token chunk,
    the ring wraps past its 8 slots). Without a MoE the prefill and decode
    logits also equal the forward's at positions 19 and 20 (a prefill then
    a decode is the prefill of the longer sequence); a MoE's capacity
    depends on the token count, so there they hold to the reference's own
    prefill and decode instead."""
    r = _kind(kind)
    toks, (j_logits, j_aux), pre_dec = _reference_runs(kind)
    t = torch.from_numpy(toks).to(torch.int64)
    with torch.no_grad():
        logits, aux = r.model(t, with_aux=True)
        pre, caches = r.model.prefill(t[:, :20], max_len=21)
        dec, _ = r.model.decode(caches, t[:, 20:])
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)
    assert (float(aux) > 0) == (kind in MOE_KINDS)
    j_pre, j_dec = pre_dec or (j_logits[:, 19], j_logits[:, 20])
    np.testing.assert_allclose(pre.numpy(), j_pre, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dec.numpy(), j_dec, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_query_chunked_prefill_matches_reference(kind):
    """With ``attn_chunk_threshold`` lowered below the sequence, the
    forward runs its queries in chunks of ``attn_chunk_q`` (the reference's
    ``_q_chunked``), local window included, and equals the reference's."""
    r = _kind("local")          # attn and local blocks hold the same leaves
    ov = dict(attn_chunk_threshold=8, attn_chunk_q=4,
              block_pattern=(kind,), local_window=6)
    jcfg = dataclasses.replace(r.jcfg, **ov)
    cfg = dataclasses.replace(r.cfg, **ov)
    model = t_lm.LM(cfg, device="cpu")
    model.load_state_dict(r.model.state_dict())
    toks = _tokens(3, 2, 16)
    calls = []
    real = j_attn._q_chunked
    try:        # the reference's run goes through its chunked path
        j_attn._q_chunked = lambda *a: calls.append(1) or real(*a)
        want = np.asarray(jit(lambda p, t: j_lm.forward(
            p, jcfg, {"tokens": t}, remat=False)[0])(r.jp, toks))
    finally:
        j_attn._q_chunked = real
    assert calls
    with torch.no_grad():
        got = model(torch.from_numpy(toks).to(torch.int64))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["rwkv", "rec"])
def test_serving_dict_leaves_replace_the_modules_own(kind):
    """What the hbm path serves: a params dict holding the 2-D leaves in the
    reference's layout (stacked group vectors, a row a layer; the tail's
    matrices whole) replaces the module's own, as a model loaded with those
    weights would compute, bitwise; lock-step and through the slot ops."""
    r = _kind(kind)
    rng = np.random.default_rng(11)
    over = {p: w * torch.from_numpy(rng.uniform(0.5, 1.5, tuple(w.shape))
                                    .astype(np.float32))
            for p, w in r.model.cim_leaves().items()
            if p not in ("embed", "unembed")}
    assert any(p.startswith("tail/") for p in over) == (kind == "rec")
    flat = dict(convert.flat_from_lm(r.model))
    flat.update(over)
    twin = t_lm.LM(r.cfg, device="cpu")
    twin.load_state_dict(convert.lm_state_from_flat(flat, r.cfg))
    t = torch.from_numpy(_tokens(12, 2, 11)).to(torch.int64)

    def run(m, p):
        with torch.no_grad():
            pre, caches = m.prefill(t[:, :10], p, max_len=11)
            dec, _ = m.decode(caches, t[:, 10:], p)
            slots = t_lm.init_slot_states(r.cfg, 2, 16, device="cpu")
            chunk, _ = m.prefill_chunk(slots, t[0, :8], 1, 0, 6, params=p)
        return pre, dec, chunk
    got, want = run(r.model, over), run(twin, None)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert not torch.equal(run(r.model, None)[0], got[0])


# ------------------------------------------------------------ the engine ops


def _ref_layer(jcaches, cfg, layer: int) -> dict:
    """Layer ``layer``'s state in the reference's stacked slot states."""
    prefix, row = convert.layer_slots(cfg)[layer]
    if row is None:
        return _np_tree(jcaches["tail"][int(prefix.split("/")[1])])
    return {k: np.asarray(v[row])
            for k, v in jcaches["groups"][prefix.split("/")[1]].items()}


def _close_states(cfg, caches, jcaches, what):
    for layer, (kind, state) in enumerate(zip(t_lm.layer_kinds(cfg),
                                              caches["layers"])):
        ref = _ref_layer(jcaches, cfg, layer)
        assert set(ref) == set(state), (what, layer)
        for n, t in state.items():
            if n == "pos":
                assert np.array_equal(t.numpy(), ref[n]), (what, layer, n)
            else:
                np.testing.assert_allclose(t.numpy(), ref[n], rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"{what} {layer} {n}")


@functools.lru_cache(maxsize=None)
def _reference_engine_ops(kind: str):
    """The reference's slot ops over a fixed script: slot 1 prefilled 13
    tokens in a full and a ragged (5 of 8) chunk, slot 0 a ragged 5-token
    prompt, slot 2 never admitted; then 3 decode steps with slot 2 idle.
    -> (prefill logits, [(decode logits, caches)], caches after prefill)."""
    r = _kind(kind)
    pre = jit(lambda p, c, t, s, q, n: j_lm.prefill_chunk(
        p, r.jcfg, c, t, s, q, length=n))
    dec = jit(lambda p, c, t, a: j_lm.decode_slots(p, r.jcfg, c, t, a))
    caches = j_lm.init_slot_states(r.jcfg, SLOTS, MAX_LEN)
    caches["pos"] = jax.numpy.zeros((SLOTS,), jax.numpy.int32)
    toks = _tokens(7, 18)
    logits = []
    for slot, c0, seg in ((1, 0, toks[:8]), (1, 8, toks[8:13]),
                          (0, 0, toks[13:18])):
        padded = np.pad(seg, (0, CHUNK - seg.size))
        lg, caches = pre(r.jp, caches, padded, slot, c0, seg.size)
        logits.append(np.asarray(lg))
    after = _np_tree(caches)
    active = np.array([True, True, False])
    nxt = np.array([[int(np.argmax(logits[2]))], [int(np.argmax(logits[1]))],
                    [0]], np.int32)
    steps = []
    for _ in range(3):
        lg, caches = dec(r.jp, caches, nxt, active)
        lg = np.asarray(lg)
        steps.append((lg, _np_tree(caches)))
        nxt = np.argmax(lg, -1).astype(np.int32)[:, None]
    return toks, logits, after, steps


@pytest.mark.parametrize("kind", list(KINDS))
def test_prefill_chunk_and_decode_slots_match_reference(kind):
    """The engine's slot ops against the reference's (plain weights): each
    chunk's logits, the slot states after the prefills (K/V rows, rings
    with their positions, fold states), three decode steps with slot 2
    idle (logits, greedy tokens equal, states). The idle slot's fold state
    stays zero on both sides, and for the fold kinds the port's chunked
    prefill of a slot equals, at its last token, the lock-step prefill of
    the same tokens."""
    r = _kind(kind)
    cfg = r.cfg
    toks, j_logits, j_after, j_steps = _reference_engine_ops(kind)
    caches = t_lm.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
    t = torch.from_numpy(toks).to(torch.int64)
    with torch.no_grad():
        for i, (slot, c0, seg) in enumerate(((1, 0, t[:8]), (1, 8, t[8:13]),
                                             (0, 0, t[13:18]))):
            padded = torch.cat([seg, seg.new_zeros(CHUNK - seg.shape[0])])
            lg, caches = r.model.prefill_chunk(caches, padded, slot, c0,
                                               seg.shape[0])
            np.testing.assert_allclose(lg.numpy(), j_logits[i], rtol=RTOL,
                                       atol=ATOL, err_msg=f"chunk {i}")
        _close_states(cfg, caches, j_after, "after prefill")
        if kind in ("rwkv", "rec"):
            # (a MoE's capacity follows the token count; a ring of W slots
            # that takes a chunk of W rows first drops keys that the chunk's
            # earlier queries need, in the reference as here)
            lock, _ = r.model.prefill(t[None, :13])
            np.testing.assert_allclose(lock[0].numpy(), j_logits[1],
                                       rtol=RTOL, atol=ATOL)
        active = np.array([True, True, False])
        nxt = torch.tensor([[int(np.argmax(j_logits[2]))],
                            [int(np.argmax(j_logits[1]))], [0]])
        for step, (j_lg, j_c) in enumerate(j_steps):
            lg, caches = r.model.decode_slots(caches, nxt, active)
            np.testing.assert_allclose(lg.numpy(), j_lg, rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {step}")
            assert np.array_equal(lg.argmax(-1).numpy()[:2],
                                  j_lg.argmax(-1)[:2])
            _close_states(cfg, caches, j_c, f"step {step}")
            nxt = lg.argmax(-1)[:, None]
    assert caches["pos_host"].tolist() == [8, 16, 0]
    for layer, kind_ in enumerate(t_lm.layer_kinds(cfg)):
        if t_lm.slot_state_spec(kind_).fold_state:
            assert all(not v[2].any() for v in caches["layers"][layer]
                       .values()), layer


@pytest.mark.parametrize("kind", ["local", "rwkv", "rec", "moe"])
def test_extract_inject_state_chunk(kind):
    """A state chunk extracted after a chunk's prefill and injected into
    another slot leaves that slot's state bitwise the source's: the K/V
    rows the chunk wrote (``'rows'``), the whole ring or fold
    (``'state'``); the rest of the target slot untouched."""
    r = _kind(kind)
    cfg = r.cfg
    caches = t_lm.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
    t = torch.from_numpy(_tokens(8, 8)).to(torch.int64)
    with torch.no_grad():
        r.model.prefill_chunk(caches, t, 0, 0)
    chunk = t_lm.extract_state_chunk(cfg, caches, 0, 0, 8)
    t_lm.inject_state_chunk(cfg, caches, 2, 0, chunk)
    for kind_, state in zip(t_lm.layer_kinds(cfg), caches["layers"]):
        for n, v in state.items():
            if t_lm.slot_state_spec(kind_).cache_unit == "rows":
                assert torch.equal(v[2, :8], v[0, :8]) and not v[2, 8:].any()
            else:
                assert torch.equal(v[2], v[0]), (kind_, n)
            assert not v[1].any() or n == "pos"


# ------------------------------------------------------------ MoE


def _moe_pair(seed: int, **overrides):
    jcfg = dataclasses.replace(j_get_config("qwen3-moe-235b-a22b").reduced(),
                               **overrides)
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              **overrides)
    rng = np.random.default_rng(seed)
    jp = {k: (rng.standard_normal(a.shape) * a.shape[-2] ** -0.5).astype(
        a.dtype) for k, a in jax.eval_shape(
            lambda: j_moe.init_moe(jax.random.PRNGKey(0), jcfg)).items()}
    m = t_moe.MoE(cfg, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in jp.items()})
    return jcfg, cfg, jp, m


@pytest.mark.parametrize("dispatch", ["sort", "cumsum", "a2a"])
def test_moe_dispatch_with_ties_and_binding_capacity(dispatch):
    """The dense dispatch against the reference's ``apply_moe``: outputs
    within allclose and the aux loss, on a batch whose router has two equal
    columns (experts 0 and 1 tie on every token: the lower index wins, as
    ``jax.lax.top_k``'s) and whose capacity binds (64 tokens at capacity
    factor 0.25: 8 slots an expert, so tokens drop; which ones follows the
    stable ranking)."""
    jcfg, cfg, jp, m = _moe_pair(5, capacity_factor=0.25,
                                 moe_dispatch=dispatch)
    jp["router"][:, 1] = jp["router"][:, 0]
    m.router.data[:, 1] = m.router.data[:, 0]
    x = np.random.default_rng(6).standard_normal((4, 16, 128)).astype(
        np.float32)
    want, j_aux = jit(lambda p, x: j_moe.apply_moe(p, jcfg, x))(jp, x)
    with torch.no_grad():
        got, aux = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)
    with torch.no_grad():
        probs = torch.softmax(torch.from_numpy(x).reshape(64, 128)
                              @ m.router, -1)
    _, ids = t_moe.top_k(probs, cfg.top_k)
    _, j_ids = jax.lax.top_k(np.asarray(probs), cfg.top_k)
    assert np.array_equal(ids.numpy(), np.asarray(j_ids))
    rows = ids.tolist()
    assert [0, 1] in rows           # the tied pair on top: 0 before 1
    for row in rows:                # 1 only right behind 0, 0 never last
        if 1 in row:                # unless k runs out
            assert row.index(1) == row.index(0) + 1, row
        if 0 in row[:-1]:
            assert row[row.index(0) + 1] == 1, row
    rank = t_moe.ranks(ids.reshape(-1), cfg.n_experts, t_moe.dispatch(cfg))
    assert (rank >= t_moe.capacity(cfg, 64)).any()        # capacity binds
    other = t_moe.ranks(ids.reshape(-1), cfg.n_experts,
                        "cumsum" if dispatch != "cumsum" else "sort")
    assert torch.equal(rank, other)       # both rankings, the same ranks


def test_capacity_and_drop_free_match_reference():
    for arch in ("qwen3-moe-235b-a22b", "dbrx-132b"):
        for base in (get_config(arch), get_config(arch).reduced()):
            for cf in (0.25, 1.0, 1.25, 4.0):
                cfg = dataclasses.replace(base, capacity_factor=cf)
                jcfg = dataclasses.replace(j_get_config(arch) if
                                           base.n_experts > 4 else
                                           j_get_config(arch).reduced(),
                                           capacity_factor=cf)
                for n in (1, 2, 7, 8, 9, 16, 33, 64, 200):
                    assert t_moe.capacity(cfg, n) == j_moe.capacity(jcfg, n)
                    assert t_moe.drop_free(cfg, n) == j_moe.drop_free(jcfg, n)
    red = get_config("qwen3-moe-235b-a22b").reduced()
    assert t_moe.drop_free(red, 8) and not t_moe.drop_free(red, 16)
    assert not t_lm.engine_capacity_coupled(red, 8)
    assert t_lm.engine_capacity_coupled(red, 16)


def test_associative_scan_matches_jax():
    """The RG-LRU's scan combines in ``jax.lax.associative_scan``'s order:
    the hidden states of the linear recurrence agree with the reference's
    scan within a float32 ulp or two, odd and even lengths, powers of two
    and their neighbours."""
    rng = np.random.default_rng(9)

    def combine(e1, e2):
        (a1, b1), (a2, b2) = e1, e2
        return [a1 * a2, a2 * b1 + b2]
    lengths = (1, 2, 3, 4, 5, 7, 8, 13, 16, 17, 31, 33)
    ab = [(rng.uniform(0.5, 1.0, (2, n, 64)).astype(np.float32),
           rng.standard_normal((2, n, 64)).astype(np.float32))
          for n in lengths]
    wants = jit(lambda xs: [jax.lax.associative_scan(      # one program
        lambda e1, e2: tuple(combine(e1, e2)), x, axis=1)[1] for x in xs])(ab)
    for n, (a, b), want in zip(lengths, ab, wants):
        got = associative_scan(combine, [torch.from_numpy(a),
                                         torch.from_numpy(b)], 1)[1].numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=str(n))
