"""Training the block kinds beyond ``attn`` (``rwkv``, ``rec``, ``moe``,
``local``) against the JAX reference: one aligned train step per reduced
kind from one state.

Both packages start from the weights of ``tests/test_torch_kinds.py``
(drawn with numpy into the reference's ``init_lm`` tree, every
constant-initialised leaf drawn too), aligned and frozen by the port's
``init_train_state`` and handed to the reference as its ``TrainState``
(the reference's eager alignment compiles every op of every leaf shape,
about half a minute a kind; its result is held bitwise here on one leaf
of each new layout: a stacked 1-D group leaf, a tail matrix, a stacked
expert tensor). recurrentgemma runs at 4 layers, so its
layout has a stacked (rec, rec, local) group and a one-block ``rec``
tail: the group's stacked 1-D leaves (RG-LRU gates, norms) and the
tail's matrices are 2-D in the reference's layout and must be aligned,
frozen and decayed as its rules pick them. The local kind runs a pure ``local`` olmo-1b with an 8-token
window over 16 tokens, so the band masks.

Tolerances, those of ``tests/test_torch_arch.py``: loss, accuracy, the MoE
aux loss and the gradient norm within 1e-4 relative; the gradients (read
from AdamW's first moment, which after one step is ``(1 - b1)`` times the
clipped gradient on both sides) within allclose(rtol=1e-4, atol=1e-5) of
the leaf's largest; every stepped parameter within one fp16 ulp where its
clipped gradient exceeds ``GRAD_FLOOR`` = 1e-6. Below it AdamW's first
update is ``lr * g / (|g| + eps)`` with eps = 1e-8, which passes a tiny
gradient's summation-order error on whole (recurrentgemma's
``w_down`` moved 7 ulps apart at a gradient of that size, as rwkv's
``ts_lora_b`` did card against CPU); those gradients are held by the
allclose above. The reference's train step is compiled at XLA's backend
optimisation level 0 (``tests/test_torch_kinds.py``'s ``O0``).
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_kinds import O0, reference  # noqa: E402
from test_torch_train import _fp16_ulps, _np_tree  # noqa: E402

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.core import align as j_align  # noqa: E402
from repro.core.deployment import PolicyRule as JRule  # noqa: E402
from repro.core.deployment import ReliabilityPolicy as JPolicy  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import RunConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy  # noqa: E402
from repro_torch.data.synthetic import MarkovLM  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.training import steps as t_steps  # noqa: E402
from repro_torch.training.loop import _on_device  # noqa: E402

KINDS = {   # kind -> (arch, config overrides)
    "rwkv": ("rwkv6-1.6b", {}),
    "rec": ("recurrentgemma-9b", dict(n_layers=4)),
    "moe": ("qwen3-moe-235b-a22b", {}),
    "local": ("olmo-1b", dict(block_pattern=("local",), local_window=8)),
}
TRAIN_KINDS = tuple(KINDS)
SEQ, BATCH = 16, 2
RTOL, ATOL = 1e-4, 1e-5
B1 = t_adamw.AdamWConfig().b1
GRAD_FLOOR = 1e-6       # 100x AdamW's eps: the first update is lr * sign(g)


def _runs():
    common = dict(steps=4, checkpoint_dir="", learning_rate=1e-3,
                  warmup_steps=0)
    return (JRunConfig(policy=JPolicy(default=JRule(
                protect="one4n", n_group=8, index=2)), remat=False, **common),
            RunConfig(policy=ReliabilityPolicy(default=PolicyRule(
                protect="one4n", n_group=8, index=2)), **common))


# one leaf of each layout the kinds add, its eager alignment held bitwise
# (local's leaves are the attn kind's, held in tests/test_torch_train.py)
ALIGN_PROBES = {"rwkv": ("groups/blk0/tmix/decay_w0",),
                "rec": ("tail/0/rec/w_x",),
                "moe": ("groups/blk0/moe/moe_win",),
                "local": ()}


def _j_state(r, tstate):
    """The port's fresh aligned state as the reference's ``TrainState``."""
    treedef = jax.tree_util.tree_structure(r.jp)

    def nested(flat):
        return jax.tree_util.tree_unflatten(treedef, [
            None if v is None else jax.numpy.asarray(v.numpy())
            for v in flat.values()])
    params = nested(tstate.params)
    return j_steps.TrainState(params=params,
                              opt=j_adamw.init_opt_state(params),
                              exps=nested(tstate.exps),
                              signs=nested(tstate.signs), ef_error=None)


@functools.lru_cache(maxsize=None)
def stepped(kind: str):
    """(reference state, port state, both stepped states and metrics)."""
    arch, ov = KINDS[kind]
    r = reference(arch, **ov)
    jrun, trun = _runs()
    tstate = t_steps.init_train_state(None, r.cfg, trun,
                                      params=convert.flat_from_jax(r.jp))
    jstate = _j_state(r, tstate)
    batch = MarkovLM(r.cfg.vocab_size, SEQ, BATCH, seed=3).batch(0)
    jstep = jax.jit(j_steps.make_train_step(r.jcfg, jrun), compiler_options=O0)
    jnew, jm = jstep(jstate, batch)
    tnew, tm = t_steps.make_train_step(r.cfg, trun)(
        tstate, _on_device(batch, torch.device("cpu")))
    return r, jstate, tstate, jnew, jm, tnew, tm


@functools.lru_cache(maxsize=None)
def reference_alignment(kind: str) -> dict:
    """The reference's eager ``align_matrix`` of the kind's probe leaves:
    {path: (aligned weights, block exponents)}."""
    arch, ov = KINDS[kind]
    flat = tree.flatten(reference(arch, **ov).jp)
    out = {}
    for p in ALIGN_PROBES[kind]:
        leaf = flat[p]
        w, e = j_align.align_matrix(leaf, j_align.AlignmentConfig(
            n_group=8, index=2, group_axis=leaf.ndim - 2))
        out[p] = (np.asarray(w), np.asarray(e))
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _reference_in_threads(_one_torch_thread):
    """Each kind's step and probe alignments, the kinds in parallel
    threads (XLA compiles outside the GIL), as
    ``tests/test_torch_kinds.py`` compiles its reference programs."""
    with ThreadPoolExecutor(len(KINDS)) as ex:
        list(ex.map(stepped, KINDS))
        list(ex.map(reference_alignment, KINDS))


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_aligned_step_matches_reference(kind):
    """Metrics, gradients and stepped parameters of one aligned step."""
    r, jstate, tstate, jnew, jm, tnew, tm = stepped(kind)
    for k in ("loss", "accuracy", "grad_norm", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    assert (float(tm["aux_loss"]) > 0) == (kind == "moe")
    j_m = tree.flatten(_np_tree(jnew.opt["m"]))
    j_params = tree.flatten(_np_tree(jnew.params))
    assert list(j_params) == list(tnew.params)
    for p, w in tnew.params.items():
        g_j = j_m[p] / (1 - B1)
        g_t = tnew.opt["m"][p].numpy() / (1 - B1)
        scale = float(np.abs(g_j).max()) or 1.0
        np.testing.assert_allclose(g_t, g_j, rtol=RTOL, atol=ATOL * scale,
                                   err_msg=p)
        ulps = _fp16_ulps(j_params[p], w.numpy())[np.abs(g_j) > GRAD_FLOOR]
        assert ulps.size == 0 or ulps.max() <= 1, (p, int(ulps.max()))


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_aligned_leaves_follow_the_reference_rules(kind):
    """The leaves the reference aligns and freezes (``is_alignable``: its
    >= 2-D float leaves, the stacked 1-D group leaves and the tail's
    matrices among them) are the port's, aligned bitwise as the reference's
    eager ``align_matrix`` aligns them; each stepped leaf keeps its frozen
    signs, and zero-gradient AdamW decays the same leaves on both sides."""
    r, jstate, tstate, jnew, jm, tnew, tm = stepped(kind)
    j_leaves = {p: leaf for p, leaf in tree.flatten(r.jp).items()
                if j_align.is_alignable(p, leaf)}
    aligned = [p for p, e in tstate.exps.items() if e is not None]
    assert aligned == list(j_leaves)
    for p, (w, e) in reference_alignment(kind).items():
        assert np.array_equal(w.view(np.uint32),
                              tstate.params[p].numpy().view(np.uint32)), p
        assert np.array_equal(e, tstate.exps[p].numpy()), p
    layout = {p.split("/")[0] for p in aligned}
    assert "groups" in layout
    if kind == "rec":
        assert "tail" in layout
        assert any(p.endswith("rec/rg_wa") for p in aligned)
    for p in aligned:
        assert torch.equal(torch.sign(tnew.params[p]).to(torch.int8),
                           tstate.signs[p]), p
    zero = {p: torch.zeros_like(w) for p, w in tstate.params.items()}
    cfg_t = t_adamw.AdamWConfig(weight_decay=0.1)
    t_dec, _ = t_adamw.adamw_update(zero, tstate.opt, tstate.params,
                                    torch.tensor(1e-3), cfg_t)
    decayed = _j_decayed_ndims()
    for p, w in t_dec.items():
        w0 = tstate.params[p]
        assert (not torch.equal(w, w0)) == (w0.ndim in decayed), p
        if w0.ndim in decayed:
            torch.testing.assert_close(w, w0 * (1 - 1e-3 * 0.1), rtol=1e-6,
                                       atol=0)


@functools.lru_cache(maxsize=None)
def _j_decayed_ndims() -> frozenset:
    """The ranks whose leaves the reference's AdamW decays, read off one
    zero-gradient update of a tree holding a leaf of each rank 1 to 4."""
    params = {f"r{n}": np.ones((2,) * n, np.float32) for n in range(1, 5)}
    opt = j_adamw.init_opt_state(params)
    out, _ = jax.jit(lambda g, o, w: j_adamw.adamw_update(
        g, o, w, np.float32(1e-3), j_adamw.AdamWConfig(weight_decay=0.1)),
        compiler_options=O0)(jax.tree_util.tree_map(np.zeros_like, params),
                             opt, params)
    return frozenset(int(k[1:]) for k, v in out.items()
                     if not np.array_equal(np.asarray(v), params[k]))


def test_moe_aux_loss_reaches_the_gradient():
    """The router's gradient carries the aux loss: the same step with
    ``router_aux_coef`` 0 moves the router's gradient, on both sides
    alike in sign of the change."""
    import dataclasses
    r, jstate, tstate, jnew, jm, tnew, tm = stepped("moe")
    _, trun = _runs()
    cfg0 = dataclasses.replace(r.cfg, router_aux_coef=0.0)
    batch = MarkovLM(r.cfg.vocab_size, SEQ, BATCH, seed=3).batch(0)
    t0, m0 = t_steps.make_train_step(cfg0, trun)(
        tstate, _on_device(batch, torch.device("cpu")))
    assert float(m0["aux_loss"]) == 0.0
    router = [p for p in tnew.params if p.endswith("moe/router")]
    assert router
    for p in router:
        assert not torch.equal(t0.opt["m"][p], tnew.opt["m"][p]), p
