"""The dense architecture variants of the port against the JAX reference, on
the reduced configs of the seven dense archs (``tests/test_arch_smoke.py``'s
matrix, less the block kinds that wait).

Both packages start from the reference's ``init_lm`` weights, with every norm
scale and bias redrawn nonzero from a numpy seed: the reference initialises
them to zero, which would hide a missing ``1 +`` or a swapped scale and bias.
Forward logits (text, and the ``vision_stub`` / ``audio_stub`` batches) agree
within allclose(rtol=1e-4, atol=1e-5), as the serving tests hold them;
prefill followed by decode agrees with the forward; one aligned train step
agrees as ``tests/test_torch_train.py`` holds three (loss within 1e-4
relative, parameters within one fp16 ulp), the stacked norms aligned and
decayed as the reference's are.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_train import _fp16_ulps, _np_tree  # noqa: E402

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.deployment import PolicyRule as JRule  # noqa: E402
from repro.core.deployment import ReliabilityPolicy as JPolicy  # noqa: E402
from repro.data.synthetic import batches_for as j_batches_for  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import mlp as j_mlp  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy  # noqa: E402
from repro_torch.data.synthetic import IGNORE, batches_for  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.mlp import MLP  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.training import steps as t_steps  # noqa: E402
from repro_torch.training.loop import _on_device  # noqa: E402

ARCHS = ("olmo-1b", "granite-3-8b", "codeqwen1.5-7b", "command-r-35b",
         "internvl2-76b", "musicgen-large", "tinyvit-paper")
NEW = ARCHS[1:]
TEXT = tuple(a for a in ARCHS if a not in ("internvl2-76b", "musicgen-large"))
SEQ, BATCH = 16, 2
RTOL, ATOL = 1e-4, 1e-5
NORM_PATHS = ("groups/blk0/norm1", "groups/blk0/norm2", "final_norm")


def drawn_norms(np_params, seed: int):
    """The reference's params with every norm scale (0.5 N(0, 1)) and bias
    (0.1 N(0, 1)) redrawn nonzero, stacked shapes kept."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(lambda a: a, np_params)      # a new tree
    for node in [out["groups"]["blk0"]["norm1"], out["groups"]["blk0"]["norm2"],
                 out["final_norm"]]:
        for name, a in node.items():
            s = 0.5 if name == "scale" else 0.1
            node[name] = (s * rng.standard_normal(a.shape)).astype(a.dtype)
    return out


@dataclasses.dataclass
class Ref:
    jcfg: object
    jp: dict            # numpy leaves, norms drawn
    cfg: object
    model: object       # the port's LM holding the same weights
    flat: dict          # the same weights in the reference layout


@functools.lru_cache(maxsize=None)
def reference(arch: str, seed: int = 0, **overrides) -> Ref:
    """The reference's reduced ``arch`` (``overrides`` replaced in both
    configs) and the port's model on the same weights."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jp = drawn_norms(_np_tree(jax.jit(j_lm.init_lm, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)), seed + 100)
    model = t_lm.LM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jp, cfg))
    return Ref(jcfg, jp, cfg, model, convert.flat_from_jax(jp))


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).to(torch.float32 if v.dtype.kind == "f"
                                      else torch.int64)
            for k, v in batch.items() if k != "labels"}


@functools.lru_cache(maxsize=None)
def reference_logits(arch: str, seq: int):
    """(numpy batch, the reference's forward logits over it)."""
    r = reference(arch)
    batch = batches_for(r.cfg, BATCH, seq, seed=1)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    fwd = jax.jit(lambda p, b: j_lm.forward(p, r.jcfg, b, remat=False)[0])
    return batch, np.asarray(fwd(r.jp, inputs))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    """Every field the port carries, full and reduced, and the tag with its
    source, letter for letter."""
    for t, j in ((get_config(arch), j_get_config(arch)),
                 (get_config(arch).reduced(), j_get_config(arch).reduced())):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
        assert t.head_dim_ == j.head_dim_
    assert get_config("granite-3-8b").tag == \
        "[hf:ibm-granite/granite-3.0-2b-base; hf]"


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_and_flatten_order(arch):
    """``flat_from_jax`` keeps the reference's flatten order (which salts
    each leaf's fault stream); ``lm_state_from_flat`` -> ``LM`` ->
    ``flat_from_lm`` is the identity, bitwise; the stacked norms stay
    [L, D] and the final norm [D]."""
    r = reference(arch)
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(r.jp)[0]]
    assert list(r.flat) == paths
    back = convert.flat_from_lm(r.model)
    assert list(back) == paths
    for p in paths:
        assert torch.equal(back[p], r.flat[p]), p
    twin = t_lm.LM(r.cfg, device="cpu")
    twin.load_state_dict(convert.lm_state_from_flat(r.flat, r.cfg))
    for p, w in convert.flat_from_lm(twin).items():
        assert torch.equal(w, r.flat[p]), p
    norms = [p for p in paths if "norm" in p]
    for p in norms:
        want = (r.cfg.d_model,) if p.startswith("final_norm") \
            else (r.cfg.n_layers, r.cfg.d_model)
        assert tuple(r.flat[p].shape) == want, p
    assert len(norms) == 3 * len(convert.block_leaves(r.cfg)["norm1"])
    assert t_lm.param_count(r.flat) == j_lm.param_count(r.jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Logits over a ``batches_for`` batch (a vision prefix before the
    tokens, audio frame embeddings in place of them): the reference-layout
    tree through :func:`lm.forward` and the module's own weights give the
    reference's logits."""
    r = reference(arch)
    batch, want = reference_logits(arch, SEQ)
    tb = _torch_batch(batch)
    got = t_lm.forward(t_lm.shell(r.cfg), r.flat, tb)
    assert tuple(got.shape) == (BATCH, SEQ, r.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        assert torch.equal(r.model(tb), got)


@pytest.mark.parametrize("arch", TEXT)
def test_prefill_then_decode_matches_forward(arch):
    """Prefill over S tokens, then one decode step, give the reference's
    forward logits at positions S - 1 and S."""
    r = reference(arch)
    batch, want = reference_logits(arch, SEQ + 1)
    toks = torch.from_numpy(batch["tokens"]).to(torch.int64)
    with torch.no_grad():
        pre, caches = r.model.prefill(toks[:, :SEQ], max_len=SEQ + 1)
        dec, caches = r.model.decode(caches, toks[:, SEQ:])
    np.testing.assert_allclose(pre.numpy(), want[:, SEQ - 1], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dec.numpy(), want[:, SEQ], rtol=RTOL,
                               atol=ATOL)
    assert caches["layers"][0]["k"].shape == (BATCH, SEQ + 1,
                                              r.cfg.n_kv_heads, 32)


def _runs():
    common = dict(steps=4, checkpoint_dir="", learning_rate=1e-3,
                  warmup_steps=0)
    return (JRunConfig(policy=JPolicy(default=JRule(
                protect="one4n", n_group=8, index=2)), remat=False, **common),
            RunConfig(policy=ReliabilityPolicy(default=PolicyRule(
                protect="one4n", n_group=8, index=2)), **common))


@pytest.mark.parametrize("arch", NEW)
def test_aligned_train_step_matches_reference(arch):
    """One aligned step from one state (the reference's, aligned eagerly):
    loss, accuracy and gradient norm within 1e-4 relative, every parameter
    within one fp16 ulp. The stacked norms [L, D] are aligned and frozen
    (the final norm [D] is not), and AdamW decays them, as the reference's
    ``p.ndim >= 2`` rules pick them."""
    r = reference(arch)
    jrun, trun = _runs()
    jstate = j_steps.init_train_state(None, r.jcfg, jrun, params=r.jp)
    tstate = convert.train_state_from_jax(jstate)
    j_exps = tree.flatten(_np_tree(jstate.exps), keep_none=True)
    for p in NORM_PATHS:
        for name in convert.block_leaves(r.cfg)["norm1"]:
            aligned = not p.startswith("final_norm")
            assert (j_exps[f"{p}/{name}"] is not None) == aligned
            assert (tstate.exps[f"{p}/{name}"] is not None) == aligned
    batch = batches_for(r.cfg, BATCH, SEQ, seed=2)
    jnew, jm = jax.jit(j_steps.make_train_step(r.jcfg, jrun))(jstate, batch)
    tnew, tm = t_steps.make_train_step(r.cfg, trun)(
        tstate, _on_device(batch, torch.device("cpu")))
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(tm["lr"]) > 0
    j_params = tree.flatten(_np_tree(jnew.params))
    for p, w in tnew.params.items():
        ulps = _fp16_ulps(j_params[p], w.numpy())
        assert ulps.max() <= 1, (p, int(ulps.max()))
    # decay alone (zero gradients): the stacked norms shrink by lr * wd,
    # the final norm stays, on both sides alike
    zero = {p: torch.zeros_like(w) for p, w in tstate.params.items()}
    cfg_t = t_adamw.AdamWConfig(weight_decay=0.1)
    t_dec, _ = t_adamw.adamw_update(zero, tstate.opt, tstate.params,
                                    torch.tensor(1e-3), cfg_t)
    j_dec, _ = j_adamw.adamw_update(
        jax.tree_util.tree_map(np.zeros_like, _np_tree(jstate.params)),
        jstate.opt, jstate.params, np.float32(1e-3),
        j_adamw.AdamWConfig(weight_decay=0.1))
    j_dec = tree.flatten(_np_tree(j_dec))
    for p in NORM_PATHS:
        path = f"{p}/scale"
        moved = not torch.equal(t_dec[path], tstate.params[path])
        assert moved == (not p.startswith("final_norm")), path
        np.testing.assert_allclose(t_dec[path].numpy(), j_dec[path],
                                   rtol=1e-6, err_msg=path)


def test_gelu_mlp_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh form, torch's to the erf form:
    the port's GeLU MLP equals the reference's to float32 rounding, and the
    erf form would not."""
    jcfg = j_get_config("musicgen-large").reduced()
    cfg = get_config("musicgen-large").reduced()
    jp = _np_tree(j_mlp.init_mlp(jax.random.PRNGKey(3), jcfg))
    mlp = MLP(cfg, device="cpu")
    assert set(jp) == {n for n, _ in mlp.named_parameters()} == \
        {"w_in", "w_out"}
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in jp.items()})
    x = (2 * np.random.default_rng(4).standard_normal((4, 8, 128))).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: j_mlp.apply_mlp(p, jcfg, x))(jp, x))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
        erf = (torch.nn.functional.gelu(torch.from_numpy(x) @ mlp.w_in)
               @ mlp.w_out).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not np.allclose(erf, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ("granite-3-8b", "internvl2-76b",
                                  "musicgen-large"))
def test_batches_for_has_the_reference_structure(arch):
    """Keys, shapes and dtypes of the reference's ``batches_for`` (its
    values come from ``jax.random``, the port's from a torch.Generator);
    a vision batch's labels IGNORE its patch prefix."""
    cfg = get_config(arch).reduced()
    want = j_batches_for(j_get_config(arch).reduced(), SHAPES["train_4k"],
                         batch_override=BATCH, seq_override=SEQ)
    got = batches_for(cfg, BATCH, SEQ, seed=0)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
    p = cfg.n_prefix_embeds
    assert (got["labels"][:, :p] == IGNORE).all()
    assert (got["labels"][:, p:] >= 0).all()
    again = batches_for(cfg, BATCH, SEQ, seed=0)
    assert all(np.array_equal(again[k], v) for k, v in got.items())


def test_init_norm_and_block_kinds_that_wait():
    """Fresh norms are zeros, as the reference's ``init_norm``. Every block
    kind builds, its slot-state spec equal to the reference's field by
    field; every kind now trains (the step, the state and the launcher
    take it; ``tests/test_torch_train_kinds.py`` holds the steps to the
    reference), and an unknown MLP type raises."""
    from repro.models import lm as jl
    from repro.models.common import init_norm as j_init_norm
    from repro_torch.models.common import init_norm
    for nt in ("rmsnorm", "layernorm", "nonparametric_ln"):
        j, t = j_init_norm(None, nt, 8), init_norm(nt, 8)
        assert set(j) == set(t)
        assert all(not v.any() and v.shape == (8,) for v in t.values())
    cfg = get_config("granite-3-8b").reduced()
    assert set(t_lm.SLOT_STATE_SPECS) == set(jl.SLOT_STATE_SPECS)
    for kind, j in jl.SLOT_STATE_SPECS.items():
        assert dataclasses.asdict(t_lm.slot_state_spec(kind)) == \
            dataclasses.asdict(j), kind
    for pattern in (("rwkv",), ("rec", "rec", "local"), ("moe",)):
        c = dataclasses.replace(cfg, block_pattern=pattern, n_experts=4,
                                top_k=2, d_ff_expert=64, local_window=8)
        model = t_lm.LM(c, device="cpu")
        assert [b.kind for b in model.blocks] == \
            [pattern[i % len(pattern)] for i in range(c.n_layers)]
        state = t_steps.init_train_state(
            torch.Generator().manual_seed(0), c, RunConfig(), device="cpu")
        batch = _on_device(batches_for(c, BATCH, SEQ, seed=2),
                           torch.device("cpu"))
        _, m = t_steps.make_train_step(c, RunConfig())(state, batch)
        assert np.isfinite(float(m["loss"])), pattern
        assert (float(m["aux_loss"]) > 0) == (pattern == ("moe",))
    res = t_train.main(["--arch", "rwkv6-1.6b", "--reduced", "--steps", "1",
                        "--device", "cpu", "--seq", "16", "--batch", "2"])
    assert np.isfinite(res.history[0]["loss"])
    with pytest.raises(ValueError, match="mlp_type"):
        MLP(dataclasses.replace(cfg, mlp_type="relu"), device="cpu")


@pytest.mark.parametrize("arch", ("musicgen-large", "internvl2-76b"))
def test_launcher_trains_a_stub_modality(arch, capsys):
    res = t_train.main(["--arch", arch, "--reduced", "--steps", "2",
                        "--device", "cpu", "--seq", "16", "--batch", "2"])
    assert len(res.history) == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert "done: 2 steps" in capsys.readouterr().out
