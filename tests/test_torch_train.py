"""The port's training core against the JAX reference, on reduced olmo-1b.

Both packages start from one state: the reference's ``init_train_state``,
carried across by ``convert.train_state_from_jax``. Alignment and the
frozen-(exponent, sign) projection are bitwise; AdamW, clipping and the
learning-rate schedule agree within 1e-6 relative (float32 in both, other
kernels); losses, accuracies and gradient norms within 1e-4 relative over
three steps; parameters within one fp16 ulp, because the projection rounds
AdamW's float32 result to the fp16 grid and a last-ulp difference between
the two frameworks can round to the neighbouring fp16 value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import align as j_align  # noqa: E402
from repro.core.deployment import PolicyRule as JRule  # noqa: E402
from repro.core.deployment import ReliabilityPolicy as JPolicy  # noqa: E402
from repro.data.synthetic import MarkovLM as JMarkovLM  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import losses as j_losses  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.training import loop as j_loop  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core import align as t_align  # noqa: E402
from repro_torch.core import bitops as t_bitops  # noqa: E402
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy  # noqa: E402
from repro_torch.data.synthetic import MarkovLM  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import losses as t_losses  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.training import loop as t_loop  # noqa: E402

SEQ, BATCH = 32, 4
METRIC_RTOL = 1e-4   # fp32 forward/backward, different summation orders


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def params():
    cfg = j_get_config("olmo-1b").reduced()
    return cfg, _np_tree(j_lm.init_lm(jax.random.PRNGKey(0), cfg))


def _policies():
    multi = ((JRule(pattern="embed", n_group=4, index=1),
              JRule(pattern="wq", deploy=False)),
             (PolicyRule(pattern="embed", n_group=4, index=1),
              PolicyRule(pattern="wq", deploy=False)))
    return JPolicy(rules=multi[0]), ReliabilityPolicy(rules=multi[1])


def _perturbed(tree, rng):
    """Aligned weights after a pretend optimizer step: noise of a few
    percent and some sign flips, so the projection clamps and re-signs."""
    out = {}
    for p, w in tree.items():
        w = np.asarray(w, np.float32)
        noise = rng.standard_normal(w.shape).astype(np.float32)
        flip = np.where(rng.random(w.shape) < 0.05, -1.0, 1.0)
        out[p] = (w * (1 + 0.3 * noise) * flip).astype(np.float32)
    return out


def test_align_and_project_pytree_bitwise(params):
    cfg, jp = params
    flat = convert.flat_from_jax(jp)
    acfg = j_align.AlignmentConfig(n_group=8, index=2)
    # eagerly, as the reference's init_train_state aligns: under jax.jit,
    # XLA contracts the Eq. 4 rescale t * (UL - LL) + LL into an FMA and
    # rounds one weight of this tree to the neighbouring fp16 value
    j_al, j_e = j_align.align_pytree(jp, acfg)
    t_al, t_e = t_align.align_pytree(flat, t_align.AlignmentConfig(8, 2))
    j_al, j_e = convert.tree.flatten(_np_tree(j_al)), \
        convert.tree.flatten(_np_tree(j_e), keep_none=True)
    assert list(t_al) == list(j_al) == list(flat)
    for p in flat:
        assert np.array_equal(_bits(j_al[p]), _bits(t_al[p])), p
        assert np.array_equal(np.asarray(j_e[p]), t_e[p].numpy()), p

    signs = {p: np.sign(j_al[p]).astype(np.int8) for p in flat}
    moved = _perturbed(j_al, np.random.default_rng(0))
    j_proj = jax.jit(lambda w, e, s: j_align.project_pytree(w, e, s, acfg))(
        moved, {p: j_e[p] for p in flat}, signs)
    t_proj = t_align.project_pytree(
        {p: torch.from_numpy(w) for p, w in moved.items()}, t_e,
        {p: torch.from_numpy(s) for p, s in signs.items()},
        t_align.AlignmentConfig(8, 2))
    j_proj = convert.tree.flatten(_np_tree(j_proj))
    for p in flat:
        assert np.array_equal(_bits(j_proj[p]), _bits(t_proj[p])), p
        # the invariants: block exponents are the frozen ones, signs too
        e = t_align.block_exponent(t_proj[p], t_align.AlignmentConfig(
            8, 2, group_axis=t_proj[p].ndim - 2))
        assert torch.equal(e, t_e[p]), p
        assert np.array_equal(np.sign(t_proj[p].numpy()), signs[p]), p


def test_policy_align_and_project_bitwise(params):
    cfg, jp = params
    jpol, tpol = _policies()
    flat = convert.flat_from_jax(jp)
    j_al, j_e = j_align.align_pytree_policy(jp, jpol)
    t_al, t_e = t_align.align_pytree_policy(flat, tpol)
    j_al = convert.tree.flatten(_np_tree(j_al))
    j_e = convert.tree.flatten(_np_tree(j_e), keep_none=True)
    assert j_e["groups/blk0/attn/wq"] is None and \
        t_e["groups/blk0/attn/wq"] is None
    assert t_e["embed"].shape == (cfg.vocab_size // 4, cfg.d_model)
    for p in flat:
        assert np.array_equal(_bits(j_al[p]), _bits(t_al[p])), p
        assert (j_e[p] is None) == (t_e[p] is None)
        if t_e[p] is not None:
            assert np.array_equal(np.asarray(j_e[p]), t_e[p].numpy()), p
    signs = {p: None if j_e[p] is None else np.sign(j_al[p]).astype(np.int8)
             for p in flat}
    moved = _perturbed(j_al, np.random.default_rng(1))
    j_proj = jax.jit(lambda w, e, s: j_align.project_pytree_policy(
        w, e, s, jpol))(moved, j_e, signs)
    t_proj = t_align.project_pytree_policy(
        {p: torch.from_numpy(w) for p, w in moved.items()}, t_e,
        {p: None if s is None else torch.from_numpy(s)
         for p, s in signs.items()}, tpol)
    j_proj = convert.tree.flatten(_np_tree(j_proj))
    for p in flat:
        assert np.array_equal(_bits(j_proj[p]), _bits(t_proj[p])), p
    assert np.array_equal(_bits(t_proj["groups/blk0/attn/wq"]),
                          _bits(moved["groups/blk0/attn/wq"]))


def _drawn_tree(rng):
    shapes = {"a": (4, 8), "b": (16,), "c": (3, 5, 7)}
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}


def _assert_tree_close(j_tree, t_tree, rtol=1e-6, atol=0.0):
    for k, t in t_tree.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j_tree[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])   # clipped, not clipped
def test_adamw_clip_and_schedule(max_norm):
    rng = np.random.default_rng(7)
    p, g = _drawn_tree(rng), _drawn_tree(rng)
    m = _drawn_tree(rng)
    v = {k: np.abs(a) * 0.01 for k, a in _drawn_tree(rng).items()}
    tt = lambda d: {k: torch.from_numpy(a.copy()) for k, a in d.items()}  # noqa: E731
    cfg_j = j_adamw.AdamWConfig(weight_decay=0.1, grad_clip=max_norm)
    cfg_t = t_adamw.AdamWConfig(weight_decay=0.1, grad_clip=max_norm)

    jg, jn = j_adamw.clip_by_global_norm(g, max_norm)
    tg, tn = t_adamw.clip_by_global_norm(tt(g), max_norm)   # scales in place
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(t_adamw.global_norm(tt(g))),
                               float(j_adamw.global_norm(g)), rtol=1e-6)
    _assert_tree_close(jg, tg)

    j_lr = j_adamw.make_lr_schedule(3e-4, 5, 20)
    t_lr = t_adamw.make_lr_schedule(3e-4, 5, 20)
    for s in range(0, 26):
        np.testing.assert_allclose(float(t_lr(torch.tensor(s, dtype=torch.int32))),
                                   float(j_lr(jnp.asarray(s, jnp.int32))),
                                   rtol=1e-6)
    lr = t_lr(torch.tensor(7, dtype=torch.int32))
    step = 4
    j_new, j_opt = j_adamw.adamw_update(
        jg, {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)}, p,
        jnp.asarray(lr.numpy()), cfg_j)
    t_new, t_opt = t_adamw.adamw_update(
        tg, {"m": tt(m), "v": tt(v),
             "step": torch.tensor(step, dtype=torch.int32)}, tt(p), lr, cfg_t)
    _assert_tree_close(j_new, t_new)
    _assert_tree_close(j_opt["m"], t_opt["m"])
    _assert_tree_close(j_opt["v"], t_opt["v"])
    assert int(t_opt["step"]) == int(j_opt["step"]) == step + 1
    # weight decay reaches only the leaves of two or more dimensions
    z = {k: np.zeros_like(a) for k, a in p.items()}
    zero_opt = {"m": tt(z), "v": tt(z), "step": torch.tensor(0, dtype=torch.int32)}
    t_dec, _ = t_adamw.adamw_update(tt(z), zero_opt, tt(p), lr, cfg_t)
    assert torch.equal(t_dec["b"], torch.from_numpy(p["b"]))
    assert not torch.equal(t_dec["a"], torch.from_numpy(p["a"]))


def test_exponent_compression_penalty_and_gradient(params):
    cfg, jp = params
    jpol, tpol = _policies()
    flat = {k: v.clone().requires_grad_(True)
            for k, v in convert.flat_from_jax(jp).items()}
    j_val, j_grad = jax.value_and_grad(
        lambda q: j_losses.exponent_compression_penalty(q, jpol, 0.5))(jp)
    t_val = t_losses.exponent_compression_penalty(flat, tpol, 0.5)
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    t_grad = torch.autograd.grad(t_val, list(flat.values()), allow_unused=True)
    j_grad = convert.tree.flatten(_np_tree(j_grad))
    for (p, tg) in zip(flat, t_grad):
        if p == "groups/blk0/attn/wq":      # deploy=False: no penalty term
            assert tg is None and not j_grad[p].any()
            continue
        np.testing.assert_allclose(tg.numpy(), j_grad[p], rtol=1e-5,
                                   atol=1e-7, err_msg=p)


def _runs(steps, **kw):
    jrule = JRule(protect="one4n", n_group=8, index=2)
    trule = PolicyRule(protect="one4n", n_group=8, index=2)
    common = dict(steps=steps, checkpoint_dir="", learning_rate=1e-3, **kw)
    return (JRunConfig(policy=JPolicy(default=jrule), remat=False, **common),
            RunConfig(policy=ReliabilityPolicy(default=trule), **common))


def _train_both(params, steps, **kw):
    cfg_j, _ = params
    cfg_t = get_config("olmo-1b").reduced()
    jrun, trun = _runs(steps, **kw)
    jstate = j_steps.init_train_state(jax.random.PRNGKey(0), cfg_j, jrun)
    tstate = convert.train_state_from_jax(jstate)
    jres = j_loop.run_training(cfg_j, jrun, iter(JMarkovLM(
        cfg_j.vocab_size, SEQ, BATCH, seed=3)), state=jstate)
    tres = t_loop.run_training(cfg_t, trun, iter(MarkovLM(
        cfg_t.vocab_size, SEQ, BATCH, seed=3)), state=tstate)
    return jres, tres


def _fp16_ulps(a, b) -> np.ndarray:
    """|a - b| in units of the fp16 grid, through the fp16 bit patterns
    (both sides lie on the grid, with the same sign)."""
    ha = np.asarray(a, np.float32).astype(np.float16).view(np.int16)
    hb = np.asarray(b, np.float32).astype(np.float16).view(np.int16)
    return np.abs(ha.astype(np.int32) - hb.astype(np.int32))


def _check_invariants(params_, exps, signs):
    for p, w in params_.items():
        w = torch.from_numpy(np.array(w, np.float32))
        e = exps[p]
        acfg = t_align.AlignmentConfig(8, 2, group_axis=w.ndim - 2)
        assert torch.equal(t_align.block_exponent(w, acfg),
                           torch.from_numpy(np.array(e)).to(torch.int64)), p
        # every weight of a block carries the block's exponent, bitwise
        _, ew, _ = t_bitops.split_fields(w)
        blocks, _ = t_align._block_view(ew, 8, w.ndim - 2)
        assert bool((blocks == blocks[:, :1]).all()), p
        assert np.array_equal(np.sign(w.numpy()).astype(np.int8),
                              np.asarray(signs[p])), p


def test_run_training_matches_reference(params):
    jres, tres = _train_both(params, steps=3, warmup_steps=1)
    assert len(jres.history) == len(tres.history) == 3
    for jh, th in zip(jres.history, tres.history):
        for k in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(th[k], jh[k], rtol=METRIC_RTOL,
                                       err_msg=f"step {th['step']} {k}")
        assert np.float32(th["lr"]) == np.float32(jh["lr"])
        assert th["aux_loss"] == jh["aux_loss"] == 0.0
    assert tres.history[-1]["lr"] > 0      # the weights did move
    j_params = convert.tree.flatten(_np_tree(jres.state.params))
    for p, w in tres.state.params.items():
        ulps = _fp16_ulps(j_params[p], w.numpy())
        assert ulps.max() <= 1, (p, int(ulps.max()))
    j_exps = convert.tree.flatten(_np_tree(jres.state.exps), keep_none=True)
    j_signs = convert.tree.flatten(_np_tree(jres.state.signs), keep_none=True)
    _check_invariants(j_params, j_exps, j_signs)
    _check_invariants({p: w.numpy() for p, w in tres.state.params.items()},
                      tres.state.exps, tres.state.signs)
    for p in j_exps:   # the frozen leaves stay the ones both started from
        assert np.array_equal(np.asarray(j_exps[p]), tres.state.exps[p].numpy())
        assert np.array_equal(np.asarray(j_signs[p]), tres.state.signs[p].numpy())
    # from_policy keeps mode 'cim' at ber 0: both runs carry a deployment
    assert tres.run.rel.mode == jres.run.rel.mode == "cim"
    t_stats, j_stats = tres.ecc_stats, jres.ecc_stats
    for k in ("stored_bits", "raw_bits", "corrected", "uncorrectable"):
        assert t_stats[k] == j_stats[k], k
    assert tres.final_loss == tres.history[-1]["loss"]
    state, history, info = tres
    assert info["resumed_from"] == 0 and history is tres.history


def test_regularized_step_without_freezing_matches_reference(params):
    jres, tres = _train_both(params, steps=1, warmup_steps=0,
                             exp_reg_coef=0.5, freeze_exponents=False)
    jh, th = jres.history[0], tres.history[0]
    assert th["exp_penalty"] > 0
    for k in ("loss", "accuracy", "grad_norm", "exp_penalty"):
        np.testing.assert_allclose(th[k], jh[k], rtol=METRIC_RTOL, err_msg=k)
    assert np.float32(th["lr"]) == np.float32(jh["lr"]) > 0
    assert all(e is None for e in tres.state.exps.values())
    # No projection: fp32 weights after one AdamW step of lr 1e-3. Adam
    # divides each gradient by its own magnitude, so a gradient that is not
    # much larger than its fp32 summation error (here ~1e-8 against a
    # largest gradient of ~1e-2, up to 35% apart between the frameworks)
    # moves its weight by a different share of lr. So: every weight within
    # one step (lr), and all but 0.1% of them within 1e-6.
    lr = 1e-3
    j_params = convert.tree.flatten(_np_tree(jres.state.params))
    far = total = 0
    for p, w in tres.state.params.items():
        d = np.abs(w.numpy() - j_params[p])
        assert d.max() <= lr, (p, float(d.max()))
        far += int((d > 1e-6).sum())
        total += d.size
    assert far <= 1e-3 * total, (far, total)


def test_markov_lm_iterates_as_reference():
    jit_, tit = iter(JMarkovLM(64, 8, 2, seed=5)), iter(MarkovLM(64, 8, 2, seed=5))
    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        for k in ("tokens", "labels"):
            assert np.array_equal(np.asarray(jb[k]), tb[k])


def test_launcher_trains_on_cpu(capsys):
    res = t_train.main(["--reduced", "--steps", "3", "--device", "cpu",
                        "--rel-mode", "align", "--seq", "16", "--batch", "2"])
    assert len(res.history) == 3
    assert all(np.isfinite(h["loss"]) for h in res.history)
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     2 loss" in out
    assert "done: 3 steps" in out
    _check_invariants({p: w.numpy() for p, w in res.state.params.items()},
                      res.state.exps, res.state.signs)


def test_launcher_and_loop_raise_for_what_waits():
    """What still waits raises: the scrubber on a mesh (item 14b-3); a mesh
    that is not a ("data", "model") mesh is refused. Dynamic injection,
    which waited for the Fig. 7 schedule, trains through it (on one
    intra-op thread: the schedule's many small ops stall a thread pool
    that parallel test workers share)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = t_train.main(["--reduced", "--steps", "2", "--device", "cpu",
                            "--rel-mode", "cim", "--ber", "1e-3", "--inject",
                            "dynamic", "--seq", "16", "--batch", "2"])
    finally:
        torch.set_num_threads(threads)
    assert all(np.isfinite(h["loss"]) for h in res.history)
    cfg = get_config("olmo-1b").reduced()
    data = MarkovLM(cfg.vocab_size, 8, 2)
    from repro_torch.launch import serve as t_serve
    with pytest.raises(NotImplementedError, match="item 14b-3"):
        t_serve.main(["--reduced", "--device", "cpu", "--mesh", "1x1",
                      "--engine", "--scrub"])
    with pytest.raises(ValueError, match="'data', 'model'"):
        t_loop.run_training(cfg, RunConfig(steps=1, checkpoint_dir=""),
                            iter(data), device="cpu", mesh=object())


def test_reliability_config_matches_reference():
    from repro.core.api import ReliabilityConfig as JRel
    from repro_torch.core.api import ReliabilityConfig as TRel
    for kw in (dict(), dict(mode="align", n_group=4, index=3),
               dict(mode="cim", protect="per_weight", ber=1e-3),
               dict(mode="cim", protect="none", ber=2e-4, field="sign"),
               dict(mode="cim", ber=1e-4, field="exponent", inject="static")):
        j, t = JRel(**kw), TRel(**kw)
        assert t.enabled() == j.enabled()
        assert (t.align_cfg.n_group, t.align_cfg.index) == \
            (j.align_cfg.n_group, j.align_cfg.index)
        assert (t.cim_cfg.n_group, t.cim_cfg.protect) == \
            (j.cim_cfg.n_group, j.cim_cfg.protect)
        jd, td = j.policy.default, t.policy.default
        for f in ("field", "protect", "n_group", "index", "serve_path"):
            assert getattr(td, f) == getattr(jd, f), f
    for bad in (dict(mode="on"), dict(protect="one4N"), dict(inject="dynamyc"),
                dict(field="bits"), dict(ber=-1.0)):
        with pytest.raises(ValueError):
            JRel(**bad)
        with pytest.raises(ValueError):
            TRel(**bad)
    jpol, tpol = _policies()
    j, t = JRel.from_policy(jpol, ber=1e-3), TRel.from_policy(tpol, ber=1e-3)
    assert t.mode == j.mode == "cim"
    assert (t.policy_override is tpol) and (j.policy_override is jpol)
    t0 = TRel.from_policy(ReliabilityPolicy(), ber=0.0)
    assert t0.policy_override is None and t0.mode == "cim"
    with pytest.raises(TypeError):
        TRel.from_policy("one4n")
    with pytest.raises(TypeError, match="ReliabilityPolicy"):
        RunConfig(policy=TRel())


def test_param_count_matches_reference(params):
    cfg, jp = params
    from repro_torch.models import lm as t_lm
    assert t_lm.param_count(convert.flat_from_jax(jp)) == j_lm.param_count(jp)
