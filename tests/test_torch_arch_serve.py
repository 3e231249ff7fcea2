"""Serving the dense variants: the port's deployment and lock-step launcher
against the JAX reference's, on reduced granite-3-8b (rmsnorm, GQA) and
tinyvit-paper (layernorm, GeLU), their norms drawn nonzero
(``test_torch_arch.drawn_norms``).

The stacked norms [L, D] are 2-D in the reference's layout, so a
``pattern="*"`` deployment packs them beside the embed and unembed: the
deployed leaf set and every plane must be the reference's, bitwise, and the
hbm path serves the norms it decoded. Lock-step serving gives the
reference's greedy tokens and ECC counts, and its prefill logits within
allclose(rtol=1e-4, atol=1e-5): granite in the fused static, fused dynamic
(one4n and none) and hbm arms, tinyvit in the fused dynamic and hbm arms. An odd vocabulary (259, padded to 272 columns) runs through
pack, ``read_rows``, the unembed and serving: the reduced configs' 256 hides
the padding that granite's 49155 needs at full width.
"""
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_arch import reference  # noqa: E402
from test_torch_deployment import _same_planes  # noqa: E402
from test_torch_serve import _reference_seeds  # noqa: E402

from repro.core import cim as j_cim  # noqa: E402
from repro.core import deployment as j_dep  # noqa: E402
from repro.data.synthetic import MarkovLM as JMarkovLM  # noqa: E402
from repro.kernels.cim_read import ops as j_cr_ops  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.launch import engine as t_engine  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

BATCH, PLEN, GEN, SEED, BER = 2, 8, 4, 0, 1e-3
ARMS = [("fused", "one4n", "static"), ("fused", "one4n", "dynamic"),
        ("fused", "none", "dynamic"), ("hbm", "one4n", "static")]
ODD_VOCAB = 259


def _dkey():
    return jax.random.fold_in(jax.random.PRNGKey(SEED), 1)


def _reference_serve(r, serve_path, protect, inject):
    """The reference launcher's lock-step loop on ``r``'s weights ->
    (prefill logits, greedy tokens, ECC counts of the deployed image). Its
    fused reads run through their plain packed-jnp version
    (``use_kernel=False``, the reference's route for stores no kernel
    tiles) rather than the Pallas kernel in interpret mode, which compiles
    for minutes; ``test_odd_vocabulary_pack_and_read_rows`` holds the
    port's read against the reference's kernel route."""
    plain = functools.partial(j_cr_ops.cim_linear_store, use_kernel=False)
    with mock.patch.object(j_cr_ops, "cim_linear_store", plain):
        return _reference_lockstep(r, serve_path, protect, inject)


def _reference_lockstep(r, serve_path, protect, inject):
    jcfg = r.jcfg

    def serving(params, dkey):   # compiled once, not op by op
        if serve_path == "hbm":
            return j_serve.deploy(params, ber=BER, protect=protect, n_group=8,
                                  index=2, key=dkey)
        dep = j_serve.make_deployment(params, ber=BER, protect=protect,
                                      n_group=8, index=2, key=dkey,
                                      inject_mode=inject, field="full")
        return dep.serving_params(**j_serve.serving_kw(
            ber=BER, key=dkey, inject_mode=inject, field="full")), dep.stats()
    sp, stats = jax.jit(serving)(r.jp, _dkey())
    prompts = JMarkovLM(jcfg.vocab_size, PLEN, BATCH,
                        seed=SEED).batch(0)["tokens"]
    logits, caches = jax.jit(j_steps.make_prefill_step(jcfg))(
        sp, {"tokens": prompts})
    first = np.asarray(logits)

    def grow(a):
        if a.ndim >= 4 and a.shape[-3] == PLEN:
            pad = [(0, 0)] * a.ndim
            pad[-3] = (0, GEN)
            return jnp.pad(a, pad)
        return a
    caches = jax.tree_util.tree_map(grow, caches)
    step = jax.jit(j_steps.make_serve_step(jcfg))
    toks = jnp.argmax(logits, -1)[:, None]
    out = [toks]
    for _ in range(GEN - 1):
        logits, caches = step(sp, caches, toks)
        toks = jnp.argmax(logits, -1)[:, None]
        out.append(toks)
    ecc = {k: int(stats[k]) for k in ("corrected", "uncorrectable")}
    return first, np.asarray(jnp.concatenate(out, axis=1)), ecc


def _check_serve(r, serve_path, protect, inject):
    j_logits, j_tokens, j_ecc = _reference_serve(r, serve_path, protect,
                                                 inject)
    static, dynamic = _reference_seeds(r.jp, _dkey(), serve_path, protect)
    res = t_serve.serve(r.model, batch=BATCH, prompt_len=PLEN, gen=GEN,
                        seed=SEED, cim=True, ber=BER, protect=protect,
                        serve_path=serve_path, inject=inject,
                        static_seeds=static, dynamic_seeds=dynamic,
                        verbose=False)
    assert np.array_equal(res["tokens"], j_tokens)
    assert res["ecc"] == j_ecc
    t_logits = res["prefill_logits"].numpy()
    assert np.array_equal(np.isnan(t_logits), np.isnan(j_logits))
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-5)
    assert res["launches"] == {"cim_read_matmul_one4n": 0,
                               "cim_read_matmul_raw": 0}   # CPU: plain path
    if inject == "static" and protect == "one4n":
        assert j_ecc["corrected"] + j_ecc["uncorrectable"] > 0
    return res


@pytest.mark.parametrize("arch,serve_path,protect,inject", [
    ("granite-3-8b",) + arm for arm in ARMS] + [
    ("tinyvit-paper",) + arm for arm in (ARMS[1], ARMS[3])])
def test_serve_matches_reference(arch, serve_path, protect, inject):
    _check_serve(reference(arch), serve_path, protect, inject)


def test_odd_vocabulary_serves_as_reference():
    """Reduced granite at vocab 259 served fused one4n static: the unembed
    pads to 272 columns (its last 16-column group partial) and serves from
    its row cache, the embed's padded image decodes row by row.
    ``test_odd_vocabulary_pack_and_read_rows`` holds the padded dynamic
    reads."""
    r = reference("granite-3-8b", vocab_size=ODD_VOCAB)
    res = _check_serve(r, *ARMS[0])
    assert res["prefill_logits"].shape == (BATCH, ODD_VOCAB)


@pytest.mark.parametrize("protect", ("one4n", "none"))
def test_odd_vocabulary_pack_and_read_rows(protect):
    """The padded stores' planes, a static and a dynamic ``read_rows``
    gather (last rows included) and a dynamic unembed read through the
    plain version equal the reference's."""
    r = reference("granite-3-8b", vocab_size=ODD_VOCAB)
    pol = dict(protect=protect, n_group=8, index=2, serve_path="fused")
    seeds = {"man": 0x1234567, "meta": 0x89ABCDE, "cw": 0x2468ACE}
    thr = 4294967                      # ber_to_threshold(1e-3)
    idx = np.array([[0, 5, 255, 256, 258]], np.int32)
    x = np.random.default_rng(5).standard_normal((3, 128)).astype(np.float32)
    from repro.kernels.cim_read import ops as j_ops
    from repro_torch.kernels.cim_read import ops as t_ops

    def ref(p, idx, x):
        dep = j_dep.CIMDeployment.deploy(p, j_serve.serving_policy(**pol))
        emb, un = dep.stores["embed"], dep.stores["unembed"]
        sc = j_ops.make_scalars(seeds, thr, thr)
        return (emb, un, j_cim.read_rows(emb, idx),
                j_cim.read_rows(emb, idx, seeds=seeds, thr_man=thr,
                                thr_meta=thr),
                j_dep.dispatch_linear(x, un, scalars=sc))
    j_emb, j_un, j_rows, j_dyn, j_out = jax.jit(ref)(r.jp, idx, x)
    tdep = t_dep.CIMDeployment.deploy(r.model.cim_leaves(),
                                      t_serve.serving_policy(**pol))
    t_emb, t_un = tdep.stores["embed"], tdep.stores["unembed"]
    assert t_un.man.shape[1] == 272 and t_emb.shape == (ODD_VOCAB, 128)
    _same_planes(j_emb, t_emb)
    _same_planes(j_un, t_un)
    tidx = torch.from_numpy(idx).to(torch.int64)
    for want, got in ((j_rows, t_cim.read_rows(t_emb, tidx)),
                      (j_dyn, t_cim.read_rows(t_emb, tidx, seeds=seeds,
                                              thr_man=thr, thr_meta=thr))):
        assert np.array_equal(np.asarray(want).view(np.uint32),
                              got.numpy().view(np.uint32))
    t_out = t_dep.dispatch_linear(torch.from_numpy(x), t_un,
                                  scalars=t_ops.make_scalars(seeds, thr, thr))
    assert t_out.shape == (3, ODD_VOCAB)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch,protect", [
    ("granite-3-8b", "one4n"), ("command-r-35b", "none")])
def test_deploy_star_packs_the_stacked_norms(arch, protect):
    """``CIMDeployment.deploy`` under a ``pattern="*"`` rule (the hbm
    serving policy): the leaves it packs (embed, unembed and the stacked
    norms, never the final norm), their planes, the injected images under
    the reference's per-leaf key split, their ECC counts and the decoded
    leaves, all bitwise."""
    r = reference(arch)
    kw = dict(protect=protect, n_group=8, index=2, serve_path="hbm")
    key = _dkey()

    def ref(p, key):    # deploy, inject and read, one compile
        dep = j_dep.CIMDeployment.deploy(p, j_serve.serving_policy(**kw))
        inj = dep.inject(key, BER, field="full")
        return dep, inj, inj.read()
    jdep, jinj, (jread, jst) = jax.jit(ref)(r.jp, key)
    tdep = t_dep.CIMDeployment.deploy(r.model.cim_leaves(),
                                      t_serve.serving_policy(**kw))
    jpaths = [p for p, _, _ in jdep.store_leaves()]
    assert jpaths == [p for p, _, _ in tdep.store_leaves()]
    names = convert.block_leaves(r.cfg)["norm1"]
    assert set(jpaths) == {"embed", "unembed"} | {
        f"groups/blk0/{m}/{n}" for m in ("norm1", "norm2") for n in names}
    for (_, _, js), (_, _, ts) in zip(jdep.store_leaves(),
                                      tdep.store_leaves()):
        _same_planes(js, ts)
    assert jdep.bit_cost() == tdep.bit_cost()
    tinj = tdep.inject(_reference_seeds(r.jp, key, "hbm", protect)[0], BER,
                       field="full")
    for (_, _, js), (_, _, ts) in zip(jinj.store_leaves(),
                                      tinj.store_leaves()):
        _same_planes(js, ts)
    tread, tst = tinj.read()
    assert (int(jst["corrected"]), int(jst["uncorrectable"])) == \
        (tst["corrected"], tst["uncorrectable"])
    jread = convert.tree.flatten(jax.tree_util.tree_map(np.asarray, jread))
    for p in jpaths:
        assert np.array_equal(jread[p].view(np.uint32),
                              tread[p].numpy().view(np.uint32)), p


def test_hbm_params_serve_their_decoded_norms():
    """A serving dict's stacked norm leaves (what the hbm path decodes)
    replace the module's own in every path: prefill and decode equal a twin
    module that holds those norms."""
    r = reference("command-r-35b")
    dep = t_dep.CIMDeployment.deploy(
        r.model.cim_leaves(), t_serve.serving_policy(
            protect="one4n", n_group=8, index=2, serve_path="hbm"))
    seeds = t_serve.default_seeds(3, r.model.cim_leaves())[0]
    params, _ = dep.inject(seeds, 1e-2).read()
    norm = params["groups/blk0/norm1/scale"]
    assert not torch.equal(norm, r.flat["groups/blk0/norm1/scale"])
    flat = dict(r.flat, **{p: w for p, w in params.items()})
    twin = t_lm.LM(r.cfg, device="cpu")
    twin.load_state_dict(convert.lm_state_from_flat(flat, r.cfg))
    toks = torch.arange(2 * PLEN).reshape(2, PLEN) % r.cfg.vocab_size
    with torch.no_grad():
        a, ca = r.model.prefill(toks, params, max_len=PLEN + 1)
        b, cb = twin.prefill(toks, max_len=PLEN + 1)
        assert torch.equal(a, b)
        assert torch.equal(r.model.decode(ca, toks[:, :1], params)[0],
                           twin.decode(cb, toks[:, :1])[0])


def test_engine_on_granite_matches_forward_and_batch_invariance():
    """The engine's slot-state protocol on reduced granite (norms and GQA
    [B, max_len, 2, 32] slot states): chunked prefill then slot decode
    equal the forward's logits; a request served solo equals it
    co-batched, bitwise, under dynamic one4n reads."""
    r = reference("granite-3-8b")
    model = r.model
    toks = torch.arange(3, 3 + 13) % r.cfg.vocab_size
    caches = t_lm.init_slot_states(r.cfg, 2, 16, device="cpu")
    assert caches["layers"][0]["k"].shape == (2, 16, 2, 32)
    with torch.no_grad():
        want = model(toks[None])[0]
        l1, caches = model.prefill_chunk(caches, toks[:8], 1, 0)
        l2, caches = model.prefill_chunk(caches, toks[8:12], 1, 8)
        step = torch.stack([toks[:1], toks[12:13]])
        l3, caches = model.decode_slots(caches, step, [False, True])
    np.testing.assert_allclose(l1.numpy(), want[7].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(l2.numpy(), want[11].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(l3[1].numpy(), want[12].numpy(), rtol=1e-4,
                               atol=1e-5)
    params = t_serve.build_params(model, cim=True, ber=BER, protect="one4n",
                                  inject="dynamic", verbose=False)[0]
    load = t_engine.LoadGen(n_requests=3, prompt_lens=(4, 12),
                            gen_lens=(2, 4), vocab_size=r.cfg.vocab_size)
    reqs = load.requests()
    kw = dict(n_slots=2, max_len=load.max_len(), chunk=8,
              collect_logits=True)
    with torch.inference_mode():
        co, _ = t_engine.Engine(model, params, **kw).run(reqs)
        solo, _ = t_engine.Engine(model, params, **kw).run(reqs[2:])
    a, b = co[2], solo[2]
    assert a.tokens == b.tokens and a.ecc == b.ecc
    assert np.array_equal(a.logits.view(np.uint32), b.logits.view(np.uint32))


def test_launcher_serves_text_archs_and_refuses_stubs(capsys):
    common = ["--reduced", "--device", "cpu", "--cim", "--ber", "1e-3",
              "--inject", "dynamic"]
    res = t_serve.main(["--arch", "granite-3-8b", "--batch", "2",
                        "--prompt-len", "8", "--gen", "4"] + common)
    assert res["tokens"].shape == (2, 4)
    results, agg = t_serve.main(["--arch", "tinyvit-paper", "--engine",
                                 "--slots", "2", "--chunk", "8",
                                 "--requests", "3", "--prompt-range", "4,12",
                                 "--gen-range", "2,4"] + common)
    assert len(results) == 3 and agg["ecc"]["reads"] > 0
    out = capsys.readouterr().out
    assert "CIM fused serve: 2 weight matrices stay packed" in out
    for arch in ("musicgen-large", "internvl2-76b"):
        with pytest.raises(ValueError, match="text"):
            t_serve.main(["--arch", arch] + common)
