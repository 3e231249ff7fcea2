"""``ExpertDeployment`` (one CIM macro an expert) against the JAX
reference on reduced qwen3-moe-235b-a22b, and the serve launcher's
``--expert-cim``.

Both packages deploy the same stacked expert weights (``test_torch_kinds``'s
numpy draw, one layer: 12 expert stores, as the reference deploys eagerly
at about a second a store) under the launcher's per-expert policy, and inject static
faults at BER 1e-3 from the reference's per-store key split (its seeds
replayed into the port). Bitwise: the per-expert paths and the stacked
shapes, every packed and injected plane, ``stats_by_expert`` and the
restacked serving tensors. Served through the port's model, the restacked
experts give the reference's logits within allclose(rtol=1e-4, atol=1e-5)
and its greedy tokens. The launcher's artifact records ``expert_ecc``
equal to the reference's ``stats_by_expert`` when it serves the
reference's weights and seeds (the reference's launcher draws both from
``jax.random``, which the port does not reimplement, so the port's
launcher is handed them).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_deployment import _same_planes, jax_store_seeds  # noqa: E402
from test_torch_kinds import reference  # noqa: E402

from repro.core import deployment as j_dep  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402

ARCH, BER = "qwen3-moe-235b-a22b", 1e-3
POLICY = dict(protect="one4n", n_group=8, index=2)


@pytest.fixture(scope="module")
def deployed():
    """(reference model, the reference's deployment, its injected twin, the
    restacked serving params, its stats; the port's three)."""
    r = reference(ARCH, n_layers=1)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    # eagerly: under jax.jit XLA contracts alignment's rescale into an FMA
    # and rounds a weight to its fp16 neighbour (and compiles every store)
    jdep = j_dep.ExpertDeployment.deploy(
        r.jp, j_serve.expert_serving_policy(**POLICY))
    jinj = jdep.inject(key, BER)
    jserved = jinj.serving_params(r.jp)
    seeds = jax_store_seeds(jdep.inner, key)
    tpol = t_serve.expert_serving_policy(**POLICY)
    tdep = t_dep.ExpertDeployment.deploy(convert.expert_leaves(r.model), tpol)
    tinj = tdep.inject(seeds, BER)
    return r, jdep, jinj, jserved, tdep, tinj, seeds


def test_paths_shapes_and_planes(deployed):
    r, jdep, jinj, _, tdep, tinj, _ = deployed
    assert tdep.leaves == jdep.leaves == (
        ("groups/blk0/moe/moe_wgate", (1, 4, 128, 64)),
        ("groups/blk0/moe/moe_win", (1, 4, 128, 64)),
        ("groups/blk0/moe/moe_wout", (1, 4, 64, 128)))
    jpaths = [p for p, _, _ in jdep.inner.store_leaves()]
    assert jpaths == [p for p, _, _ in tdep.inner.store_leaves()]
    assert len(jpaths) == 3 * 4
    assert "groups/blk0/moe/moe_win/g0/expert3" in jpaths
    for dj, dt in ((jdep, tdep), (jinj, tinj)):
        for (_, _, js), (_, _, ts) in zip(dj.inner.store_leaves(),
                                          dt.inner.store_leaves()):
            _same_planes(js, ts)
    with pytest.raises(ValueError, match="no stacked MoE expert"):
        t_dep.ExpertDeployment.deploy(
            {"embed": r.model.embed.detach()},
            t_serve.expert_serving_policy(**POLICY))


def test_stats_and_restacked_serving_params(deployed):
    r, _, jinj, jserved, _, tinj, _ = deployed
    jstats = jinj.stats_by_expert()
    tstats = tinj.stats_by_expert()
    assert list(tstats) == list(jstats)
    assert tstats == {p: {k: (int(v) if k in ("corrected", "uncorrectable")
                              else v) for k, v in s.items()}
                      for p, s in jstats.items()}
    assert sum(s["corrected"] for s in tstats.values()) > 0
    tserved = tinj.serving_params()
    jflat = tree.flatten(jax.tree_util.tree_map(np.asarray, jserved))
    for p, _ in tinj.leaves:
        assert np.array_equal(tserved[p].numpy().view(np.uint32),
                              jflat[p].view(np.uint32)), p
    # served: the restacked experts replace the module's own
    toks = np.random.default_rng(4).integers(0, 256, (2, 9)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: j_lm.prefill(
        p, r.jcfg, {"tokens": t})[0])(jserved, toks))
    with torch.no_grad():
        got, _ = r.model.prefill(torch.from_numpy(toks).to(torch.int64),
                                 tserved)
        plain, _ = r.model.prefill(torch.from_numpy(toks).to(torch.int64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert not torch.equal(got, plain)


def test_expert_deploy_and_the_launcher_artifact(deployed, tmp_path,
                                                 capsys, monkeypatch):
    """``serve.expert_deploy`` on the reference's weights and seeds gives
    the reference's ``stats_by_expert``, and so does the artifact of the
    port's launcher, ``--expert-cim --engine --engine-json``, when it
    builds the reference's model (the launcher's model and expert seeds
    replaced by the reference's; the config cut to this file's one
    layer); it also serves its probe bitwise."""
    r, _, jinj, _, _, _, seeds = deployed
    want = {p: {k: (int(v) if k in ("corrected", "uncorrectable") else v)
                for k, v in s.items()}
            for p, s in jinj.stats_by_expert().items()}
    edep, restacked = t_serve.expert_deploy(
        convert.expert_leaves(r.model), ber=BER, seeds=seeds, verbose=False,
        **POLICY)
    assert edep.stats_by_expert() == want
    assert set(restacked) == {p for p, _ in edep.leaves}
    real_config = t_serve.get_config
    monkeypatch.setattr(t_serve, "get_config", lambda a: dataclasses.replace(
        real_config(a), n_layers=1))
    monkeypatch.setattr(t_serve, "LM", lambda cfg, **kw: r.model)
    monkeypatch.setattr(t_serve, "expert_seeds",
                        lambda seed, paths: {p: seeds[p] for p in paths})
    path = tmp_path / "e.json"
    t_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                  "--expert-cim", "--cim", "--ber", str(BER), "--engine",
                  "--slots", "2", "--chunk", "8", "--requests", "3",
                  "--prompt-range", "4,10", "--gen-range", "2,3",
                  "--probe", "1", "--engine-json", str(path)])
    out = capsys.readouterr().out
    assert "expert CIM deploy: 12 per-expert stores" in out
    assert "solo replay MATCHES" in out
    art = json.loads(path.read_text())
    assert art["config"]["expert_cim"] is True
    assert art["expert_ecc"] == want
    assert sum(v["corrected"] for v in want.values()) > 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no stacked MoE expert"):
        t_serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                      "--expert-cim", "--gen", "2", "--prompt-len", "4"])
