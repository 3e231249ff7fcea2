"""The sweep's trial mesh: a 4-rank ``("trial",)`` gloo mesh (launched with
torchrun's environment by ``test_torch_mesh._spawn``) runs Fig. 6's one4n arm
on the CNN, 8 trials at two BERs, each rank two trials. The gathered
per-trial accuracies and ECC counts equal the port's single-device engine's
bitwise, and so do two ``trial_shard`` slices joined by
``merge_trial_shards``; against the reference's single-device
``SweepEngine`` (its Pallas route in interpret mode, the same trial seeds)
the ECC counts are equal and the accuracies within 1/N_eval (the CNN's
logits sum in another order across frameworks).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cim as j_cim  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.data.synthetic import GaussianBlobs as JGaussianBlobs  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.data.synthetic import GaussianBlobs  # noqa: E402
from repro_torch.models import cnn as t_cnn  # noqa: E402
from test_torch_mesh import _spawn, jit  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trial_mesh_matches_single_device(tmp_path):
    bers, n_trials, n_eval = (1e-3, 1e-2), 8, 128
    jp = jit(j_cnn.init_cnn, static_argnames="n_classes")(
        jax.random.PRNGKey(0), n_classes=16)
    tp = convert.cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x, y = JGaussianBlobs().batch(n_eval, 99_999)
    xt, yt = (torch.from_numpy(a) for a in GaussianBlobs().batch(n_eval,
                                                                   99_999))
    key = jax.random.PRNGKey(5)
    _, sub = jax.random.split(key)
    seeds = np.asarray(jax.random.bits(sub, (len(bers), n_trials),
                                       jnp.uint32))[None]
    plan = t_sweep.SweepPlan(bers=bers, n_trials=n_trials,
                             protects=("one4n",))
    result = _spawn({"mode": "sweep", "plan": plan, "seeds": seeds,
                     "params": tp, "data": (xt, yt)}, tmp_path)
    j_res = j_sweep.SweepEngine(j_sweep.SweepPlan(
        bers=bers, n_trials=n_trials, protects=("one4n",),
        backend="pallas", interpret=True, shard_trials=False)).run_protection(
        key, jp, lambda p: jnp.mean(jnp.argmax(j_cnn.apply_cnn(p, x), -1)
                                    == y), j_cim.CIMConfig())

    def ev(p):
        return (t_cnn.apply_cnn(p, xt).argmax(-1) == yt).to(
            torch.float32).mean()
    single = t_sweep.SweepEngine(plan, device="cpu").run_protection(
        seeds, tp, ev)
    halves = [t_sweep.SweepEngine(plan, device="cpu", trial_shard=(2, i))
              .run_protection(seeds, tp, ev) for i in range(2)]
    got = result()
    for a, b, c in zip(got, single, t_sweep.merge_trial_shards(halves)):
        for cell in (a, c):
            assert cell.accuracies == b.accuracies
            assert cell.trial_corrected == b.trial_corrected
            assert cell.trial_uncorrectable == b.trial_uncorrectable
            assert (cell.corrected, cell.uncorrectable) == \
                (b.corrected, b.uncorrectable)
    assert got[-1].corrected > 0
    for a, b in zip(j_res, got):
        assert np.all(np.abs(np.asarray(a.accuracies)
                             - np.asarray(b.accuracies)) <= 1 / n_eval + 1e-9)
        assert (a.corrected, a.uncorrectable) == \
            (b.corrected, b.uncorrectable)
