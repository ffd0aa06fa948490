"""PyTorch port, data parallelism of the classifier families: one world of
2 ranks over gloo on the CPU (``tests/_torch_dist.py`` case
``classifiers``) runs sync and ZeRO for the CNN, the LSTM and the
transformer, held against the JAX ``SyncDataParallel`` on a mesh of 2
virtual CPU devices from the same numpy parameters and batches; and
``Predictor`` serves an async state through its strategy.

One spawned world serves every case (a world costs seconds of process
start-up). Tolerances as tests/test_torch_dp.py's: parameters and costs
within rtol 1e-5, atol 1e-6 of JAX's after 3 steps (f32 sums over the
ranks in another order); ZeRO equal to the port's sync bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_dist import run_world
from _torch_parity import (
    CLASSIFIERS,
    classifier_models,
    classifier_numpy_params,
    jax_classifier_params,
)

RTOL, ATOL = 1e-5, 1e-6
FAMILIES = ("cnn", "lstm", "transformer")
B, STEPS, N = 4, 3, 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import cross_entropy
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.parallel import make_mesh
    from distributed_tensorflow_tpu.parallel.strategy import SyncDataParallel, TrainState

    rng = np.random.default_rng(21)
    xs = rng.random((STEPS, N * B, 784), dtype=np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (STEPS, N * B))]
    inp, trees = {"xs": xs, "ys": ys}, {}
    for fam in FAMILIES:
        jm, _ = classifier_models(fam)
        trees[fam] = classifier_numpy_params(jm, seed=22)
        inp.update({f"{fam}/{k}": v for k, v in trees[fam].items()})
    ranks = run_world("classifiers", N, tmp_path_factory.mktemp("classifiers"), inp,
                      {"families": {f: CLASSIFIERS[f] for f in FAMILIES}})
    mesh = make_mesh(devices=jax.devices()[:N])
    jax_res = {}
    for fam in FAMILIES:
        jm, _ = classifier_models(fam)
        strat, opt = SyncDataParallel(mesh), joptim.sgd(0.05)
        p = jax_classifier_params(jm, trees[fam])
        state = strat.from_canonical(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)))
        step = strat.make_train_step(jm, cross_entropy, opt)
        costs = []
        for x, y in zip(xs, ys):
            state, c = step(state, *strat.prepare_batch(x, y))
            costs.append(strat.cost_scalar(c))
        jax_res[fam] = (state.params, costs)
    return ranks, jax_res


def test_children_import_no_jax(world):
    ranks, _ = world
    assert not any(r["jax_loaded"] or r["jax_package_loaded"] for r in ranks)


@pytest.mark.parametrize("mode", ["sync", "zero"])
@pytest.mark.parametrize("family", FAMILIES)
def test_classifier_dp_matches_jax_sync(world, family, mode):
    """Sync (one bucket all-reduce) and ZeRO-3 on 2 ranks: every rank's
    canonical parameters and the averaged costs after 3 steps equal the
    JAX sync strategy's on its 2-device mesh."""
    ranks, jax_res = world
    jparams, jcosts = jax_res[family]
    for r in ranks:
        got = r["result"][family][mode]
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, np.asarray(getattr(jparams, k)), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{mode} {k}")
        np.testing.assert_allclose(got["costs"], jcosts, rtol=RTOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_classifier_zero_equals_sync_bitwise(world, family):
    ranks, _ = world
    for r in ranks:
        sync, zero = r["result"][family]["sync"], r["result"][family]["zero"]
        assert zero["costs"] == sync["costs"]
        for k, v in sync["params"].items():
            assert np.array_equal(zero["params"][k], v), k


def test_predictor_serves_an_async_state_through_its_strategy(world):
    """After one async step the ranks' copies differ; ``Predictor.from_state``
    with the strategy serves their mean, so its accuracy is the strategy's
    eval, and every rank serves the same probabilities."""
    ranks, _ = world
    preds = [r["result"]["predict"] for r in ranks]
    for p in preds:
        assert p["served"] == pytest.approx(p["eval"], abs=1e-6)
    np.testing.assert_array_equal(preds[0]["probs"], preds[1]["probs"])
