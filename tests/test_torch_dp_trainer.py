"""PyTorch port, data parallelism: the ``Trainer`` over 2 gloo ranks on the
CPU (``tests/_torch_dist.py``) against the JAX ``Trainer`` on a 2-device
mesh, from the same numpy parameters and data: the eager loop and the
indexed scanned epoch under sync and async (``avg_every`` 2 and 3 over an
epoch of 13 steps, which neither divides), ``per_worker_epoch``, and the
whole run (unshuffled, through each strategy's ``make_compiled_run_fn``,
as the JAX one; shuffled, the two packages' generators differ).

The printed lines match the JAX Trainer's with AvgTime and Total Time
masked and every printed number within 3e-4 (a printed cost may move by
one unit in its last digit); the final parameters within rtol 1e-5,
atol 1e-6.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from _torch_dist import run_world
from _torch_parity import mlp_numpy_params

N, B, HIDDEN = 2, 10, 16
TRAIN, TEST = 260, 100  # 13 global batches of 20
BASE = dict(epochs=2, batch_size=B, log_frequency=5, learning_rate=0.05)
RUNS = {
    "sync_eager": dict(scan_epoch=False),
    "sync_scan": dict(scan_epoch=True),
    "async2_eager": dict(sync=False, async_avg_every=2, scan_epoch=False),
    "async3_eager": dict(sync=False, async_avg_every=3, scan_epoch=False),
    "async2_scan": dict(sync=False, async_avg_every=2, scan_epoch=True),
    "async3_scan": dict(sync=False, async_avg_every=3, scan_epoch=True),
    "pwe_sync_scan": dict(per_worker_epoch=True, scan_epoch=True),
    "pwe_async_eager": dict(per_worker_epoch=True, sync=False, async_avg_every=2,
                            scan_epoch=False),
}
COMPILED = {
    "compiled_sync": dict(),
    "compiled_async2": dict(sync=False, async_avg_every=2),
}
FIELDS = ("w1", "b1", "w2", "b2")
_NUM = re.compile(r"-?\d+\.\d+")


def _masked(lines):
    out, nums = [], []
    for ln in lines:
        ln = re.sub(r"AvgTime: +[\d.]+ms", "AvgTime: #ms", ln)
        ln = re.sub(r"Total Time: +[\d.]+s", "Total Time: #s", ln)
        nums += [float(v) for v in _NUM.findall(ln)]
        out.append(_NUM.sub("#", ln))
    return out, nums


def _data():
    rng = np.random.default_rng(7)
    tree = mlp_numpy_params(hidden=HIDDEN, seed=8)
    return {
        **tree,
        "train_x": rng.random((TRAIN, 784), dtype=np.float32),
        "train_y": np.eye(10, dtype=np.float32)[rng.integers(0, 10, TRAIN)],
        "test_x": rng.random((TEST, 784), dtype=np.float32),
        "test_y": np.eye(10, dtype=np.float32)[rng.integers(0, 10, TEST)],
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = _data()
    runs = [{"name": k, "config": {**BASE, **v}} for k, v in RUNS.items()]
    runs += [{"name": k, "config": {**BASE, **v}, "compiled_unshuffled": True}
             for k, v in COMPILED.items()]
    runs += [{"name": "trainer_compiled_" + k, "config": {**BASE, **v, "compiled_run": True}}
             for k, v in (("sync", {}), ("async", dict(sync=False, async_avg_every=2)),
                          ("pwe", dict(per_worker_epoch=True)))]
    out = run_world("trainer", N, tmp_path_factory.mktemp("trainer"), inp, {"runs": runs})
    assert not any(r["jax_loaded"] for r in out)
    return inp, [r["result"] for r in out]


def _jax_strategy(cfg):
    import jax

    from distributed_tensorflow_tpu.parallel import (
        AsyncDataParallel,
        SyncDataParallel,
        make_mesh,
    )

    mesh = make_mesh(devices=jax.devices()[:N])
    if cfg.get("sync", True):
        return SyncDataParallel(mesh)
    return AsyncDataParallel(mesh, avg_every=cfg["async_avg_every"])


def _jax_params(inp):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLPParams

    return MLPParams(*(jnp.asarray(inp[k]) for k in FIELDS))


def _jax_trainer(inp, cfg, lines):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.config import TrainConfig
    from distributed_tensorflow_tpu.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu.models.mlp import MLP
    from distributed_tensorflow_tpu.parallel.strategy import TrainState
    from distributed_tensorflow_tpu.train.trainer import Trainer

    ds = Datasets(train=DataSet(inp["train_x"], inp["train_y"], seed=1),
                  validation=DataSet(inp["test_x"][:10], inp["test_y"][:10], seed=3),
                  test=DataSet(inp["test_x"], inp["test_y"], seed=2))
    strategy = _jax_strategy(cfg)
    tr = Trainer(MLP(hidden_dim=HIDDEN, compute_dtype=jnp.float32), ds,
                 TrainConfig(logs_path="", compute_dtype="float32", **cfg), strategy=strategy,
                 print_fn=lambda *a: lines.append(" ".join(map(str, a))))
    p = _jax_params(inp)
    tr.state = strategy.from_canonical(TrainState(p, tr.optimizer.init(p),
                                                  jnp.zeros((), jnp.int32)))
    return tr, tr.run()


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_the_jax_trainer(ranks, name):
    """The chief prints the JAX Trainer's lines (steps, the epochs' test
    accuracy, the final cost); the other rank prints the step lines only.
    Global steps, the history and the final parameters as JAX's."""
    inp, res = ranks
    cfg = {**BASE, **RUNS[name]}
    jlines = []
    jtr, jres = _jax_trainer(inp, cfg, jlines)
    chief, other = res[0][name], res[1][name]
    assert chief["scanned"] == cfg["scan_epoch"]
    (jm, jn), (tm, tn) = _masked(jlines), _masked(chief["lines"])
    assert tm == jm
    np.testing.assert_allclose(tn, jn, atol=3e-4)
    steps = [ln for ln in chief["lines"] if ln.startswith("Step:")]
    assert [ln for ln in other["lines"]] and all(ln.startswith("Step:") for ln in other["lines"])
    assert _masked(other["lines"])[0] == _masked(steps)[0]
    assert chief["result"]["global_step"] == jres["global_step"]
    np.testing.assert_allclose(chief["result"]["final_cost"], jres["final_cost"], rtol=1e-5)
    assert [h["step"] for h in chief["history"]] == [h["step"] for h in jtr.history]
    assert other["history"] == []
    jp = jtr.strategy.to_canonical(jtr.state).params
    for k in FIELDS:
        np.testing.assert_allclose(chief["params"][k], np.asarray(getattr(jp, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_per_worker_epoch_batch_counts(ranks):
    """Each worker runs num_examples // batch_size steps an epoch (26), not
    a pass over the data globally (13); async counts every rank's."""
    _, res = ranks
    assert res[0]["pwe_sync_scan"]["result"]["global_step"] == 2 * 26
    assert res[0]["pwe_async_eager"]["result"]["global_step"] == 2 * 26 * N
    assert res[0]["sync_scan"]["result"]["global_step"] == 2 * 13
    assert "Batch:  26 of  26" in " ".join(res[0]["pwe_sync_scan"]["lines"])


@pytest.mark.parametrize("name", list(COMPILED))
def test_compiled_run_unshuffled_matches_jax(ranks, name):
    """Each strategy's whole run with shuffle=False (rows in dataset
    order, 2 epochs) against the JAX strategy's."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLP
    from distributed_tensorflow_tpu.ops import cross_entropy, sgd
    from distributed_tensorflow_tpu.parallel.strategy import TrainState

    inp, res = ranks
    cfg = {**BASE, **COMPILED[name]}
    strategy = _jax_strategy(cfg)
    opt = sgd(cfg["learning_rate"])
    fn = strategy.make_compiled_run_fn(MLP(hidden_dim=HIDDEN, compute_dtype=jnp.float32),
                                       cross_entropy, opt, batch_size=B * N, epochs=2,
                                       shuffle=False)
    import jax

    p = _jax_params(inp)
    state, met = fn(strategy.from_canonical(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32))),
                    *(jnp.asarray(inp[k]) for k in ("train_x", "train_y", "test_x", "test_y")),
                    jax.random.key(0))
    jp = strategy.to_canonical(state).params
    for r in range(N):
        t = res[r][name]
        np.testing.assert_allclose(t["costs"], np.asarray(met["costs"]), rtol=1e-5)
        np.testing.assert_allclose(t["accuracy"], np.asarray(met["accuracy"]), atol=1e-6)
        assert t["step"] == strategy.global_step(state)
        for k in FIELDS:
            np.testing.assert_allclose(t["params"][k], np.asarray(getattr(jp, k)), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["sync", "async", "pwe"])
def test_trainer_compiled_run_under_dp(ranks, mode):
    """compiled_run=True through the Trainer: every rank draws the same
    shuffle, so the ranks end equal (sync, and async after its exchanges
    are merged); the chief alone prints the epochs' lines; the step count
    is the run's."""
    _, res = ranks
    chief, other = res[0]["trainer_compiled_" + mode], res[1]["trainer_compiled_" + mode]
    steps = {"sync": 2 * 13, "async": 2 * 13 * N, "pwe": 2 * 26}[mode]
    assert chief["result"]["global_step"] == other["result"]["global_step"] == steps
    assert sum(ln.startswith("Test-Accuracy") for ln in chief["lines"]) == 2
    assert not any(ln.startswith(("Test-Accuracy", "Final Cost")) for ln in other["lines"])
    for k in FIELDS:
        np.testing.assert_array_equal(chief["params"][k], other["params"][k])
    assert np.isfinite(chief["result"]["final_cost"])
