"""PyTorch port: learning-rate schedules, global-norm clipping and gradient
accumulation (``ops/optim.py``) against the JAX package's optax ones, the
composed optimizer the launcher builds, and the MLP Trainer's stateful
optimizers on its eager, scanned and whole-run paths."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pytest
import torch
from _torch_parity import jax_model, jax_params, numpy_params, torch_params
from torch.utils._python_dispatch import TorchDispatchMode

SCHEDULES = [None, "constant", "cosine", "linear", "exponential"]


@pytest.mark.parametrize("warmup", [0, 7], ids=["no_warmup", "warmup"])
@pytest.mark.parametrize("name", SCHEDULES, ids=[str(s) for s in SCHEDULES])
def test_schedules_match_jax(name, warmup):
    """Every step 0..total+5 within rtol 1e-6 (both sides f32; XLA's cos
    and pow may differ from torch's by an ulp), or 1e-6 of the peak rate
    where the rate nears 0 (``1 + cos`` cancels there, so an ulp of cos is
    a large share of the rate but ~1e-9 of the peak)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.ops import optim

    total = 40
    ours = optim.schedule(name, 0.02, total, warmup_steps=warmup)
    ref = joptim.schedule(name, 0.02, total, warmup_steps=warmup)
    if name in (None, "constant") and not warmup:
        assert ours == ref == 0.02  # the float itself: the constant path stays bitwise
        return
    for t in range(total + 6):
        got = ours(torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32, got.dtype
        want = float(ref(jnp.asarray(t, jnp.int32)))
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6 * 0.02,
                                   err_msg=f"step {t}")


def test_unknown_schedule_raises():
    from distributed_tensorflow_tpu_torch.ops import optim

    with pytest.raises(ValueError, match="unknown lr schedule"):
        optim.schedule("step", 0.1, 100)


def _grad_tree(rng, like):
    return {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in like.items()}


@pytest.mark.parametrize("scale", [0.01, 100.0], ids=["below", "above"])
def test_clip_matches_optax(scale):
    """Global-norm clipping of gradients whose norm is below, then above,
    max_norm: the clipped gradients as optax's within rtol 1e-6 (the sum of
    squares is reduced in another order)."""
    import jax.numpy as jnp
    import optax
    from distributed_tensorflow_tpu_torch.ops import optim

    rng = np.random.default_rng(0)
    tree = {"a": np.zeros((16, 8)), "b": np.zeros(5), "c": np.zeros((3, 3, 3))}
    g = {k: scale * v for k, v in _grad_tree(rng, tree).items()}
    Leaves = NamedTuple("Leaves", [("a", torch.Tensor), ("b", torch.Tensor), ("c", torch.Tensor)])
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
    max_norm = 1.0
    assert (norm < max_norm) == (scale < 1)
    seen = []

    class Capture:
        def init(self, params):
            return ()

        def update(self, grads, state, params):
            seen.append(grads)
            return params, state

    opt = optim.clip(Capture(), max_norm)
    keys = sorted(g)
    leaves = Leaves(*(torch.from_numpy(g[k]) for k in keys))
    opt.update(leaves, opt.init(leaves), leaves)
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in g.items()}, (), None)
    for k, got in zip(keys, seen[0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(optim.global_norm(leaves)), norm, rtol=1e-6)


def test_wrappers_off_are_identities():
    from distributed_tensorflow_tpu_torch.ops import optim

    opt = optim.make("adam", 1e-3)
    assert optim.accumulate(opt, 1) is opt and optim.accumulate(opt, 0) is opt
    assert optim.clip(opt, 0.0) is opt and optim.clip(opt, -1.0) is opt


def test_accumulation_equals_one_step_on_the_large_batch():
    """k micro-batches under accumulate(sgd, k) == one SGD step on the k×B
    batch (the JAX tests/test_optim.py:54 equivalence), on the MLP."""
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import sgd_step

    model = MLP(hidden_dim=32, compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((64, 784), dtype=np.float32))
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
    k = 4
    opt = optim.accumulate(optim.make("sgd", 0.05), k)
    params = model.init(seed=1, device="cpu")
    state = opt.init(params)
    for i in range(k):
        before = params
        params, state, _ = sgd_step(model, cross_entropy, opt, params, state,
                                    x[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)])
        if i < k - 1:  # no apply yet: the parameters untouched, bit for bit
            assert all(torch.equal(a, b) for a, b in zip(params, before))
    ref, _, _ = sgd_step(model, cross_entropy, optim.sgd(0.05), model.init(seed=1, device="cpu"),
                         (), x, y)
    for a, b in zip(params, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    assert int(state.gradient_step) == 1 and int(state.mini_step) == 0


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_composed_optimizer_tracks_jax(name):
    """accumulate(clip(make(name, cosine with warmup), 1.0), 2), as the
    launchers compose it, over 10 updates of the same gradients (norms
    both below and above the clip): the parameters as optax's within rtol
    1e-5 (f32 in both; the norm's sum and the schedule's cos land an ulp
    apart, and 10 updates carry that)."""
    import jax
    import jax.numpy as jnp
    import optax
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.ops import optim

    tree = numpy_params(jax_model("float32"), seed=20)
    jp, tp = jax_params(tree), torch_params(tree)

    def compose(mod):
        lr = mod.schedule("cosine", 1e-2, 5, warmup_steps=2)
        return mod.accumulate(mod.clip(mod.make(name, lr), 1.0), 2)

    jopt, topt = compose(joptim), compose(optim)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(21)
    for step in range(10):
        scale = 1e-3 if step % 3 == 0 else 1.0  # some gradients below max_norm
        gtree = jax.tree.map(
            lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32), jp)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, gtree), js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = torch_params({**gtree._asdict(), "blocks": gtree.blocks._asdict()})
        tp, ts = topt.update(tg, ts, tp)
    for a, b in zip(jax.tree.leaves(jp), optim.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)
    assert int(ts.gradient_step) == int(js.gradient_step) == 5
    assert int(ts.mini_step) == int(js.mini_step) == 0


class _NoHostSync(TorchDispatchMode):
    """Fails on any op that reads a tensor's value on the host (``.item()``,
    ``float()``, ``bool()`` and ``int()`` of a tensor all come down to
    ``aten._local_scalar_dense``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("an optimizer update read a device value on the host")
        return func(*args, **(kwargs or {}))


def test_accumulating_update_does_not_sync_with_the_host():
    from distributed_tensorflow_tpu_torch.ops import optim

    tp = torch_params(numpy_params(jax_model("float32"), seed=22))
    lr = optim.schedule("exponential", 1e-2, 8, warmup_steps=3)
    opt = optim.accumulate(optim.clip(optim.make("adamw", lr), 0.5), 3)
    state = opt.init(tp)
    grads = optim.tree_map(torch.ones_like, tp)
    with _NoHostSync():
        for _ in range(4):
            tp, state = opt.update(grads, state, tp)
    assert int(state.gradient_step) == 1 and int(state.mini_step) == 1


def _mlp_pair(seed):
    from _torch_parity import mlp_numpy_batches, mlp_numpy_params

    tree = mlp_numpy_params(hidden=16, seed=seed)
    (x,), (y,) = mlp_numpy_batches(1, 240, seed=seed + 1)
    return tree, x, y


@pytest.mark.parametrize("path", ["eager", "scanned", "compiled"])
def test_mlp_trainer_paths_with_adam_match_jax(path):
    """The MLP step with Adam (schedule, clipping and accumulation on top)
    on each Trainer path against the JAX package's strategy step on the
    same batches: costs within rtol 1e-5, parameters within rtol 1e-5 and
    1e-5 absolute (f32 model; Adam's m/√v of a gradient near 0 magnifies
    the products' last-bit differences, up to 1e-3 of the peak rate)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu.ops import cross_entropy as jce
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.parallel.strategy import SingleDevice as JSD
    from distributed_tensorflow_tpu.parallel.strategy import TrainState as JTS
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice, TrainState
    from distributed_tensorflow_tpu_torch.train import compiled_run, scan

    tree, x, y = _mlp_pair(30)
    idxs = np.random.default_rng(31).permutation(240).reshape(6, 40)

    def compose(mod):
        lr = mod.schedule("cosine", 1e-2, 3, warmup_steps=1)
        return mod.accumulate(mod.clip(mod.make("adam", lr), 0.5), 2)

    jm, jopt = JMLP(hidden_dim=16, compute_dtype=jnp.float32), compose(joptim)
    from distributed_tensorflow_tpu.models.mlp import MLPParams as JP

    jp = JP(*(jnp.asarray(tree[k]) for k in ("w1", "b1", "w2", "b2")))
    js = JTS(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jstep = JSD().make_train_step(jm, jce, jopt)
    jcosts = []
    for row in idxs:
        js, c = jstep(js, jnp.asarray(x[row]), jnp.asarray(y[row]))
        jcosts.append(float(c))

    tm, topt = MLP(hidden_dim=16, compute_dtype=torch.float32), compose(optim)
    tp = mlp_params_from_numpy(tree, device="cpu")
    ts = TrainState(tp, topt.init(tp), 0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if path == "eager":
        step = SingleDevice("cpu").make_train_step(tm, cross_entropy, topt)
        costs = []
        for row in idxs:
            ts, c = step(ts, xt[row], yt[row])
            costs.append(float(c))
    elif path == "scanned":
        ts, c = scan.make_indexed_scanned_train_fn(tm, cross_entropy, topt)(
            ts, xt, yt, torch.from_numpy(idxs))
        costs = c.tolist()
    else:
        # The whole run unshuffled: its epochs take the rows in order.
        fn = compiled_run.make_compiled_run_fn(tm, cross_entropy, topt, batch_size=40,
                                               epochs=1, shuffle=False)
        order = idxs.reshape(-1)
        ts, met = fn(ts, xt[order], yt[order], xt[:40], yt[:40], torch.Generator())
        costs = met["costs"][0].tolist()
    assert ts.step == 6
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    for a, b in zip(ts.params, js.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert int(ts.opt_state.gradient_step) == 3


@pytest.mark.parametrize("kw", [
    dict(optimizer="momentum"), dict(lr_schedule="cosine"), dict(warmup_steps=5),
    dict(grad_clip_norm=1.0), dict(accumulate_steps=2),
], ids=["momentum", "schedule", "warmup", "clip", "accumulate"])
def test_pallas_engine_refuses_the_new_optimizer_settings(kw):
    """engine="pallas" runs plain constant-lr SGD only: the config and the
    composed optimizer's probe both refuse, with the JAX wording, before
    anything runs."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.ops import _build

    _, x, y = _mlp_pair(40)
    ds = Datasets(train=DataSet(x, y, seed=1), validation=DataSet(x[:10], y[:10], seed=3),
                  test=DataSet(x, y, seed=2))
    tr = build_trainer(TrainConfig(epochs=1, compiled_run=True, engine="pallas", **kw),
                       datasets=ds, device="cpu", print_fn=lambda *a: None)
    _build.reset_launches()
    with pytest.raises(ValueError, match="engine='pallas' requires the reference workload"):
        tr.run()
    assert not any(_build.LAUNCHES.values())
    # The composed optimizer object alone is refused by the probe too.
    tr2 = build_trainer(TrainConfig(epochs=1, compiled_run=True, engine="pallas"),
                        datasets=ds, device="cpu", print_fn=lambda *a: None,
                        optimizer=tr.optimizer)
    with pytest.raises(ValueError, match="optimizer \\(need plain constant-lr sgd semantics"):
        tr2.run()


def test_launcher_composes_the_optimizer_as_jax_does(monkeypatch):
    """build_trainer: accumulate(clip(make(name, schedule))) with the
    schedule over total applies = epochs · steps // accumulate_steps, and
    DTF_REMAT parsed as the JAX launcher parses it."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import _RematAdapter, build_trainer, config_from_env
    from distributed_tensorflow_tpu_torch.ops import optim

    _, x, y = _mlp_pair(50)
    ds = Datasets(train=DataSet(x, y, seed=1), validation=DataSet(x[:10], y[:10], seed=3),
                  test=DataSet(x, y, seed=2))
    cfg = TrainConfig(epochs=3, batch_size=40, optimizer="adamw", lr_schedule="linear",
                      warmup_steps=2, grad_clip_norm=0.5, accumulate_steps=2, remat="selective")
    tr = build_trainer(cfg, datasets=ds, device="cpu", print_fn=lambda *a: None)
    opt = tr.optimizer
    assert isinstance(opt, optim.Accumulate) and opt.every == 2
    assert isinstance(opt.inner, optim.Clip) and opt.inner.max_norm == 0.5
    adam = opt.inner.inner
    assert adam.weight_decay == 1e-4
    # 240 // 40 = 6 steps an epoch, 3 epochs, 2 a apply: 9 applies, 7 after warmup.
    assert adam.learning_rate == optim.Warmup(optim.Linear(0.0, 0.001, 2),
                                              optim.Linear(0.001, 0.0, 7), 2)
    assert isinstance(tr.model, _RematAdapter)  # any truthy remat is plain remat here
    res = tr.run()
    assert res["global_step"] == 18 and np.isfinite(res["final_cost"])
    assert int(tr.state.opt_state.gradient_step) == 9
    for raw, want in (("", False), ("0", False), ("1", True), ("selective", "selective")):
        monkeypatch.setenv("DTF_REMAT", raw)
        assert config_from_env().remat == want
    monkeypatch.setenv("DTF_REMAT", "sometimes")
    with pytest.raises(ValueError, match="remat must be"):
        config_from_env()


def test_remat_adapter_gradients_equal_plain():
    """The MLP under the launcher's remat adapter: the same costs and
    parameters after an epoch, bit for bit."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import build_trainer

    _, x, y = _mlp_pair(60)
    out = []
    for remat in (False, True):
        ds = Datasets(train=DataSet(x, y, seed=1), validation=DataSet(x[:10], y[:10], seed=3),
                      test=DataSet(x, y, seed=2))
        tr = build_trainer(TrainConfig(epochs=1, batch_size=40, remat=remat, loss="stable"),
                           datasets=ds, device="cpu", print_fn=lambda *a: None)
        res = tr.run()
        out.append((res["final_cost"], tr.state.params))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
