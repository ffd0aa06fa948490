"""PyTorch port: the MLP model, losses, SGD, the single-device step and the
scanned and whole-run loops, against the JAX package on the same seeded
numpy inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import max_err, mlp_numpy_batches, mlp_numpy_params


def _jax_params(tree):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.mlp import MLPParams

    return MLPParams(*(jnp.asarray(tree[k]) for k in ("w1", "b1", "w2", "b2")))


def _torch_params(tree):
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy

    return mlp_params_from_numpy(tree, device="cpu")


# MLP.apply tolerances on probabilities: f32 differs only by summation
# order; bf16 operands are rounded identically but the f32 sums of their
# products still differ in order, and an activation near a bf16 rounding
# point can round to the neighbouring value. The weights are scaled by
# 1/sqrt(fan-in): at the N(0,1) init the 784-term sums reach O(10) and f32
# reordering alone moves probabilities by ~2e-6.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_mlp_apply_matches_jax(dtype, tol):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    tree = mlp_numpy_params(seed=0, fan_in=True)
    (x,), _ = mlp_numpy_batches(1, 64, seed=1)
    jm, tm = JMLP(compute_dtype=getattr(jnp, dtype)), MLP(compute_dtype=getattr(torch, dtype))
    jp, tp = _jax_params(tree), _torch_params(tree)
    assert max_err(tm.apply(tp, torch.from_numpy(x)), jm.apply(jp, jnp.asarray(x))) <= tol
    # Logits are O(10): the same tolerance relative to their scale.
    ref = np.asarray(jm.apply_logits(jp, jnp.asarray(x)))
    got = tm.apply_logits(tp, torch.from_numpy(x))
    assert max_err(got, ref) <= tol * max(1.0, np.abs(ref).max())


def test_mlp_init_is_seeded_normal_with_zero_biases():
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    a, b = MLP().init(seed=1, device="cpu"), MLP().init(seed=1, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.w1, MLP().init(seed=2, device="cpu").w1)
    assert a.w1.shape == (784, 100) and a.w2.shape == (100, 10)
    assert a.b1.abs().sum() == 0 and a.b2.abs().sum() == 0
    assert abs(a.w1.mean().item()) < 0.02 and abs(a.w1.std().item() - 1) < 0.02


def test_losses_match_jax():
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import losses as jl
    from distributed_tensorflow_tpu_torch.ops import losses as tl

    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((32, 10))).astype(np.float32)
    logits[0, 3] = 200.0  # a saturated row: the naive CE's clamp matters
    probs = np.asarray(torch.softmax(torch.from_numpy(logits), -1))
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]
    y[0] = np.eye(10, dtype=np.float32)[0]
    for jf, tf, arg in ((jl.cross_entropy, tl.cross_entropy, probs),
                        (jl.stable_cross_entropy, tl.stable_cross_entropy, logits),
                        (jl.accuracy, tl.accuracy, probs)):
        ref = float(jf(jnp.asarray(arg), jnp.asarray(y)))
        got = float(tf(torch.from_numpy(arg), torch.from_numpy(y)))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        assert np.isfinite(got)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_single_device_sgd_step_matches_jax(dtype, rtol):
    """One SingleDevice step: autograd + sgd vs jax.value_and_grad + optax
    sgd. f32: summation order only. bf16: both round the operands and the
    products' gradients to bf16 at the same places; order still differs."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu.ops import cross_entropy as jce
    from distributed_tensorflow_tpu.ops import sgd as jsgd
    from distributed_tensorflow_tpu.parallel.strategy import SingleDevice as JSD
    from distributed_tensorflow_tpu.parallel.strategy import TrainState as JTS
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.ops.optim import sgd
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice, TrainState

    tree = mlp_numpy_params(seed=3)
    (x,), (y,) = mlp_numpy_batches(1, 100, seed=4)
    jm = JMLP(compute_dtype=getattr(jnp, dtype))
    jopt = jsgd(0.01)
    jparams = _jax_params(tree)
    jstate = JTS(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    jstate, jc = JSD().make_train_step(jm, jce, jopt)(jstate, jnp.asarray(x), jnp.asarray(y))

    tm = MLP(compute_dtype=getattr(torch, dtype))
    strat = SingleDevice("cpu")
    step = strat.make_train_step(tm, cross_entropy, sgd(0.01))
    tstate, tc = step(TrainState(_torch_params(tree), None, 0), *strat.prepare_batch(x, y))
    assert tstate.step == 1 and strat.global_step(tstate) == int(jstate.step)
    np.testing.assert_allclose(strat.cost_scalar(tc), float(jc), rtol=rtol)
    for t, j in zip(tstate.params, jstate.params):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=1e-6)


def test_optimizer_registry():
    from distributed_tensorflow_tpu_torch.ops import optim

    assert optim.make("sgd", 0.5) == optim.sgd(0.5)
    assert optim.make("adam", 0.001) == optim.adam(0.001)
    assert optim.make("adamw", 0.001) == optim.adamw(0.001)
    assert optim.make("momentum", 0.001) == optim.momentum(0.001)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make("lbfgs", 0.001)


def test_mlp_convert_round_trip_is_bitwise():
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu_torch.convert import (
        mlp_params_from_numpy,
        mlp_params_to_numpy,
    )

    jp = JMLP().init(seed=1)  # the JAX NamedTuple goes in as it is
    back = mlp_params_to_numpy(mlp_params_from_numpy(jp, device="cpu"))
    for k, a in jp._asdict().items():
        a = np.asarray(a)
        assert a.dtype == back[k].dtype and a.tobytes() == back[k].tobytes(), k


def test_indexed_scan_matches_jax_and_the_staged_scan():
    """The indexed scanned epoch vs the JAX one on the same indices (f32),
    and the port's staged scan over the same batches equal to it."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu.ops import cross_entropy as jce
    from distributed_tensorflow_tpu.ops import sgd as jsgd
    from distributed_tensorflow_tpu.parallel.strategy import TrainState as JTS
    from distributed_tensorflow_tpu.train.scan import make_indexed_scanned_train_fn as jfn
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.ops.optim import sgd
    from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState
    from distributed_tensorflow_tpu_torch.train import scan

    tree = mlp_numpy_params(hidden=16, seed=5)
    (x,), (y,) = mlp_numpy_batches(1, 240, seed=6)
    idxs = np.random.default_rng(7).permutation(240).reshape(6, 40).astype(np.int32)
    jm, jopt = JMLP(hidden_dim=16, compute_dtype=jnp.float32), jsgd(0.05)
    jp = _jax_params(tree)
    js, jc = jfn(jm, jce, jopt)(JTS(jp, jopt.init(jp), jnp.zeros((), jnp.int32)),
                                jnp.asarray(x), jnp.asarray(y), jnp.asarray(idxs))
    tm = MLP(hidden_dim=16, compute_dtype=torch.float32)
    ts, tc = scan.make_indexed_scanned_train_fn(tm, cross_entropy, sgd(0.05))(
        TrainState(_torch_params(tree), None, 0), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(idxs).long(),
    )
    assert ts.step == 6
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    for t, j in zip(ts.params, js.params):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    ss, sc = scan.make_scanned_train_fn(tm, cross_entropy, sgd(0.05))(
        TrainState(_torch_params(tree), None, 0),
        torch.from_numpy(x[idxs]), torch.from_numpy(y[idxs]),
    )
    assert torch.equal(sc, tc)
    for a, b in zip(ss.params, ts.params):
        assert torch.equal(a, b)


def test_compiled_run_matches_jax_unshuffled():
    """make_compiled_run_fn(shuffle=False), 2 epochs (f32 model): the same
    costs and accuracies as the JAX whole-run program."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu.ops import cross_entropy as jce
    from distributed_tensorflow_tpu.ops import sgd as jsgd
    from distributed_tensorflow_tpu.parallel.strategy import TrainState as JTS
    from distributed_tensorflow_tpu.train.compiled_run import make_compiled_run_fn as jfn
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.ops.optim import sgd
    from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState
    from distributed_tensorflow_tpu_torch.train.compiled_run import make_compiled_run_fn

    tree = mlp_numpy_params(hidden=32, seed=8)
    (tx,), (ty,) = mlp_numpy_batches(1, 300, seed=9)
    (vx,), (vy,) = mlp_numpy_batches(1, 100, seed=10)
    kw = dict(batch_size=50, epochs=2, shuffle=False)
    jm, jopt = JMLP(hidden_dim=32, compute_dtype=jnp.float32), jsgd(0.05)
    jp = _jax_params(tree)
    js, jmet = jfn(jm, jce, jopt, **kw)(
        JTS(jp, jopt.init(jp), jnp.zeros((), jnp.int32)),
        *map(jnp.asarray, (tx, ty, vx, vy)), jax.random.key(0),
    )
    tm = MLP(hidden_dim=32, compute_dtype=torch.float32)
    ts, tmet = make_compiled_run_fn(tm, cross_entropy, sgd(0.05), **kw)(
        TrainState(_torch_params(tree), None, 0), *map(torch.from_numpy, (tx, ty, vx, vy)),
        torch.Generator().manual_seed(0),
    )
    assert ts.step == int(js.step) == 12
    np.testing.assert_allclose(tmet["costs"].numpy(), np.asarray(jmet["costs"]), rtol=1e-5)
    np.testing.assert_allclose(tmet["accuracy"].numpy(), np.asarray(jmet["accuracy"]), atol=1e-6)


def test_wrapped_epoch_perm_semantics():
    import jax
    from distributed_tensorflow_tpu.train.compiled_run import wrapped_epoch_perm as jperm
    from distributed_tensorflow_tpu_torch.train.compiled_run import wrapped_epoch_perm

    kw = dict(domain=7, need=17, k=3)
    plain = wrapped_epoch_perm(torch.Generator(), shuffle=False, device="cpu", **kw)
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jperm(jax.random.key(0), shuffle=False, **kw))
    )
    g = torch.Generator().manual_seed(3)
    got = wrapped_epoch_perm(g, shuffle=True, device="cpu", **kw).numpy()
    assert got.shape == (17,)
    for chunk in (got[:7], got[7:14]):  # each full draw is a permutation
        assert sorted(chunk) == list(range(7))
    one = wrapped_epoch_perm(g, shuffle=True, device="cpu", domain=9, need=9, k=1)
    assert sorted(one.tolist()) == list(range(9))
