"""PyTorch port, tensor parallelism of the classifier families: the MLP's,
CNN's and LSTM's ``partition_specs``, ``SyncDataParallel(mesh,
param_specs=)`` (eager and scanned steps, eval, ``to_canonical``,
``Predictor`` through the strategy), ``fsdp_specs(base=)`` and
``ShardedDataParallel(param_specs=)`` (ZeRO over ``data`` layered on each
rank's tensor-parallel blocks) and the placement report of a tp state, on
the 4-rank gloo world of ``tests/_torch_tp.py`` laid out as a (2, 2)
``("data", "model")`` mesh, against ``SingleDevice`` on the global batch
and against the JAX package's GSPMD strategy on a (2, 2) mesh of its
virtual CPU devices (the JAX tests ``tests/test_tensor_parallel.py``,
``tests/test_cnn.py:103-120``, ``tests/test_rnn.py:119-135``,
``tests/test_fsdp.py:48`` and ``:106``, ``tests/test_placement.py:33``).

Tolerances are the JAX tests': the costs within rtol 2e-4, the parameters
within rtol 1e-4, atol 1e-6 (f32 models, 4 SGD steps on 16-row batches).
ZeRO over the tp base equals the tp strategy bit for bit (the same blocks
meet the same products; the gather adds zeros), as ZeRO equals sync.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_tp import CLASSIFIER_LR, FAMILIES, tp_world

COST_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-4, 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tp_world(tmp_path_factory)


def _torch(fam):
    from distributed_tensorflow_tpu_torch.models import build_model

    reg, kw = FAMILIES[fam]
    return build_model(reg, compute_dtype=torch.float32, **kw)


def _jax(fam):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models import build_model

    reg, kw = FAMILIES[fam]
    return build_model(reg, compute_dtype=jnp.float32, **kw)


def _single(fam, tree, xs, ys):
    """SingleDevice on the global batches: (canonical numpy params, costs)."""
    from distributed_tensorflow_tpu_torch.convert import params_from_numpy, params_to_numpy
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice, TrainState

    model, strat, opt = _torch(fam), SingleDevice("cpu"), optim.sgd(CLASSIFIER_LR[fam])
    p = params_from_numpy(tree, type(model.init(1, device="cpu")), "cpu")
    state, step = TrainState(p, opt.init(p), 0), strat.make_train_step(model, cross_entropy, opt)
    costs = []
    for x, y in zip(xs, ys):
        state, c = step(state, *strat.prepare_batch(x, y))
        costs.append(float(c))
    return params_to_numpy(state.params), costs


def _jax_tp(fam, tree, xs, ys):
    """JAX SyncDataParallel(mesh (2, 2), param_specs=partition_specs())."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import cross_entropy, sgd
    from distributed_tensorflow_tpu.parallel import SyncDataParallel, make_mesh
    from distributed_tensorflow_tpu.parallel.strategy import TrainState

    model, opt = _jax(fam), sgd(CLASSIFIER_LR[fam])
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    strat = SyncDataParallel(mesh, param_specs=model.partition_specs())
    p = type(model.init(1))(**{k: jnp.asarray(v) for k, v in tree.items()})
    state = strat.from_canonical(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)))
    step = strat.make_train_step(model, cross_entropy, opt)
    costs = []
    for x, y in zip(xs, ys):
        state, c = step(state, *strat.prepare_batch(x, y))
        costs.append(strat.cost_scalar(c))
    return {k: np.asarray(v) for k, v in state.params._asdict().items()}, costs


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_partition_specs_match_jax(fam):
    """Each family's layout is JAX's entry for entry (a ``PartitionSpec``
    as a tuple), on any axis name."""
    for axis in ("model", "tp"):
        got, want = _torch(fam).partition_specs(axis), _jax(fam).partition_specs(axis)
        assert got._fields == want._fields
        assert list(got) == [tuple(s) for s in want]


@pytest.mark.parametrize("fam,shapes", [
    ("mlp", {"w1": (784, 50), "b1": (50,), "w2": (50, 10), "b2": (10,)}),
    ("cnn", {"conv1_w": (5, 5, 1, 2), "conv2_w": (5, 5, 2, 8), "fc1_w": (392, 16),
             "fc2_w": (16, 10), "fc2_b": (10,)}),
    ("lstm", {"w": (60, 4, 16), "b": (4, 16), "head_w": (16, 10), "head_b": (10,)}),
])
def test_tp_params_actually_sharded(world, fam, shapes):
    """Each rank holds its block of every split leaf (JAX's
    ``test_tp_params_actually_sharded`` of the three families): the MLP's
    W1 on its hidden units, the CNN's conv1 on its output channels and
    conv2 on its input channels, the LSTM's gate kernel on its hidden
    units and its head on its rows; the other leaves whole."""
    *_, res = world
    for r in res:
        local = r[f"{fam}_tp"]["local"]
        for k, shape in shapes.items():
            assert local[k] == shape, (k, local[k])


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_dp_tp_matches_single_device(world, fam):
    """Four SGD steps of SyncDataParallel with the family's tensor-parallel
    layout on (2, 2): the costs and the gathered parameters against
    SingleDevice on the global batches and against JAX's dp×tp strategy;
    every rank's canonical parameters equal."""
    _, classifiers, _, inp, res = world
    tree = classifiers[fam]
    got = res[0][f"{fam}_tp"]
    for r in res[1:]:
        for k, v in got["params"].items():
            assert np.array_equal(r[f"{fam}_tp"]["params"][k], v)
    want, costs = _single(fam, tree, inp["cx"], inp["cy"])
    np.testing.assert_allclose(got["costs"], costs, rtol=COST_RTOL)
    _close(got["params"], want, "single")
    jwant, jcosts = _jax_tp(fam, tree, inp["cx"], inp["cy"])
    np.testing.assert_allclose(got["costs"], jcosts, rtol=COST_RTOL)
    _close(got["params"], jwant, "jax")


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_tp_eval_scan_and_predictor(world, fam):
    """The strategy's eval (the tp forward on the blocks) is the accuracy
    of the gathered parameters' dense forward; ``Predictor.from_state``
    reads the tp state through the strategy (gathered) and serves the dense
    forward's probabilities; the scanned epoch equals the eager steps."""
    from distributed_tensorflow_tpu_torch.convert import params_from_numpy
    from distributed_tensorflow_tpu_torch.ops.losses import accuracy

    _, _, _, inp, res = world
    model = _torch(fam)
    cls = type(model.init(1, device="cpu"))
    for r in res:
        got = r[f"{fam}_tp"]
        params = params_from_numpy(got["params"], cls, "cpu")
        x, y = torch.from_numpy(inp["cx"][0]), torch.from_numpy(inp["cy"][0])
        with torch.no_grad():
            probs = model.apply(params, x)
        assert got["eval"] == float(accuracy(probs, y))
        np.testing.assert_allclose(got["probs"], probs.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["scanned"]["costs"], got["costs"], rtol=1e-6)
        _close(got["scanned"]["params"], got["params"], "scanned")


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_convert_round_trip_of_a_tp_state_is_bitwise(world, fam):
    """A canonical numpy state (the params, an Adam state over them, the
    step) → each rank's tp blocks (``sharded_state_from_numpy``) →
    gathered back (``sharded_state_to_numpy``), bit for bit."""
    _, classifiers, _, _, res = world
    tree = classifiers[fam]
    for r in res:
        params, opt, step = r[f"{fam}_tp"]["round_trip"]
        assert step == 3 and int(opt["count"]) == 3
        for k, v in tree.items():
            assert params[k].dtype == v.dtype and np.array_equal(params[k], v)
            assert np.array_equal(opt["mu"][k], v) and np.array_equal(opt["nu"][k], abs(v))


def test_explicit_collectives_rejects_tp():
    """As JAX's: the explicit-collectives path is pure DP only."""
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.parallel.strategy import SyncDataParallel

    with pytest.raises(ValueError, match="explicit_collectives path supports pure DP only"):
        SyncDataParallel(Mesh({"data": 2, "model": 2}), explicit_collectives=True,
                         param_specs=MLP().partition_specs())


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (8, 1)])
def test_fsdp_specs_layer_onto_tp_base(shape):
    """fsdp_specs(base=) against JAX's on a mesh of the same shape (JAX
    ``tests/test_fsdp.py:48``): the base's dims kept, ZeRO on the largest
    free dim the data axis divides."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models import MLP as JMLP
    from distributed_tensorflow_tpu.parallel import make_mesh
    from distributed_tensorflow_tpu.parallel.fsdp import fsdp_specs as jfsdp
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.parallel.fsdp import fsdp_specs
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    jm = JMLP(hidden_dim=128, compute_dtype=jnp.float32)
    want = jfsdp(jm.init(seed=1), make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))]),
                 base=jm.partition_specs())
    model = MLP(hidden_dim=128, compute_dtype=torch.float32)
    got = fsdp_specs(model.init(1, device="cpu"), Mesh(dict(zip(("data", "model"), shape))),
                     base=model.partition_specs())
    assert list(got) == [tuple(s) for s in want]
    if shape == (4, 2):
        assert got.w1 == ("data", "model") and got.w2 == ("model",)


def test_fsdp_composes_with_tensor_parallel(world):
    """ShardedDataParallel(mesh, param_specs=) on (2, 2) (JAX
    ``tests/test_fsdp.py:106``): W1 split over both axes (each rank a
    quarter), and the run equals the tp strategy's bit for bit."""
    *_, res = world
    for r in res:
        got, tp = r["mlp_zero_tp"], r["mlp_tp"]
        assert got["local"]["w1"] == (784 // 2, 100 // 2)
        assert got["local"]["w2"] == (50, 5) and got["local"]["b2"] == (5,)
        assert got["costs"] == tp["costs"]
        for k, v in tp["params"].items():
            np.testing.assert_array_equal(got["params"][k], v)


def test_placement_of_a_tp_state_as_jax(world):
    """describe_state of a tp state renders JAX's lines for the same layout
    on a (2, 2) mesh (global shapes, the specs, 4 devices); the state is
    not replicated and is sharded over "model" (JAX
    ``tests/test_placement.py:33``)."""
    import jax

    from distributed_tensorflow_tpu.models import MLP as JMLP
    from distributed_tensorflow_tpu.ops import sgd
    from distributed_tensorflow_tpu.parallel import SyncDataParallel, make_mesh
    from distributed_tensorflow_tpu.utils.placement import describe

    import jax.numpy as jnp

    *_, res = world
    jm = JMLP(compute_dtype=jnp.float32)
    strat = SyncDataParallel(make_mesh((2, 2), devices=jax.devices()[:4]),
                             param_specs=jm.partition_specs())
    want = describe(strat.init_state(jm, sgd(0.001), seed=1).params, print_fn=lambda s: None)
    for r in res:
        assert r["mlp_placement"]["lines"] == want
        assert r["mlp_placement"]["replicated"] is False


@pytest.mark.parametrize("fam,knobs,match", [
    ("mlp", {}, r"w1: dim 1 of size 100 does not split over the 3-way 'model' axis"),
    ("cnn", dict(channels=(4, 8)), r"conv1_w: dim 3 of size 4 does not split"),
    ("lstm", dict(hidden_dim=32), r"w: dim 2 of size 32 does not split"),
])
def test_tp_refuses_a_dim_the_axis_does_not_divide(fam, knobs, match):
    """The port's envelope: JAX's GSPMD pads a dim the axis size does not
    divide (the MLP's 100 hidden units at tp 3); the port refuses the
    layout when the strategy builds its state, naming the leaf."""
    from distributed_tensorflow_tpu_torch.models import build_model
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.parallel.strategy import SyncDataParallel

    model = build_model(FAMILIES[fam][0], compute_dtype=torch.float32, **knobs)
    strat = SyncDataParallel(Mesh({"data": 1, "model": 3}), param_specs=model.partition_specs())
    with pytest.raises(ValueError, match=match):
        strat.init_state(model, optim.sgd(0.1), seed=1)
