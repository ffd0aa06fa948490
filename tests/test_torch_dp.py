"""PyTorch port, data parallelism: the strategies over ``torch.distributed``
(gloo on the CPU, a process a rank, ``tests/_torch_dist.py``) against the
JAX strategies on a mesh of the same N virtual CPU devices, from the same
numpy parameters and batches.

Tolerances: parameters and costs within rtol 1e-5, atol 1e-6 of JAX's
after 5 steps (f32 sums over the ranks in another order), and atol 1e-5
under Adam (m/√v of a gradient element near 0 magnifies its last-bit
differences up to a part in 1e3 of the rate, as PR 12's Adam tests state); ZeRO equal to the
port's sync bit for bit at 2 ranks and within rtol 1e-6 at 4; a world of
one rank equal to SingleDevice bit for bit.
"""

from __future__ import annotations

import ast
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from _torch_dist import REPO, run_world
from _torch_parity import mlp_numpy_batches, mlp_numpy_params

RTOL, ATOL = 1e-5, 1e-6
ADAM_ATOL = 1e-5
HIDDEN, B, STEPS = 16, 8, 5
FIELDS = ("w1", "b1", "w2", "b2")


def _inputs(n, seed=3):
    tree = mlp_numpy_params(hidden=HIDDEN, seed=seed)
    xs, ys = mlp_numpy_batches(STEPS, n * B, seed=seed + 1)
    return {**tree, "xs": xs, "ys": ys}


def _jax_mesh(n):
    import jax

    from distributed_tensorflow_tpu.parallel import make_mesh

    return make_mesh(devices=jax.devices()[:n])


def _jax_state(strategy, inp, opt):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLPParams
    from distributed_tensorflow_tpu.parallel.strategy import TrainState

    p = MLPParams(*(jnp.asarray(inp[k]) for k in FIELDS))
    return strategy.from_canonical(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)))


def _jax_drive(strategy, inp, opt, steps=STEPS):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLP
    from distributed_tensorflow_tpu.ops import cross_entropy

    model = MLP(hidden_dim=HIDDEN, compute_dtype=jnp.float32)
    state = _jax_state(strategy, inp, opt)
    step = strategy.make_train_step(model, cross_entropy, opt)
    costs = []
    for x, y in zip(inp["xs"][:steps], inp["ys"][:steps]):
        state, c = step(state, *strategy.prepare_batch(x, y))
        costs.append(strategy.cost_scalar(c))
    return model, state, costs


def _close(port: dict, jax_tree, rtol=RTOL, atol=ATOL):
    for k in FIELDS:
        np.testing.assert_allclose(port[k], np.asarray(getattr(jax_tree, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, tmp_path_factory):
    """One world a size running every strategy case, and the JAX side."""
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.parallel.strategy import (
        AsyncDataParallel,
        SyncDataParallel,
    )

    n = request.param
    inp = _inputs(n)
    ranks = run_world("strategies", n, tmp_path_factory.mktemp(f"strategies{n}"), inp)
    mesh = _jax_mesh(n)
    jax_res = {
        "sync_sgd": _jax_drive(SyncDataParallel(mesh), inp, joptim.sgd(0.05)),
        "sync_adam": _jax_drive(SyncDataParallel(mesh), inp, joptim.make("adam", 0.01)),
        "sync_explicit": _jax_drive(SyncDataParallel(mesh, explicit_collectives=True), inp,
                                    joptim.sgd(0.05)),
        "async": _jax_drive(AsyncDataParallel(mesh), inp, joptim.make("momentum", 0.05),
                            steps=3),
    }
    return n, inp, [r["result"] for r in ranks], [r for r in ranks], jax_res, mesh


def test_children_import_no_jax(world):
    _, _, _, raw, _, _ = world
    assert not any(r["jax_loaded"] or r["jax_package_loaded"] for r in raw)


def test_spawn_helper_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "tests", "_torch_dist.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "distributed_tensorflow_tpu")


@pytest.mark.parametrize("case", ["sync_sgd", "sync_adam", "sync_explicit"])
def test_sync_matches_jax_sync(world, case):
    """Sync DP (bucket, Adam, per-leaf) after 5 steps: parameters and the
    averaged costs as the JAX strategy's on the same mesh, on every rank."""
    n, _, res, _, jax_res, _ = world
    _, jstate, jcosts = jax_res[case]
    for r in range(n):
        _close(res[r][case]["params"], jstate.params, atol=ADAM_ATOL if "adam" in case else ATOL)
        np.testing.assert_allclose(res[r][case]["costs"], jcosts, rtol=RTOL)
        assert res[r][case]["step"] == int(jstate.step) == STEPS


def test_sync_equals_single_device_on_the_global_batch(world):
    """The average of the ranks' gradients is the gradient of the global
    batch's mean loss."""
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice, TrainState

    n, inp, res, _, _, _ = world
    strat, opt = SingleDevice("cpu"), optim.sgd(0.05)
    p = mlp_params_from_numpy({k: inp[k] for k in FIELDS}, device="cpu")
    state = TrainState(p, opt.init(p), 0)
    step = strat.make_train_step(MLP(hidden_dim=HIDDEN, compute_dtype=torch.float32),
                                 cross_entropy, opt)
    costs = []
    for x, y in zip(inp["xs"], inp["ys"]):
        state, c = step(state, *strat.prepare_batch(x, y))
        costs.append(float(c))
    np.testing.assert_allclose(res[0]["sync_sgd"]["costs"], costs, rtol=RTOL)
    for k in FIELDS:
        np.testing.assert_allclose(res[0]["sync_sgd"]["params"][k],
                                   getattr(state.params, k).numpy(), rtol=RTOL, atol=ATOL)


def test_explicit_collectives_agree_with_the_bucket(world):
    """Bit for bit at 2 ranks; at 4, gloo's all-reduce may sum a long
    bucket and a short leaf in different orders (rtol 1e-6)."""
    n, _, res, _, _, _ = world
    rtol = 0 if n == 2 else 1e-6
    for r in range(n):
        for k in FIELDS:
            np.testing.assert_allclose(res[r]["sync_explicit"]["params"][k],
                                       res[r]["sync_sgd"]["params"][k], rtol=rtol, atol=0)
        np.testing.assert_allclose(res[r]["sync_explicit"]["costs"], res[r]["sync_sgd"]["costs"],
                                   rtol=rtol, atol=0)


def test_async_diverges_then_exchanges_to_equal_copies(world):
    """Three local momentum steps at update_scale=N: each rank's copy equals
    JAX's copy of that replica; the copies differ (divergence as JAX's
    make_divergence_fn), and after the exchange they are equal, at the
    mean, with divergence 0."""
    n, _, res, _, jax_res, mesh = world
    from distributed_tensorflow_tpu.parallel.strategy import AsyncDataParallel

    _, jstate, jcosts = jax_res["async"]
    jdiv = float(AsyncDataParallel(mesh).make_divergence_fn()(jstate))
    for r in range(n):
        a = res[r]["async"]
        for k in FIELDS:
            np.testing.assert_allclose(a["params"][k], np.asarray(getattr(jstate.params, k))[r],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(a["costs"], jcosts, rtol=RTOL)
        assert a["divergence"] > 0
        np.testing.assert_allclose(a["divergence"], jdiv, rtol=1e-4)
        assert a["divergence_after"] == 0.0
        for k in FIELDS:
            assert np.array_equal(a["exchanged"][k], res[0]["async"]["exchanged"][k])
            np.testing.assert_allclose(a["exchanged"][k],
                                       np.asarray(getattr(jstate.params, k)).mean(0),
                                       rtol=RTOL, atol=ATOL)


def test_async_global_step_counts_all_replicas(world):
    n, _, res, _, jax_res, mesh = world
    from distributed_tensorflow_tpu.parallel.strategy import AsyncDataParallel

    _, jstate, _ = jax_res["async"]
    for r in range(n):
        assert res[r]["async"]["step"] == (3,) * n
        assert res[r]["async"]["global_step"] == AsyncDataParallel(mesh).global_step(jstate) == 3 * n


def test_async_eval_uses_mean_params(world):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLP
    from distributed_tensorflow_tpu.parallel.strategy import AsyncDataParallel

    n, inp, res, _, jax_res, mesh = world
    _, jstate, _ = jax_res["async"]
    strat = AsyncDataParallel(mesh)
    jacc = float(strat.make_eval_fn(MLP(hidden_dim=HIDDEN, compute_dtype=jnp.float32))(
        jstate, jnp.asarray(inp["xs"][0]), jnp.asarray(inp["ys"][0])))
    assert all(res[r]["async"]["eval"] == jacc for r in range(n))


def test_async_canonical_forms_match_jax(world):
    """to_canonical: the mean of the copies and of the momentum traces
    (the port's momentum state also counts its updates, an integer leaf
    that merges), the summed step; from_canonical spreads a step of 7 over
    the ranks."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.parallel.strategy import AsyncDataParallel, TrainState

    n, _, res, _, jax_res, mesh = world
    _, jstate, _ = jax_res["async"]
    strat = AsyncDataParallel(mesh)
    canon = strat.to_canonical(jstate)
    spread = strat.from_canonical(TrainState(canon.params, canon.opt_state,
                                             jnp.asarray(7, jnp.int32))).step
    for r in range(n):
        a = res[r]["async"]
        _close(a["canonical"], canon.params)
        assert a["canonical_step"] == int(canon.step) == 3 * n
        assert int(a["canonical_opt"]["count"]) == 3
        _close(a["canonical_opt"]["trace"], canon.opt_state[0].trace)
        assert a["spread"] == tuple(int(s) for s in np.asarray(spread))


def test_merge_replica_leaf_refuses_differing_integers(world):
    from distributed_tensorflow_tpu.parallel.strategy import merge_replica_leaf

    n, _, res, _, _, _ = world
    with pytest.raises(ValueError) as jerr:
        merge_replica_leaf(np.arange(n, dtype=np.int32))
    assert all(res[r]["merge_refused"] == str(jerr.value) for r in range(n))


def test_async_scanned_epoch_matches_jax(world):
    """avg_every=2 over 5 staged steps: two exchanges, then one step more
    (the remainder after the last exchange)."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLP
    from distributed_tensorflow_tpu.ops import cross_entropy, sgd
    from distributed_tensorflow_tpu.parallel.strategy import AsyncDataParallel

    n, inp, res, _, _, mesh = world
    strat = AsyncDataParallel(mesh, avg_every=2)
    opt = sgd(0.05)
    state = _jax_state(strat, inp, opt)
    fn = strat.make_scanned_train_fn(MLP(hidden_dim=HIDDEN, compute_dtype=jnp.float32),
                                     cross_entropy, opt)
    state, costs = fn(state, jnp.asarray(inp["xs"]), jnp.asarray(inp["ys"]))
    for r in range(n):
        a = res[r]["async_scan"]
        assert a["step"] == (STEPS,) * n
        np.testing.assert_allclose(a["costs"], np.asarray(costs), rtol=RTOL)
        for k in FIELDS:
            np.testing.assert_allclose(a["params"][k], np.asarray(getattr(state.params, k))[r],
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_zero_equals_sync(world, opt):
    """ZeRO-3 against the port's sync: bit for bit at 2 ranks, within
    rtol 1e-6 at 4; costs, parameters and optimizer state."""
    n, _, res, _, _, _ = world
    for r in range(n):
        z, s = res[r][f"zero_{opt}"], res[r][f"sync_{opt}"]
        for k in FIELDS:
            if n == 2:
                assert np.array_equal(z["params"][k], s["params"][k]), k
            else:
                np.testing.assert_allclose(z["params"][k], s["params"][k], rtol=1e-6, atol=0)
        np.testing.assert_allclose(z["costs"], s["costs"], rtol=0 if n == 2 else 1e-6)
        if opt == "adam":
            assert int(z["opt"]["count"]) == int(s["opt"]["count"]) == STEPS
            for k in FIELDS:
                np.testing.assert_allclose(z["opt"]["nu"][k], s["opt"]["nu"][k],
                                           rtol=0 if n == 2 else 1e-6)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_zero_shards_params_and_optimizer_state(world, opt):
    """Each rank holds its 1/N slice of every sharded leaf (JAX's
    fsdp_specs dims), of Adam's moments too; the slices tile the whole."""
    n, _, res, _, _, mesh = world
    from distributed_tensorflow_tpu.models.mlp import MLP
    from distributed_tensorflow_tpu.parallel.fsdp import fsdp_specs

    jspecs = fsdp_specs(MLP(hidden_dim=HIDDEN).init(1), mesh)
    want = [list(getattr(jspecs, k)) for k in FIELDS]
    for r in range(n):
        z = res[r][f"zero_{opt}"]
        assert z["specs"] == want
        for k, spec in zip(FIELDS, want):
            full = z["params"][k]
            if spec:
                d = len(spec) - 1
                s = full.shape[d] // n
                assert z["shards"][k].shape[d] == s
                assert np.array_equal(z["shards"][k], np.take(full, range(r * s, (r + 1) * s), d))
                if opt == "adam":
                    assert z["opt_shards"]["mu"][k].shape == z["shards"][k].shape
            else:
                assert z["shards"][k].shape == full.shape
    assert any(want)


def test_zero_eval_gathers_the_whole_params(world):
    n, _, res, _, _, _ = world
    for opt in ("sgd", "adam"):
        assert len({res[r][f"zero_{opt}"]["eval"] for r in range(n)}) == 1


class _One(NamedTuple):
    a: torch.Tensor


@pytest.mark.parametrize("shape", [(784, 16), (16,), (16, 10), (10,), (7, 3), (12, 12), (5,), (2, 8, 6)])
@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_specs_choose_the_jax_dim(shape, n):
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.parallel.fsdp import fsdp_specs as jspecs
    from distributed_tensorflow_tpu_torch.parallel.fsdp import fsdp_specs

    mesh = _jax_mesh(n)
    want = jspecs({"a": jax.ShapeDtypeStruct(shape, jnp.float32)}, mesh)["a"]
    got = fsdp_specs(_One(torch.empty(shape)), n).a
    assert got == tuple(want)


# -- a world of one rank ------------------------------------------------------


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    inp = _inputs(1)
    return run_world("single", 1, tmp_path_factory.mktemp("single"), inp)[0]["result"]


@pytest.mark.parametrize("name", ["sync", "async"])
@pytest.mark.parametrize("path", ["eager", "scanned"])
def test_world_of_one_equals_single_device_bitwise(one, name, path):
    """SyncDataParallel and AsyncDataParallel(update_scale=1) over a gloo
    group of one rank equal SingleDevice bit for bit (Adam, 5 steps)."""
    key = ("params", "costs") if path == "eager" else ("scan_params", "scan_costs")
    for k in FIELDS:
        assert np.array_equal(one[name][key[0]][k], one["single"][key[0]][k]), k
    assert np.array_equal(np.asarray(one[name][key[1]]), np.asarray(one["single"][key[1]]))


# -- B2's data-parallel composition --------------------------------------------


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """11 steps at avg_every=4 (two exchanges, a 3-step tail) on 2 ranks,
    784→100→10, batch 8 a rank."""
    n = 2
    tree = mlp_numpy_params(seed=21, fan_in=True)
    xs, ys = mlp_numpy_batches(11, n * 8, seed=22)
    inp = {**tree, "xs": xs, "ys": ys}
    ranks = run_world("fused", n, tmp_path_factory.mktemp("fused"), inp,
                      {"lr": 0.1, "avg_every": 4})
    return n, inp, [r["result"] for r in ranks]


def test_fused_async_plain_composition_matches_jax(fused):
    """The plain composition over 2 gloo ranks against JAX
    make_fused_async_epoch_fn (interpret mode) on 2 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distributed_tensorflow_tpu.models.mlp import MLPParams
    from distributed_tensorflow_tpu.ops.pallas_mlp import (
        from_fused,
        make_fused_async_epoch_fn,
        to_fused_stacked,
    )

    n, inp, res = fused
    mesh = _jax_mesh(n)
    run = make_fused_async_epoch_fn(mesh, steps=11, batch_size=8, learning_rate=0.1,
                                    avg_every=4, interpret=True)
    p = MLPParams(*(jnp.asarray(inp[k]) for k in FIELDS))
    state = to_fused_stacked(p, n, NamedSharding(mesh, P("data")))
    xs = jax.device_put(jnp.asarray(inp["xs"]), NamedSharding(mesh, P(None, "data")))
    ys = jax.device_put(jnp.asarray(inp["ys"]), NamedSharding(mesh, P(None, "data")))
    state, costs = run(state, xs, ys)
    for r in range(n):
        # The 3-step tail after the last exchange leaves the copies apart.
        _close(res[r]["fused"], from_fused(jax.tree.map(lambda a, r=r: a[r], state)))
        np.testing.assert_allclose(res[r]["costs"], np.asarray(costs), rtol=RTOL)


def test_fused_async_plain_composition_equals_async_scan(fused):
    """... and the port's AsyncDataParallel(update_scale=1) scanned epoch;
    the plain composition launches nothing."""
    n, _, res = fused
    for r in range(n):
        for k in FIELDS:
            np.testing.assert_allclose(res[r]["fused"][k], res[r]["scan"][k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res[r]["costs"], res[r]["scan_costs"], rtol=RTOL)
        assert not any(res[r]["launches"].values())
        for k in FIELDS:  # on the CPU the kernel composition is the plain one
            assert np.array_equal(res[r]["fused"][k], res[r]["plain"][k])


# -- the weights carried across ------------------------------------------------


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_convert_optimizer_state_round_trip(opt):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLPParams
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.convert import (
        mlp_opt_state_from_numpy,
        mlp_opt_state_to_numpy,
    )
    from distributed_tensorflow_tpu_torch.ops.optim import AdamState

    tree = mlp_numpy_params(hidden=HIDDEN, seed=5)
    p = MLPParams(*(jnp.asarray(tree[k]) for k in FIELDS))
    jopt = joptim.make(opt, 0.01)
    state = jopt.init(p)
    if opt == "adam":
        g = MLPParams(*(jnp.ones_like(a) for a in p))
        _, state = jopt.update(g, state, p)
    got = mlp_opt_state_from_numpy(state, device="cpu")
    back = mlp_opt_state_to_numpy(got)
    if opt == "sgd":
        assert got == () and back == {}
        return
    assert isinstance(got, AdamState) and got.count.dtype == torch.int32 and int(got.count) == 1
    for k in FIELDS:
        assert np.asarray(getattr(state[0].mu, k)).tobytes() == back["mu"][k].tobytes()
        assert np.asarray(getattr(state[0].nu, k)).tobytes() == back["nu"][k].tobytes()


def test_convert_async_stack_and_zero_shards():
    """A JAX async state [n, ...] into each rank's copy and back, and a
    canonical state into a ZeRO rank's slices (a world of one, so the
    slices are the whole)."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.mlp import MLPParams
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.parallel.strategy import AsyncDataParallel, TrainState
    from distributed_tensorflow_tpu_torch.convert import (
        async_rank_state_from_numpy,
        mlp_opt_state_to_numpy,
        mlp_params_to_numpy,
        sharded_state_from_numpy,
        stack_replicas,
    )
    from distributed_tensorflow_tpu_torch.parallel.fsdp import ShardedDataParallel

    n = 4
    tree = mlp_numpy_params(hidden=HIDDEN, seed=6)
    p = MLPParams(*(jnp.asarray(tree[k]) for k in FIELDS))
    jopt = joptim.make("adam", 0.01)
    js = AsyncDataParallel(_jax_mesh(n)).from_canonical(
        TrainState(p, jopt.init(p), jnp.asarray(10, jnp.int32)))
    ranks = [async_rank_state_from_numpy(js.params, js.opt_state, js.step, r, device="cpu")
             for r in range(n)]
    assert all(s.step == (3, 3, 2, 2) for s in ranks)
    back = stack_replicas([mlp_params_to_numpy(s.params) for s in ranks])
    opt_back = stack_replicas([mlp_opt_state_to_numpy(s.opt_state) for s in ranks])
    for k in FIELDS:
        assert back[k].tobytes() == np.asarray(getattr(js.params, k)).tobytes()
    assert np.array_equal(opt_back["count"], np.asarray(js.opt_state[0].count))
    z = ShardedDataParallel(device="cpu")
    zs = sharded_state_from_numpy(z, tree, jopt.init(p), 4)
    assert zs.step == 4 and int(zs.opt_state.count) == 0
    for k in FIELDS:
        assert np.array_equal(getattr(zs.params, k).numpy(), tree[k])


# -- on the card (``-m cuda --noconftest``; skipped without a device) ----------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_world_of_one_over_nccl_equals_single_device_bitwise(tmp_path):
    """World size 1 on the card takes NCCL; sync and async(update_scale=1)
    equal SingleDevice bit for bit, eager and scanned."""
    _cuda_or_skip()
    one = run_world("single", 1, tmp_path, _inputs(1), {"device": "cuda"})[0]["result"]
    assert one["backend"] == "nccl"
    for name in ("sync", "async"):
        for key in ("params", "scan_params"):
            for k in FIELDS:
                assert np.array_equal(one[name][key][k], one["single"][key][k]), (name, key, k)
        assert one[name]["costs"] == one["single"]["costs"]


@pytest.mark.cuda
def test_two_ranks_over_gloo_on_one_card_equal_single_device(tmp_path):
    """Two ranks sharing the card take gloo over CUDA tensors; sync equals
    SingleDevice on the global batch within rtol 1e-6."""
    _cuda_or_skip()
    out = run_world("sync_global", 2, tmp_path, _inputs(2), {"device": "cuda"})
    for r in out:
        res = r["result"]
        assert res["backend"] == "gloo"
        np.testing.assert_allclose(res["sync"]["costs"], res["single"]["costs"], rtol=1e-6)
        for k in FIELDS:
            np.testing.assert_allclose(res["sync"]["params"][k], res["single"]["params"][k],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_fused_async_kernel_composition_matches_its_plain_composition(tmp_path):
    """B2 composed over 2 ranks on the card (a launch a rank a round)
    against the same composition over the plain epoch, within phase 7's
    B2 tolerance of chip_smoke.py (costs within 1e-3 of max(1, |cost|);
    each update within 2e-3 of its largest plus 32 ulp)."""
    _cuda_or_skip()
    tree = mlp_numpy_params(seed=21)
    xs, ys = mlp_numpy_batches(11, 2 * 100, seed=22)
    out = run_world("fused", 2, tmp_path, {**tree, "xs": xs, "ys": ys},
                    {"lr": 0.001, "avg_every": 4, "device": "cuda"})
    for r in out:
        res = r["result"]
        assert res["launches"]["fused_mlp_epoch_dp"] == 3  # rounds 4 + 4 + tail 3
        np.testing.assert_allclose(res["costs"], res["plain_costs"], rtol=0,
                                   atol=1e-3 * max(1.0, np.abs(res["plain_costs"]).max()))
        for k in FIELDS:
            upd = np.abs(res["plain"][k] - tree[k]).max()
            ulp = np.spacing(np.float32(max(np.abs(res["plain"][k]).max(), np.abs(tree[k]).max())))
            assert np.abs(res["fused"][k] - res["plain"][k]).max() <= 2e-3 * upd + 32 * ulp, k
