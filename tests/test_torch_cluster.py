"""PyTorch port, the cluster layer: ``ClusterConfig``, the bootstrap over a
``torch.distributed`` process group, the launcher (``build_strategy``,
``cluster_from_env``, ``run``, ``tools/launch_local.py``), the data
helpers (``DataSet.shard``, ``data/sharded.py``, ``data/prefetch.py``),
placement, and the refusals of what later items bring, each against the
JAX package where it has the same surface."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_dist import REPO, child_env, free_port, run_world
from _torch_parity import mlp_numpy_batches, mlp_numpy_params


# -- ClusterConfig --------------------------------------------------------------


@pytest.mark.parametrize("workers,ps", [
    ((), ()), (("h0:1",), ("p:2",)), (("h0:1", "h1:2", "h2:3"), ("p0:4", "p1:5")),
])
def test_cluster_config_as_jax(workers, ps):
    from distributed_tensorflow_tpu.config import ClusterConfig as JCluster
    from distributed_tensorflow_tpu_torch.config import ClusterConfig

    a, b = ClusterConfig.from_lists(workers, ps), JCluster.from_lists(workers, ps)
    assert (a.worker_svrs, a.ps_svrs) == (b.worker_svrs, b.ps_svrs)
    assert a.num_processes == b.num_processes
    assert a.coordinator_address == b.coordinator_address
    assert [a.is_chief(i) for i in range(3)] == [b.is_chief(i) for i in range(3)]
    assert (a.connect_timeout_s, a.connect_attempts) == (b.connect_timeout_s, b.connect_attempts)
    mod = types.SimpleNamespace(worker_svrs=list(workers), ps_svrs=list(ps))
    assert ClusterConfig.from_settings_module(mod).worker_svrs == \
        JCluster.from_settings_module(mod).worker_svrs
    if len(workers) == 3:
        assert a.subset([2, 0]).worker_svrs == b.subset([2, 0]).worker_svrs
        for bad in ([], [0, 0], [5]):
            with pytest.raises(ValueError) as e1:
                a.subset(bad)
            with pytest.raises(ValueError) as e2:
                b.subset(bad)
            assert str(e1.value) == str(e2.value)


def test_settings_module_copy_and_heartbeat_refusal():
    from distributed_tensorflow_tpu_torch.config import ClusterConfig
    from distributed_tensorflow_tpu_torch.examples import settings

    c = ClusterConfig.from_settings_module(settings)
    assert c.num_processes == 2 and c.coordinator_address == "localhost:2223"
    for kw in (dict(heartbeat_port=7000), dict(heartbeat_host="h")):
        with pytest.raises(NotImplementedError, match="A8"):
            ClusterConfig(**kw)


# -- the bootstrap --------------------------------------------------------------


def test_define_flags_as_jax():
    from distributed_tensorflow_tpu.cluster import define_flags as jflags
    from distributed_tensorflow_tpu_torch.cluster import define_flags

    for argv in ([], ["--job_name=ps", "--task_index=1"], ["--task_index", "3"]):
        assert vars(define_flags().parse_args(argv)) == vars(jflags().parse_args(argv))
    with pytest.raises(SystemExit):
        define_flags().parse_args(["--job_name=chief"])


def test_ps_task_is_a_no_op():
    """A ps task prints the reference's first line and the reason it has
    nothing to serve, and returns a context that should exit."""
    from distributed_tensorflow_tpu.cluster import bootstrap as jboot
    from distributed_tensorflow_tpu.config import ClusterConfig as JCluster
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.config import ClusterConfig

    lines, jlines = [], []
    ctx = bootstrap(ClusterConfig.from_lists(["a:1", "b:2"], ["p:3"]), "ps", 0,
                    print_fn=lines.append)
    jctx = jboot(JCluster.from_lists(["a:1", "b:2"], ["p:3"]), "ps", 0, print_fn=jlines.append)
    assert len(lines) == len(jlines) == 2 and lines[0] == jlines[0] == "ps setting up ..."
    assert "no-op" in lines[1] and lines[1].endswith("exiting cleanly.")
    assert (ctx.should_exit, ctx.is_ps, ctx.is_chief, ctx.num_processes) == \
        (jctx.should_exit, jctx.is_ps, jctx.is_chief, jctx.num_processes)
    ctx.close()


def test_single_worker_bootstrap_joins_no_group():
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.config import ClusterConfig

    lines = []
    ctx = bootstrap(ClusterConfig.from_lists(["a:1"]), "worker", 0, print_fn=lines.append)
    assert lines == ["worker setting up ..."] and ctx.is_chief and not ctx.joined
    assert not dist.is_initialized()


@pytest.mark.parametrize("kw,env", [
    (dict(heartbeat_port=7000), {}), ({}, {"DTF_JOURNAL_DIR": "/tmp/j"}),
], ids=["heartbeat", "journal"])
def test_bootstrap_refusals_name_a8(kw, env, monkeypatch, tmp_path):
    """The heartbeat is refused naming A8c. ``DTF_JOURNAL_DIR``, refused
    until the observability slice, now arms the worker's per-rank journal
    as the JAX bootstrap does: ``events-rank<k>.jsonl`` under its original
    rank (``DTF_WORKER_RANKS`` maps a renumbered member back), announced
    by a ``worker_start`` event."""
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.config import ClusterConfig

    if "DTF_JOURNAL_DIR" not in env:
        with pytest.raises(NotImplementedError, match="A8c"):
            bootstrap(ClusterConfig.from_lists(["a:1", "b:2"]), "worker", 0,
                      print_fn=lambda s: 0, **kw)
        return
    monkeypatch.setenv("DTF_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setenv("DTF_RUN_ID", "r1")
    try:
        ctx = bootstrap(ClusterConfig.from_lists(["a:1"]), "worker", 0, print_fn=lambda s: 0)
        assert ctx.is_chief and not ctx.joined
        obs.emit("step", step=1)
        monkeypatch.setenv("DTF_WORKER_RANKS", "3,1")
        bootstrap(ClusterConfig.from_lists(["a:1"]), "worker", 0, print_fn=lambda s: 0)
    finally:
        obs.configure()
    assert sorted(os.listdir(tmp_path)) == ["events-rank0.jsonl", "events-rank3.jsonl"]
    evs = obs.read_events(str(tmp_path / "events-rank0.jsonl"))
    assert [e["kind"] for e in evs] == ["worker_start", "step"]
    assert all(e["rank"] == 0 and e["run"] == "r1" for e in evs)
    assert evs[0]["pid"] == os.getpid()
    (ev,) = obs.read_events(str(tmp_path / "events-rank3.jsonl"))
    assert ev["kind"] == "worker_start" and ev["rank"] == 3


def test_bounded_initialize_retries_then_raises():
    from distributed_tensorflow_tpu_torch.cluster import BootstrapError, bounded_initialize
    from distributed_tensorflow_tpu_torch.config import ClusterConfig

    calls, sleeps, lines = [], [], []

    def fail(init_method, world_size, rank, **kw):
        calls.append((init_method, world_size, rank, kw["timeout_s"]))
        raise RuntimeError("rendezvous timed out")

    with pytest.raises(BootstrapError, match="tcp://h0:9 .process 1/2. failed after 3"):
        bounded_initialize(ClusterConfig.from_lists(["h0:9", "h1:9"]), 1, timeout_s=5,
                           attempts=3, initialize_fn=fail, sleep=sleeps.append,
                           print_fn=lines.append)
    assert calls == [("tcp://h0:9", 2, 1, 5)] * 3 and sleeps == [1.0, 2.0]
    assert len(lines) == 2 and "attempt 1/3" in lines[0]


@pytest.fixture(scope="module")
def boot(tmp_path_factory):
    tree = mlp_numpy_params(hidden=8, seed=12)
    xs, ys = mlp_numpy_batches(1, 16, seed=13)
    out = run_world("bootstrap", 2, tmp_path_factory.mktemp("boot"), {**tree, "xs": xs, "ys": ys},
                    {"port": free_port()})
    return [r["result"] for r in out]


def test_two_processes_bootstrap_over_tcp_and_take_a_sync_step(boot):
    """cluster.bootstrap over tcp://127.0.0.1:<free port>: a gloo group of
    2 (the CPU), the chief is rank 0, one sync step leaves both ranks with
    the same parameters, and close() leaves the group."""
    a, b = boot
    assert (a["rank"], b["rank"], a["size"], a["backend"]) == (0, 1, 2, "gloo")
    assert a["is_chief"] and not b["is_chief"]
    assert [a["lines"], b["lines"]] == [
        ["worker setting up ...", f"data parallel: rank {r} of 2 on cpu over gloo"]
        for r in (0, 1)]
    assert a["costs"] == b["costs"]
    for k in ("w1", "b1", "w2", "b2"):
        assert np.array_equal(a["params"][k], b["params"][k])
    assert a["closed"] and b["closed"]


# -- the launcher ---------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(), dict(sync=False, async_avg_every=5), dict(dp_mode="zero"),
    dict(sync=False, dp_mode="zero"), dict(dp_mode="mesh"),
], ids=["sync", "async", "zero", "zero-async", "unknown"])
def test_build_strategy_mapping_and_errors_as_jax(cfg):
    """Over 2 devices/ranks, the same strategy class (and avg_every) or the
    same error, word for word; one device/rank gives SingleDevice."""
    import jax

    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.launch import build_strategy as jbuild
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_strategy
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    world = Mesh({"data": 2, "model": 1}, 0, torch.device("cpu"))  # the layout only; no step runs
    try:
        want = jbuild(JConfig(**cfg), devices=jax.devices()[:2])
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            build_strategy(TrainConfig(**cfg), mesh=world)
        assert str(got.value) == str(exc)
        return
    got = build_strategy(TrainConfig(**cfg), mesh=world)
    assert type(got).__name__ == type(want).__name__
    assert got.num_replicas == want.num_replicas == 2
    assert getattr(got, "avg_every", None) == getattr(want, "avg_every", None)
    single = build_strategy(TrainConfig(**cfg), device="cpu")
    assert type(single).__name__ == type(jbuild(JConfig(**cfg), devices=jax.devices()[:1])).__name__


@pytest.mark.parametrize("env", [
    {}, {"DTF_WORLD_SIZE": "2"}, {"DTF_WORKER_RANKS": "2,0"},
    {"DTF_WORLD_SIZE": "2", "DTF_WORKER_RANKS": "1,2"}, {"DTF_WORLD_SIZE": "3",
                                                          "DTF_WORKER_RANKS": "1,2"},
    {"DTF_WORKER_RANKS": "a,b"}, {"DTF_WORLD_SIZE": "0"}, {"DTF_HEARTBEAT_PORT": "0"},
    {"DTF_HEARTBEAT_TIMEOUT_MS": "250"},
])
def test_cluster_from_env_as_jax(env, monkeypatch):
    from distributed_tensorflow_tpu.config import ClusterConfig as JCluster
    from distributed_tensorflow_tpu.launch import cluster_from_env as jfrom
    from distributed_tensorflow_tpu_torch.config import ClusterConfig
    from distributed_tensorflow_tpu_torch.launch import cluster_from_env

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    hosts = ["h0:1", "h1:1", "h2:1"]
    try:
        want = jfrom(JCluster.from_lists(hosts))
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            cluster_from_env(ClusterConfig.from_lists(hosts))
        assert str(got.value) == str(exc)
        return
    got = cluster_from_env(ClusterConfig.from_lists(hosts))
    assert got.worker_svrs == want.worker_svrs
    assert got.heartbeat_timeout_ms == want.heartbeat_timeout_ms


@pytest.mark.parametrize("raw", ["0,1", "3", "2,0,1", "x", "1,,2"])
def test_parse_worker_ranks_as_jax(raw):
    from distributed_tensorflow_tpu.launch import parse_worker_ranks as jparse
    from distributed_tensorflow_tpu_torch.launch import parse_worker_ranks

    try:
        want = jparse(raw)
    except ValueError as exc:
        with pytest.raises(ValueError, match="DTF_WORKER_RANKS") as got:
            parse_worker_ranks(raw)
        assert str(got.value) == str(exc)
        return
    assert parse_worker_ranks(raw) == want


def test_heartbeat_from_env_names_a8(monkeypatch):
    from distributed_tensorflow_tpu_torch.launch import cluster_from_env

    monkeypatch.setenv("DTF_HEARTBEAT_PORT", "7000")
    with pytest.raises(NotImplementedError, match="A8"):
        cluster_from_env()


def _launch(tmp_path, workers, ps, extra=()):
    return subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.tools.launch_local",
         "--workers", str(workers), "--ps", str(ps), "--logdir", str(tmp_path / "logs"), *extra,
         "--", *LAUNCH_CMD(tmp_path)],
        env=child_env(), capture_output=True, text=True, timeout=120, cwd=REPO)


def LAUNCH_CMD(tmp_path):
    return [sys.executable, os.path.join(REPO, "tests", "_torch_dist.py"), "task", str(tmp_path)]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """launch.run through launch_local: 2 workers and 1 ps on the CPU, sync
    DP, 1 epoch of 260 rows at batch 10 a worker."""
    d = tmp_path_factory.mktemp("launch")
    rng = np.random.default_rng(9)
    np.savez(d / "inputs.npz", train_x=rng.random((260, 784), dtype=np.float32),
             train_y=np.eye(10, dtype=np.float32)[rng.integers(0, 10, 260)],
             test_x=rng.random((50, 784), dtype=np.float32),
             test_y=np.eye(10, dtype=np.float32)[rng.integers(0, 10, 50)])
    with open(d / "args.json", "w") as f:
        json.dump({"port": free_port(), "workers": 2,
                   "config": dict(epochs=1, batch_size=10, log_frequency=5,
                                  learning_rate=0.05)}, f)
    proc = _launch(d, 2, 1)
    logs = {n: (d / "logs" / f"{n}.log").read_text() for n in ("ps0", "worker0", "worker1")}
    return proc, logs


def test_launch_local_runs_the_reference_topology(launched):
    proc, logs = launched
    assert proc.returncode == 0, (proc.stdout, proc.stderr, logs)
    assert "ps0: exit 0" in proc.stdout and "worker1: exit 0" in proc.stdout
    assert logs["ps0"].splitlines()[0] == "ps setting up ..."
    w0, w1 = logs["worker0"], logs["worker1"]
    for line in ("worker setting up ...", "Ready to go", "Step: 5,  Epoch:  1,  Batch:   5 of  13"):
        assert line in w0 and line in w1
    assert "data parallel: rank 0 of 2 on cpu over gloo" in w0
    assert "data parallel: rank 1 of 2 on cpu over gloo" in w1
    for line in ("Test-Accuracy:", "Final Cost:", "Done"):
        assert line in w0 and line not in w1
    r0 = json.loads(w0.split("RESULT ")[1].splitlines()[0])
    r1 = json.loads(w1.split("RESULT ")[1].splitlines()[0])
    assert r0["global_step"] == r1["global_step"] == 13
    assert r0["final_cost"] == r1["final_cost"]


def test_launch_local_fails_when_a_worker_fails(tmp_path):
    cmd = [sys.executable, "-c",
           "import sys; sys.exit(3 if '--task_index=1' in sys.argv else 0)"]
    from distributed_tensorflow_tpu_torch.tools.launch_local import launch

    lines = []
    rc = launch(cmd, 2, 1, str(tmp_path / "logs"), print_fn=lines.append)
    assert rc == 1 and "worker1: exit 3" in lines and "ps0: exit 0" in lines
    assert launch(cmd[:2] + ["pass"], 2, 0, str(tmp_path / "ok"), print_fn=lines.append) == 0


@pytest.mark.parametrize("flag", ["--max-restarts=1", "--heartbeat-port=7000", "--min-workers=1"])
def test_launch_local_elastic_flags_name_a8(flag):
    from distributed_tensorflow_tpu_torch.tools.launch_local import main

    with pytest.raises(NotImplementedError, match="A8"):
        main(["--workers", "2", flag, "--", "true"])


# -- data and placement -------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 3])
def test_dataset_shard_equals_jax(shards):
    from distributed_tensorflow_tpu.data.mnist import DataSet as JDataSet
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet
    from distributed_tensorflow_tpu_torch.data.sharded import local_shard_for_process
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(4)
    x = rng.random((301, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 301)]
    for i in range(shards):
        a, b = DataSet(x, y, seed=5).shard(shards, i), JDataSet(x, y, seed=5).shard(shards, i)
        assert np.array_equal(a.images, b.images) and a.num_examples == b.num_examples
        for _ in range(3):
            (ax, ay), (bx, by) = a.next_batch(40), b.next_batch(40)
            assert np.array_equal(ax, bx) and np.array_equal(ay, by)
        world = Mesh({"data": shards, "model": 1}, i, torch.device("cpu"))
        assert np.array_equal(local_shard_for_process(DataSet(x, y), world).images, a.images)


def test_global_batch_keeps_this_ranks_rows():
    from distributed_tensorflow_tpu_torch.data.sharded import global_batch
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    x, y = np.arange(24, dtype=np.float32).reshape(12, 2), np.arange(12, dtype=np.float32)
    for r in range(3):
        bx, by = global_batch(Mesh({"data": 3, "model": 1}, r, torch.device("cpu")), x, y)
        assert bx.tolist() == x[4 * r:4 * r + 4].tolist() and by.tolist() == y[4 * r:4 * r + 4].tolist()
    with pytest.raises(ValueError, match="does not split"):
        global_batch(Mesh({"data": 5, "model": 1}, 0, torch.device("cpu")), x, y)
    from distributed_tensorflow_tpu_torch.parallel.mesh import (
        batch_sharded,
        replicated,
        stacked_per_device,
    )

    w = Mesh({"data": 4, "model": 1}, 2, torch.device("cpu"))
    assert (replicated(w), batch_sharded(w, 8), stacked_per_device(w)) == \
        (slice(None), slice(4, 6), slice(2, 3))


@pytest.mark.parametrize("depth,steps", [(1, 5), (2, 5), (4, 3)])
def test_prefetch_yields_the_same_batches_in_order(depth, steps):
    from distributed_tensorflow_tpu.data.prefetch import prefetch_batches as jpre
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch_batches

    rng = np.random.default_rng(2)
    x = rng.random((50, 4), dtype=np.float32)
    placed = []
    got = list(prefetch_batches(DataSet(x, x, seed=1).next_batch, 8, steps,
                                lambda a, b: (placed.append(1), torch.from_numpy(a))[1],
                                depth=depth))
    want = list(jpre(DataSet(x, x, seed=1).next_batch, 8, steps, lambda a, b: a, depth=depth))
    assert len(got) == steps == len(placed)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="depth"):
        list(prefetch_batches(None, 8, 1, None, depth=0))


def test_prefetch_trainer_equals_the_plain_loop():
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import build_trainer

    rng = np.random.default_rng(3)
    x = rng.random((200, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 200)]
    res = []
    for prefetch in (0, 3):
        ds = Datasets(DataSet(x, y, seed=1), DataSet(x[:5], y[:5]), DataSet(x[:50], y[:50]))
        tr = build_trainer(TrainConfig(epochs=2, batch_size=20, prefetch=prefetch,
                                       compute_dtype="float32", scan_epoch=False),
                           datasets=ds, device="cpu", print_fn=lambda *a: None)
        res.append((tr.run(), [t.clone() for t in tr.state.params]))
    assert res[0][0] == res[1][0]
    assert all(torch.equal(a, b) for a, b in zip(res[0][1], res[1][1]))


def test_placement_lines_as_jax():
    """describe renders the JAX lines: leaves replicated over 2
    devices, a ZeRO layout's specs, and log_placement on the chief only."""
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu.utils.placement import describe as jdescribe
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.utils import placement

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distributed_tensorflow_tpu.parallel import make_mesh

    mesh = make_mesh(devices=jax.devices()[:2])
    jp = jax.device_put(JMLP(hidden_dim=8).init(1), NamedSharding(mesh, P()))
    tp = MLP(hidden_dim=8).init(1, device="cpu")
    want = jdescribe(jp, print_fn=lambda s: None)
    assert placement.describe(tp, mesh=Mesh({"data": 2, "model": 1}, 0, None),
                              print_fn=lambda s: None) == want
    specs = type(tp)(("data",), ("data",), (None, "data"), ())
    lines = placement.describe(tp, specs=specs, mesh=Mesh({"data": 2, "model": 1}, 0, None),
                               print_fn=lambda s: None)
    assert lines[0] == ".w1: shape=(1568, 8) dtype=float32 spec=PartitionSpec('data',) devices=2"
    assert lines[2].endswith("spec=PartitionSpec(None, 'data') devices=2")
    # Async: a copy a rank, stacked as the JAX state's leading axis.
    jstack = jax.device_put(jax.tree.map(lambda a: jnp.stack([a, a]), JMLP(hidden_dim=8).init(1)),
                            NamedSharding(mesh, P("data")))
    stacked = placement.describe(tp, specs=type(tp)(*([("data",)] * 4)),
                                 mesh=Mesh({"data": 2, "model": 1}, 0, None), stacked=True,
                                 print_fn=lambda s: None)
    assert stacked == jdescribe(jstack, print_fn=lambda s: None)
    placement.assert_sharded_over(specs, "data")
    with pytest.raises(AssertionError, match="no leaf"):
        placement.assert_sharded_over(type(tp)((), (), (), ()), "data")
    placement.assert_replicated(tp, Mesh({"data": 1, "model": 1}, 0, torch.device("cpu")))
    rng = np.random.default_rng(0)
    x = rng.random((40, 784), dtype=np.float32)
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets

    for chief in (True, False):
        out = []
        build_trainer(TrainConfig(epochs=1, log_placement=True), context=_Ctx(chief),
                      datasets=Datasets(DataSet(x, x[:, :10]), DataSet(x, x[:, :10]),
                                        DataSet(x, x[:, :10])),
                      device="cpu", print_fn=out.append)
        assert (out[:1] == [".w1: shape=(784, 100) dtype=float32 spec=PartitionSpec() "
                            "devices=1"]) == chief and (not out) == (not chief)


class _Ctx:
    def __init__(self, is_chief):
        self.is_chief = is_chief


# -- the config and the refusals ----------------------------------------------


def test_lifted_fields_keep_the_jax_defaults():
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu_torch.config import TrainConfig

    a, b = TrainConfig(), JConfig()
    for f in ("sync", "async_avg_every", "dp_mode", "per_worker_epoch", "model", "param_dtype",
              "prefetch", "log_placement"):
        assert getattr(a, f) == getattr(b, f), f
    c = TrainConfig(sync=False, async_avg_every=50, dp_mode="zero", per_worker_epoch=True,
                    prefetch=2, log_placement=True, param_dtype="float32", model="mlp")
    assert (c.sync, c.async_avg_every, c.dp_mode, c.per_worker_epoch) == (False, 50, "zero", True)


def _mlp_specs():
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    return MLP().partition_specs()


@pytest.mark.parametrize("make,item", [
    (lambda: __import__("distributed_tensorflow_tpu_torch.models.cnn", fromlist=["x"]).CNN(
        ).partition_specs(), None),
    (lambda: __import__("distributed_tensorflow_tpu_torch.config", fromlist=["x"]).TrainConfig(
        dp_mode="diloco"), None),
    (lambda: __import__("distributed_tensorflow_tpu_torch.config", fromlist=["x"]).TrainConfig(
        dp_mode="tp"), None),
    (lambda: __import__("distributed_tensorflow_tpu_torch.parallel.strategy",
                        fromlist=["x"]).SyncDataParallel(device="cpu",
                                                         param_specs=_mlp_specs()), None),
    (lambda: __import__("distributed_tensorflow_tpu_torch.parallel.strategy",
                        fromlist=["x"]).AsyncDataParallel(device="cpu").make_exchange_fn("ring"),
     callable),
    (lambda: __import__("distributed_tensorflow_tpu_torch.parallel.fsdp",
                        fromlist=["x"]).ShardedDataParallel(device="cpu",
                                                            param_specs=_mlp_specs()), None),
], ids=["cnn", "diloco", "tp", "param_specs", "ring", "zero-tp"])
def test_refusals_name_their_items(make, item):
    """Each refusal names its ROADMAP item (the parallel layouts now name
    A7c-A7d, which the match on "A7" takes). Once refused and now built:
    the ring exchange (its exchange function), the CNN's tensor-parallel
    layout, ``dp_mode="tp"``, ``dp_mode="diloco"`` (the local-SGD slice) and
    the strategies' ``param_specs`` over the default mesh's ``model`` axis
    of one rank."""
    if item is callable:
        assert callable(make())
        return
    if item is None:
        assert make() is not None
        return
    with pytest.raises(NotImplementedError, match=item):
        make()


def test_dtf_model_env(monkeypatch):
    from distributed_tensorflow_tpu_torch.launch import config_from_env

    monkeypatch.setenv("DTF_MODEL", "mlp")
    assert config_from_env().model == "mlp"
    monkeypatch.setenv("DTF_MODEL", "transformer")
    assert config_from_env().model == "transformer"


def test_pallas_engine_refuses_a_dp_strategy_with_the_jax_wording():
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.parallel.strategy import AsyncDataParallel
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    x = np.zeros((40, 784), np.float32)
    ds = Datasets(DataSet(x, x[:, :10]), DataSet(x, x[:, :10]), DataSet(x, x[:, :10]))
    tr = Trainer(MLP(), ds, TrainConfig(epochs=1, compiled_run=True, engine="pallas"),
                 strategy=AsyncDataParallel(device="cpu"), is_chief=False,
                 print_fn=lambda *a: None)
    _build.reset_launches()
    with pytest.raises(ValueError, match="strategy AsyncDataParallel .need SingleDevice; use "
                                         "ops.fused_mlp.make_fused_async_epoch_fn for DP."):
        tr.run()
    assert not any(_build.LAUNCHES.values())
