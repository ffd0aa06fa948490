"""Worlds of ranks for the port's data-parallel tests.

The parent side (:func:`run_world`) starts N processes of this file, one a
rank, which join a gloo process group on the CPU through a ``file://``
rendezvous in the test's temporary directory, run one named group of
cases (``CASES``) on the inputs the test wrote (``inputs.npz``), and
pickle their results to ``rank<r>.pkl``. The whole world runs under one
timeout (at most 120 s), after which every child is killed, so no hang
can outlast it.

The children import ``torch`` and the port only: never ``jax``, the JAX
package or ``tests/conftest.py`` (each result records whether ``jax``
was loaded). The JAX side of each comparison runs in the test process.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD_TIMEOUT_S = 120


# -- the parent side ----------------------------------------------------------


def free_port() -> int:
    """A port free on 127.0.0.1 now (bound to 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, HERE])
    env["OMP_NUM_THREADS"] = "1"
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "DTF_JOURNAL_DIR"):
        env.pop(k, None)
    return env


def run_world(case: str, n: int, tmp_path, inputs: dict | None = None, args: dict | None = None,
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """Run ``CASES[case]`` on ``n`` ranks; returns each rank's result.
    Raises with the children's output when one fails or the world
    outlives ``timeout``."""
    d = str(tmp_path)
    np.savez(os.path.join(d, "inputs.npz"), **(inputs or {}))
    with open(os.path.join(d, "args.json"), "w") as f:
        json.dump(args or {}, f)
    procs = []
    for r in range(n):
        log = open(os.path.join(d, f"rank{r}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(n), d],
            stdout=log, stderr=subprocess.STDOUT, env=child_env()), log))
    deadline = time.time() + timeout
    expired = False
    for p, log in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            expired = True
            break
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    logs = "\n".join(
        f"--- rank {r} (exit {p.returncode}) ---\n" + _tail(os.path.join(d, f"rank{r}.log"))
        for r, (p, _) in enumerate(procs))
    if expired:
        raise RuntimeError(f"world {case!r} of {n} ranks outlived {timeout}s\n{logs}")
    if any(p.returncode for p, _ in procs):
        raise RuntimeError(f"world {case!r} of {n} ranks failed\n{logs}")
    out = []
    for r in range(n):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


_ONCE: dict = {}


def run_world_once(case: str, n: int, tmp_path_factory, inputs: dict | None = None,
                   args: dict | None = None, timeout: float = WORLD_TIMEOUT_S) -> list:
    """:func:`run_world`, once a test session: under pytest-xdist the first
    worker to ask runs the world (holding a file lock in the session's
    shared temporary directory) and the others read its pickled results,
    so a module fixture's world does not run again in every worker that
    takes one of the module's tests (nor, in one process, for every module
    that asks)."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):  # one process: memoized here
        if (case, n) not in _ONCE:
            _ONCE[case, n] = run_world(case, n, tmp_path_factory.mktemp(f"{case}{n}"), inputs,
                                       args, timeout)
        return _ONCE[case, n]
    import filelock

    out = tmp_path_factory.getbasetemp().parent / f"world-{case}-{n}.pkl"
    with filelock.FileLock(f"{out}.lock"):
        if out.is_file():
            return pickle.loads(out.read_bytes())
        res = run_world(case, n, tmp_path_factory.mktemp(f"{case}{n}"), inputs, args, timeout)
        out.write_bytes(pickle.dumps(res))
        return res


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


# -- the child side -----------------------------------------------------------


def _np(tree):
    """Tensors (and trees of them) → numpy, for the pickle."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    return tree


def _params(inp, device="cpu"):
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy

    return mlp_params_from_numpy({k: inp[k] for k in ("w1", "b1", "w2", "b2")}, device=device)


def _model(inp):
    import torch

    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    return MLP(hidden_dim=inp["w1"].shape[1], compute_dtype=torch.float32)


def _drive(strategy, model, opt, params, xs, ys):
    """Eager steps over the staged global batches ``xs`` [steps, N·b, ...]
    from ``params``; returns (state, costs)."""
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy

    from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState

    state = strategy.from_canonical(TrainState(params, opt.init(params), 0))
    step = strategy.make_train_step(model, cross_entropy, opt)
    costs = []
    for x, y in zip(xs, ys):
        state, c = step(state, *strategy.prepare_batch(x, y))
        costs.append(strategy.cost_scalar(c))
    return state, costs


def case_strategies(world, inp, args):
    """Sync (bucket and per leaf, SGD and Adam), ZeRO (SGD and Adam), async
    (divergence, exchange, eval, canonical forms, the scanned epoch) and
    the merge refusal, each from the same parameters and batches."""
    import torch

    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.fsdp import ShardedDataParallel
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        AsyncDataParallel,
        SyncDataParallel,
        TrainState,
        merge_replica_leaf,
    )

    model, xs, ys = _model(inp), inp["xs"], inp["ys"]
    res = {}
    for name, strat, opt in (
        ("sync_sgd", SyncDataParallel(world), optim.sgd(0.05)),
        ("sync_explicit", SyncDataParallel(world, explicit_collectives=True), optim.sgd(0.05)),
        ("sync_adam", SyncDataParallel(world), optim.adam(0.01)),
        ("zero_sgd", ShardedDataParallel(world), optim.sgd(0.05)),
        ("zero_adam", ShardedDataParallel(world), optim.adam(0.01)),
    ):
        state, costs = _drive(strat, model, opt, _params(inp), xs, ys)
        canon = strat.to_canonical(state)
        res[name] = dict(params=_np(canon.params), costs=costs, step=strat.global_step(state),
                         opt=_np(canon.opt_state))
        if name.startswith("zero"):
            res[name]["shards"] = _np(state.params)
            res[name]["opt_shards"] = _np(state.opt_state)
            res[name]["specs"] = [list(s) for s in strat._specs]
            res[name]["eval"] = float(strat.make_eval_fn(model)(
                state, torch.from_numpy(xs[0]), torch.from_numpy(ys[0])))

    # Async: diverge for 3 steps, measure, exchange, measure.
    strat = AsyncDataParallel(world)
    opt = optim.momentum(0.05)
    state, costs = _drive(strat, model, opt, _params(inp), xs[:3], ys[:3])
    div = strat.make_divergence_fn()
    acc = strat.make_eval_fn(model)(state, torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
    canon = strat.to_canonical(state)
    after = strat.make_exchange_fn()(state)
    res["async"] = dict(
        params=_np(state.params), costs=costs, step=state.step,
        global_step=strat.global_step(state), divergence=float(div(state)),
        eval=float(acc), canonical=_np(canon.params), canonical_opt=_np(canon.opt_state),
        canonical_step=canon.step, exchanged=_np(after.params),
        divergence_after=float(div(after)),
        spread=strat.from_canonical(TrainState(canon.params, canon.opt_state, 7)).step,
    )
    # The async scanned epoch: avg_every 2 over 5 staged steps.
    strat = AsyncDataParallel(world, avg_every=2)
    opt = optim.sgd(0.05)
    fn = strat.make_scanned_train_fn(model, cross_entropy, opt)
    p = _params(inp)
    state, costs = fn(TrainState(p, opt.init(p), (0,) * world.size),
                      torch.from_numpy(xs), torch.from_numpy(ys))
    res["async_scan"] = dict(params=_np(state.params), costs=costs.numpy(), step=state.step)
    # Integer leaves that differ across the ranks refuse to merge.
    try:
        merge_replica_leaf(torch.tensor(world.rank, dtype=torch.int32), world)
        res["merge_refused"] = ""
    except ValueError as exc:
        res["merge_refused"] = str(exc)
    return res


def case_single(world, inp, args):
    """A world of one rank: sync and async(update_scale=1) against
    SingleDevice, eager and scanned."""
    import torch

    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        AsyncDataParallel,
        SingleDevice,
        SyncDataParallel,
        TrainState,
    )

    model, xs, ys = _model(inp), inp["xs"], inp["ys"]
    dev = world.device
    res = {}
    for name, strat in (("single", SingleDevice(dev)), ("sync", SyncDataParallel(world)),
                        ("async", AsyncDataParallel(world, avg_every=2, update_scale=1))):
        opt = optim.adam(0.01)
        state, costs = _drive(strat, model, opt, _params(inp, dev), xs, ys)
        fn = strat.make_scanned_train_fn(model, cross_entropy, opt)
        p = _params(inp, dev)
        s2, c2 = fn(strat.from_canonical(TrainState(p, opt.init(p), 0)),
                    torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev))
        res[name] = dict(params=_np(state.params), costs=costs, scan_params=_np(s2.params),
                         scan_costs=_np(c2))
    res["backend"] = world.backend
    return res


def case_sync_global(world, inp, args):
    """Sync over the world against SingleDevice on the global batch, both
    on the world's device (5 SGD steps)."""
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice, SyncDataParallel

    model, dev = _model(inp), world.device
    out = {"backend": world.backend}
    for name, strat in (("single", SingleDevice(dev)), ("sync", SyncDataParallel(world))):
        state, costs = _drive(strat, model, optim.sgd(0.05), _params(inp, dev),
                              inp["xs"], inp["ys"])
        out[name] = dict(params=_np(state.params), costs=costs)
    return out


def case_trainer(world, inp, args):
    """The Trainer on each path and mode of ``args["runs"]``: its printed
    lines, result and final (canonical) parameters."""
    import torch

    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import build_strategy, build_trainer
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState

    res = {}
    for run in args["runs"]:
        name, cfg = run["name"], dict(run["config"])
        ds = Datasets(train=DataSet(inp["train_x"], inp["train_y"], seed=1),
                      validation=DataSet(inp["test_x"][:10], inp["test_y"][:10], seed=3),
                      test=DataSet(inp["test_x"], inp["test_y"], seed=2))
        config = TrainConfig(compute_dtype="float32", **cfg)
        strategy = build_strategy(config, mesh=world)
        model = _model(inp)
        if run.get("compiled_unshuffled"):
            # The whole run without a shuffle: the rows in dataset order.
            opt = optim.sgd(config.learning_rate)
            fn = strategy.make_compiled_run_fn(
                model, cross_entropy, opt, batch_size=config.batch_size * world.size,
                epochs=config.epochs, shuffle=False)
            p = _params(inp)
            state, met = fn(strategy.from_canonical(TrainState(p, opt.init(p), 0)),
                            *(torch.from_numpy(inp[k]) for k in
                              ("train_x", "train_y", "test_x", "test_y")), torch.Generator())
            res[name] = dict(costs=met["costs"].numpy(), accuracy=met["accuracy"].numpy(),
                             params=_np(strategy.to_canonical(state).params),
                             step=strategy.global_step(state))
            continue
        lines = []
        tr = build_trainer(config, datasets=ds, strategy=strategy, model=model,
                           print_fn=lines.append, device="cpu",
                           context=_Ctx(world.rank == 0))
        tr.state = strategy.from_canonical(TrainState(
            _params(inp), tr.optimizer.init(_params(inp)), 0))
        out = tr.run()
        res[name] = dict(lines=lines, result=out, history=tr.history,
                         params=_np(strategy.to_canonical(tr.state).params),
                         scanned=tr._indexed_fn is not None)
    return res


class _Ctx:
    def __init__(self, is_chief):
        self.is_chief = is_chief


def case_fused(world, inp, args):
    """B2's data-parallel composition (its plain version on the CPU)
    against AsyncDataParallel(update_scale=1)'s scanned epoch."""
    import torch

    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import AsyncDataParallel, TrainState

    dev = world.device
    xs, ys = torch.from_numpy(inp["xs"]).to(dev), torch.from_numpy(inp["ys"]).to(dev)
    steps, gb, in_dim = xs.shape
    hidden, out = inp["w2"].shape
    kw = dict(steps=steps, batch_size=gb // world.size, in_dim=in_dim, hidden_dim=hidden,
              out_dim=out, learning_rate=args["lr"], avg_every=args["avg_every"])
    _build.reset_launches()
    state, costs = fm.make_fused_async_epoch_fn(world, **kw)(
        fm.to_fused_stacked(_params(inp, dev), world), xs, ys)
    launches = dict(_build.LAUNCHES)
    plain, plain_costs = fm.make_fused_async_epoch_fn(world, plain=True, **kw)(
        fm.to_fused_stacked(_params(inp, dev), world), xs, ys)
    strat = AsyncDataParallel(world, avg_every=args["avg_every"], update_scale=1)
    opt = optim.sgd(args["lr"])
    fn = strat.make_scanned_train_fn(_model(inp), cross_entropy, opt)
    p = _params(inp, dev)
    s2, c2 = fn(TrainState(p, opt.init(p), (0,) * world.size), xs, ys)
    return dict(fused=_np(fm.from_fused(state)), costs=_np(costs), launches=launches,
                plain=_np(fm.from_fused(plain)), plain_costs=_np(plain_costs),
                scan=_np(s2.params), scan_costs=_np(c2))


def case_bootstrap(world, inp, args):
    """Two processes bootstrapping over tcp://127.0.0.1:<port> through
    ``cluster.bootstrap``, then one sync step."""
    import torch

    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.config import ClusterConfig
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from distributed_tensorflow_tpu_torch.parallel.strategy import SyncDataParallel

    rank = args["rank"]
    port = args["port"]
    cluster = ClusterConfig(worker_svrs=(f"127.0.0.1:{port}", f"127.0.0.1:{port + 1}"),
                            connect_timeout_s=60, connect_attempts=2)
    lines = []
    ctx = bootstrap(cluster, "worker", rank, device="cpu", print_fn=lines.append)
    world = make_mesh(device="cpu")
    strat = SyncDataParallel(world)
    state, costs = _drive(strat, _model(inp), optim.sgd(0.05), _params(inp),
                          inp["xs"][:1], inp["ys"][:1])
    ctx.close()
    return dict(lines=lines, is_chief=ctx.is_chief, size=world.size, rank=world.rank,
                backend=world.backend, params=_np(state.params), costs=costs,
                closed=not torch.distributed.is_initialized())


def case_classifiers(world, inp, args):
    """Each classifier family of ``args["families"]`` (name → registry
    name, constructor keywords; f32) under sync and ZeRO, 3 SGD steps from
    the same parameters (``<family>/<field>`` in the inputs); then the
    first family one async step, served by ``Predictor.from_state``
    through the strategy against the strategy's eval."""
    import torch

    from distributed_tensorflow_tpu_torch.convert import params_from_numpy
    from distributed_tensorflow_tpu_torch.inference import Predictor
    from distributed_tensorflow_tpu_torch.models import build_model
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.fsdp import ShardedDataParallel
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        AsyncDataParallel,
        SyncDataParallel,
    )

    xs, ys = inp["xs"], inp["ys"]
    res = {}
    for fam, (name, kw) in args["families"].items():
        model = build_model(name, compute_dtype=torch.float32, **kw)
        cls = type(model.init(1, device="cpu"))
        tree = {k: inp[f"{fam}/{k}"] for k in cls._fields}
        res[fam] = {}
        for mode, strat in (("sync", SyncDataParallel(world)),
                            ("zero", ShardedDataParallel(world))):
            state, costs = _drive(strat, model, optim.sgd(0.05),
                                  params_from_numpy(tree, cls, "cpu"), xs, ys)
            res[fam][mode] = dict(params=_np(strat.to_canonical(state).params), costs=costs)
        if "predict" not in res:
            strat = AsyncDataParallel(world)
            state, _ = _drive(strat, model, optim.sgd(0.05), params_from_numpy(tree, cls, "cpu"),
                              xs[:1], ys[:1])
            tx, ty = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
            res["predict"] = dict(
                eval=float(strat.make_eval_fn(model)(state, tx, ty)),
                served=Predictor.from_state(model, state, strategy=strat, batch_size=3,
                                            device="cpu").accuracy(xs[0], ys[0]),
                probs=Predictor.from_state(model, state, strategy=strat,
                                           device="cpu").predict_proba(xs[0]))
    return res


def _attn_fn(name):
    from distributed_tensorflow_tpu_torch.ops import ring_attention as ra

    return {"ring": ra.ring_attention, "ring_flash": ra.ring_flash_attention,
            "ulysses": ra.ulysses_attention}[name]


def case_ring(world, inp, args):
    """Sequence-parallel attention on a ``("seq",)`` mesh of the world:
    each case of ``args["cases"]`` (variant, causal, window, GQA, kv_lens)
    on this rank's sequence block of the inputs, its output and the
    gradients of sum(out · ct) (the rank's block of the cotangent) with
    respect to its q, k, v blocks, and the ring permutes it made; then
    the ring collectives and the async strategy's ring exchange."""
    import torch

    from distributed_tensorflow_tpu_torch.ops import collectives as co
    from distributed_tensorflow_tpu_torch.ops import ring_attention as ra
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((world.size,), ("seq",), device="cpu")
    n, r = world.size, world.rank
    permutes = [0]
    ring_permute = mesh.ring_permute

    def counted(*a, **kw):
        permutes[0] += 1
        return ring_permute(*a, **kw)

    mesh.ring_permute = counted

    def block(a):
        m = a.shape[1] // n
        return torch.from_numpy(np.ascontiguousarray(a[:, r * m:(r + 1) * m]))

    res = {}
    for case in args["cases"]:
        name, variant, causal, window, gqa, lens = (case[k] for k in (
            "name", "variant", "causal", "window", "gqa", "lens"))
        sfx = "_gqa" if gqa else ""
        q, k, v = (block(inp[f"{t}{sfx if t != 'q' else ''}"]).requires_grad_(True)
                   for t in "qkv")
        kw = dict(causal=causal, window=window)
        if lens:
            kw["kv_lens"] = torch.from_numpy(inp["lens"])
        permutes[0] = 0
        ra.reset_hops()
        out = _attn_fn(variant)(q, k, v, mesh, "seq", **kw)
        fwd_permutes = permutes[0]
        (out * block(inp["ct"])).sum().backward()
        res[name] = dict(out=_np(out), dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad),
                         permutes=fwd_permutes, hops=dict(ra.HOPS))
    x = torch.from_numpy(inp["coll"][r])
    res["coll"] = dict(reduce=_np(co.ring_all_reduce(x, mesh, "seq")),
                       mean=_np(co.ring_all_mean(x, mesh, "seq")),
                       gather=_np(co.ring_all_gather(x, mesh, "seq")))
    # The async strategy's exchange: every copy to the mean, by the ring
    # and by the one all-reduce.
    from distributed_tensorflow_tpu_torch.parallel.strategy import AsyncDataParallel, TrainState

    strat = AsyncDataParallel(world)
    p = _params(inp)
    p = type(p)(*(t + 0.1 * (r + 1) * torch.ones_like(t) for t in p))
    state = TrainState(p, (), 3)
    ring = strat.make_exchange_fn("ring")(state)
    auto = strat.make_exchange_fn()(state)
    res["exchange"] = dict(ring=_np(ring.params), auto=_np(auto.params), step=ring.step)
    return res


def _gpt(kw):
    import torch

    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(**kw, compute_dtype=torch.float32)


def _gpt_tree(inp, prefix):
    """The numpy GPT tree stored flat under ``prefix`` (``<prefix>/embed``,
    ``<prefix>/blocks/wq``, ...)."""
    tree = {k: inp[f"{prefix}/{k}"] for k in ("embed", "pos", "lnf_scale", "lnf_bias")}
    tree["blocks"] = {k.rsplit("/", 1)[1]: v for k, v in inp.items()
                      if k.startswith(f"{prefix}/blocks/")}
    return tree


def _gpt_params(inp, prefix):
    """:func:`_gpt_tree` as the port's GPT parameters on the CPU."""
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy

    return gpt_params_from_numpy(_gpt_tree(inp, prefix), device="cpu")


def case_sp(world, inp, args):
    """The LM's parallel paths on meshes of the world's ranks, each run of
    ``args["runs"]`` from the inputs' parameters: ``sp`` (the sequence-
    parallel step, ``steps`` Adam steps on the global batches), ``ragged``
    (one step on two batches that differ only past the lengths), ``dp``
    (the data-parallel step), ``trainer`` (LMTrainer in a mode, its lines
    and final parameters) and ``transformer`` (the classifier's
    sequence-parallel forward)."""
    import torch

    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models import gpt as gpt_lib
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    res = {}
    toks = torch.from_numpy(inp["tokens"])
    for run in args["runs"]:
        name, kind = run["name"], run["kind"]
        mesh = make_mesh(tuple(run["shape"]), tuple(run["axes"]), device="cpu")
        if kind == "transformer":
            from distributed_tensorflow_tpu_torch.convert import transformer_params_from_numpy
            from distributed_tensorflow_tpu_torch.models.transformer import TransformerClassifier

            model = TransformerClassifier(compute_dtype=torch.float32)
            params = transformer_params_from_numpy(
                {k.split("/", 1)[1]: v for k, v in inp.items() if k.startswith("tf/")}, "cpu")
            n, i = mesh.axis_size("seq"), mesh.axis_index("seq")
            x = torch.from_numpy(inp["tf_x"])
            w = x.shape[1] // n
            res[name] = _np(model.apply_sequence_parallel(params, x[:, i * w:(i + 1) * w], mesh,
                                                          attention=run["attention"]))
            continue
        model = _gpt(run["model"])
        params = _gpt_params(inp, run["params"])
        opt = optim.adam(1e-3)
        data_axis = "data" if "data" in run["axes"] else None
        if kind == "sp":
            step = gpt_lib.make_lm_sp_train_step(model, opt, mesh, data_axis=data_axis,
                                                 attention=run["attention"])
            p, o, losses = params, opt.init(params), []
            for t in toks[:run["steps"]]:
                p, o, loss = step(p, o, t)
                losses.append(float(loss))
            res[name] = dict(params=_np(p), losses=losses)
        elif kind == "ragged":
            mapped = gpt_lib.make_lm_sp_parts(model, opt, mesh, data_axis=data_axis,
                                              attention=run["attention"], ragged=True)
            lens = torch.from_numpy(inp["lengths"])
            out = [mapped(params, opt.init(params), torch.from_numpy(inp[t]), lens)
                   for t in ("ragged_a", "ragged_b")]
            res[name] = dict(params=[_np(x[0]) for x in out], losses=[float(x[2]) for x in out])
        elif kind == "dp":
            step = gpt_lib.make_lm_train_step(model, opt, mesh, "data")
            p, o, losses = params, opt.init(params), []
            for t in toks[:run["steps"]]:
                p, o, loss = step(p, o, t)
                losses.append(float(loss))
            res[name] = dict(params=_np(p), losses=losses)
        elif kind == "trainer":
            from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
            from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

            ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                               TokenDataset(inp["val"], seed=3))
            lines = []
            tr = LMTrainer(model, ds, TrainConfig(**run["config"]), mesh=mesh, device="cpu",
                           sp_attention=run.get("attention"), print_fn=lines.append,
                           optimizer=opt)
            tr.state = tr._init_state(params)
            out = tr.run()
            res[name] = dict(lines=lines, result=out, params=_np(tr.state.params), mode=tr.mode)
    return res


def case_tp(world, inp, args):
    """Tensor parallelism on meshes of the world's 4 ranks, each run of
    ``args["runs"]`` (kinds: ``step`` the dp×tp or dp×tp×sp LM step,
    ``ragged`` one masked step on two batches that differ past the
    lengths, ``trainer`` LMTrainer(dp_mode="tp"), ``collectives`` the three
    operators, ``convert`` the numpy round trip of a JAX state, and
    ``classifier`` / ``zero`` / ``placement`` the classifiers under
    SyncDataParallel / ShardedDataParallel with a tensor-parallel layout)."""
    import torch

    from distributed_tensorflow_tpu_torch.models import gpt as gpt_lib
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from distributed_tensorflow_tpu_torch.parallel.specs import gather_tree, shard_tree

    meshes, res = {}, {}
    toks = torch.from_numpy(inp["tokens"])
    for run in args["runs"]:
        name, kind = run["name"], run["kind"]
        key = (tuple(run["shape"]), tuple(run["axes"]))
        if key not in meshes:
            meshes[key] = make_mesh(*key, device="cpu")
        mesh = meshes[key]
        if kind in ("classifier", "zero", "placement"):
            res[name] = _tp_classifier(kind, run, mesh, inp)
            continue
        if kind == "collectives":
            res[name] = _tp_collectives(mesh)
            continue
        model = _gpt(run["model"])
        specs = model.partition_specs("model")
        if kind == "convert":
            from distributed_tensorflow_tpu_torch.convert import (
                lm_sharded_state_from_numpy,
                lm_sharded_state_to_numpy,
            )

            tree = _gpt_tree(inp, run["params"])
            adam = {"count": inp["adam/count"], "mu": _gpt_tree(inp, "adam_mu"),
                    "nu": _gpt_tree(inp, "adam_nu")}
            p, o = lm_sharded_state_from_numpy(tree, adam, mesh, specs, device="cpu")
            back = lm_sharded_state_to_numpy(p, o, mesh, specs)
            res[name] = dict(params=back[0], adam=back[1], wq=tuple(p.blocks.wq.shape),
                             mu_wo=tuple(o.mu.blocks.wo.shape))
            continue
        params = _gpt_params(inp, run["params"])
        opt = optim.adam(1e-3) if not run.get("clip") else optim.clip(optim.adam(1e-3),
                                                                        run["clip"])
        if kind == "trainer":
            res[name] = _tp_trainer(run, mesh, model, params, opt, inp)
            continue
        step = gpt_lib.make_lm_train_step(model, opt, mesh, "data", tp_axis="model",
                                          seq_axis=run.get("seq"))
        p = shard_tree(params, specs, mesh)
        o = opt.init(p)
        if kind == "ragged":
            lens = torch.from_numpy(inp["lengths"])
            out = [step(p, o, torch.from_numpy(inp[t]), lens) for t in ("ragged_a", "ragged_b")]
            res[name] = dict(params=[_np(gather_tree(x[0], specs, mesh)) for x in out],
                             losses=[float(x[2]) for x in out])
            continue
        losses = []
        for t in toks[:run["steps"]]:
            p, o, loss = step(p, o, t)
            losses.append(float(loss))
        res[name] = dict(params=_np(gather_tree(p, specs, mesh)), losses=losses,
                         local=_np(p), wq=tuple(p.blocks.wq.shape))
    return res


def _tp_collectives(mesh):
    """copy_to, reduce_from and gather_from over "model": each rank's
    forward and the gradient of sum(w · out) it gets back."""
    import torch

    from distributed_tensorflow_tpu_torch.ops import collectives as co

    r = mesh.axis_index("model")
    out = {}
    for op in ("copy_to", "reduce_from", "gather_from"):
        x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r).requires_grad_(True)
        y = getattr(co, op)(x, mesh, "model")
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + r
        (y * w).sum().backward()
        out[op] = dict(y=y.detach().numpy(), grad=x.grad.numpy())
    return out


def _tp_trainer(run, mesh, model, params, opt, inp):
    """LMTrainer(dp_mode="tp") from ``params``: its lines, result, the
    canonical state, this rank's blocks and the to/from_canonical round
    trip."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    import torch

    ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                       TokenDataset(inp["val"], seed=3))
    lines = []
    tr = LMTrainer(model, ds, TrainConfig(**run["config"]), mesh=mesh, device="cpu",
                   print_fn=lines.append, optimizer=opt)
    tr.state = tr._init_state(params)
    out = tr.run()
    c = tr.to_canonical()
    back = tr.from_canonical(c)
    same = back.step == tr.state.step and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back[:2]), tree_leaves(tr.state[:2])))
    return dict(lines=lines, result=out, mode=tr.mode, params=_np(c.params),
                mu=_np(c.opt_state.mu), local=_np(tr.state.params),
                local_mu_wq=tuple(tr.state.opt_state.mu.blocks.wq.shape),
                local_mu_wo=tuple(tr.state.opt_state.mu.blocks.wo.shape), round_trip=same,
                perplexity=tr.evaluate())


def _tp_classifier(kind, run, mesh, inp):
    """A classifier family under SyncDataParallel(mesh, param_specs=)
    (``classifier``: SGD steps eager and scanned, eval, Predictor), under
    ShardedDataParallel with the layout as its base (``zero``), or the
    placement lines and checks of a tp state (``placement``)."""
    import torch

    from distributed_tensorflow_tpu_torch.convert import (
        params_from_numpy,
        sharded_state_from_numpy,
        sharded_state_to_numpy,
    )
    from distributed_tensorflow_tpu_torch.inference import Predictor
    from distributed_tensorflow_tpu_torch.models import build_model
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.fsdp import ShardedDataParallel
    from distributed_tensorflow_tpu_torch.parallel.strategy import SyncDataParallel
    from distributed_tensorflow_tpu_torch.utils import placement

    fam, (reg, kw) = run["family"], run["model"]
    model = build_model(reg, compute_dtype=torch.float32, **kw)
    cls = type(model.init(1, device="cpu"))
    tree = {k: inp[f"{fam}/{k}"] for k in cls._fields}
    specs = model.partition_specs()
    xs, ys = inp["cx"], inp["cy"]
    opt = optim.sgd(run["lr"])
    if kind == "placement":
        strat = SyncDataParallel(mesh, param_specs=specs)
        state = strat.init_state(model, opt, seed=1)
        lines = placement.describe_state(strat, state.params, print_fn=lambda s: None)
        try:
            placement.assert_replicated(state.params, mesh)
            replicated = True
        except AssertionError:
            replicated = False
        placement.assert_sharded_over(strat.placement_specs(state.params), "model")
        return dict(lines=lines, replicated=replicated)
    strat = (SyncDataParallel(mesh, param_specs=specs) if kind == "classifier"
             else ShardedDataParallel(mesh, param_specs=specs))
    state, costs = _drive(strat, model, opt, params_from_numpy(tree, cls, "cpu"), xs, ys)
    out = dict(costs=costs, params=sharded_state_to_numpy(strat, state)[0],
               local={k: tuple(v.shape) for k, v in state.params._asdict().items()})
    if kind == "classifier":
        tx, ty = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
        out["eval"] = float(strat.make_eval_fn(model)(state, tx, ty))
        out["probs"] = Predictor.from_state(model, state, strategy=strat,
                                            device="cpu").predict_proba(xs[0])
        adam = {"count": np.int32(3), "mu": tree, "nu": {k: abs(v) for k, v in tree.items()}}
        out["round_trip"] = sharded_state_to_numpy(
            strat, sharded_state_from_numpy(strat, tree, adam, 3, device="cpu", cls=cls))
        s0 = sharded_state_from_numpy(strat, tree, (), 0, device="cpu", cls=cls)
        fn = strat.make_scanned_train_fn(model, cross_entropy, opt)
        s1, scan_costs = fn(s0, torch.from_numpy(xs), torch.from_numpy(ys))
        out["scanned"] = dict(costs=scan_costs.tolist(),
                              params=sharded_state_to_numpy(strat, s1)[0])
    return out


def case_ep_pp(world, inp, args):
    """Expert and pipeline parallelism on meshes of the world's 4 ranks
    ((4,), (2, 2) and (1, 4)), each run of ``args["runs"]`` by its kind
    (``_EP_PP``), from the inputs' parameters and batches."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    meshes, res = {}, {}
    for run in args["runs"]:
        key = (tuple(run["shape"]), tuple(run["axes"]))
        if key not in meshes:  # a collective: every rank makes every mesh, in order
            meshes[key] = make_mesh(*key, device="cpu")
        res[run["name"]] = _EP_PP[run["kind"]](run, meshes[key], inp)
    return res


def _ep_moe(run, mesh, inp):
    """ops/moe.moe_ffn over "expert" at each capacity of the run: this
    rank's output and the gradients of sum(w · out) it gets back."""
    import torch

    from distributed_tensorflow_tpu_torch.ops.moe import MoEParams, moe_ffn

    e, n = mesh.axis_index("expert"), mesh.axis_size("expert")
    full = {k: torch.from_numpy(inp[f"moe/{k}"]) for k in MoEParams._fields}
    x_all, w_all = torch.from_numpy(inp["moe/x"]), torch.from_numpy(inp["moe/w"])
    t = x_all.shape[0] // n
    out = {}
    for cap in run["caps"]:
        p = MoEParams(**{k: (v if k == "wg" else v[e:e + 1]).clone().requires_grad_(True)
                         for k, v in full.items()})
        x = x_all[e * t:(e + 1) * t].clone().requires_grad_(True)
        y = moe_ffn(p, x, mesh, "expert", cap, k=run["k"])
        (y * w_all[e * t:(e + 1) * t]).sum().backward()
        out[cap] = dict(y=_np(y), x=_np(x.grad), **{k: _np(getattr(p, k).grad) for k in full})
    return out


def _ep_model(run, mesh, inp):
    from distributed_tensorflow_tpu_torch.models.gpt import expert_parallel_specs
    from distributed_tensorflow_tpu_torch.parallel.specs import shard_tree

    model = _gpt(run["model"])
    specs = expert_parallel_specs(model)
    return model, specs, shard_tree(_gpt_params(inp, run["params"]), specs, mesh)


def _ep_fwd(run, mesh, inp):
    """apply_expert_parallel on this rank's rows: logits and drop fraction."""
    import torch

    from distributed_tensorflow_tpu_torch.models.gpt import _shard_rows

    model, _, p = _ep_model(run, mesh, inp)
    toks = _shard_rows(torch.from_numpy(inp[run["tokens"]]), mesh, ("expert",))
    with torch.no_grad():
        logits, aux = model.apply_expert_parallel(p, toks, mesh, with_aux=True)
    return dict(logits=_np(logits), drop=_np(aux.drop_fraction))


def _ep_step(run, mesh, inp):
    """make_lm_ep_parts' update, ``steps`` Adam steps (rate ``lr``) on the
    global batches of ``tokens``; with ``ragged``, one step on each of two
    batches that differ past the lengths, and one with lengths None."""
    import torch

    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_ep_parts
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.specs import gather_tree

    model, specs, p = _ep_model(run, mesh, inp)
    opt = optim.adam(run.get("lr", 1e-3))
    data = "data" if "data" in run["axes"] else None
    _, opt_specs, mapped = make_lm_ep_parts(model, opt, mesh, data_axis=data,
                                            ragged=run.get("ragged", False))
    o = opt.init(p)
    if run.get("ragged"):
        lens = torch.from_numpy(inp["ep_lengths"])
        out = [mapped(p, o, torch.from_numpy(inp[t]), lens) for t in ("ep_ragged_a", "ep_ragged_b")]
        full = torch.full_like(lens, inp["ep_ragged_a"].shape[1])
        none = [float(mapped(p, o, torch.from_numpy(inp["ep_ragged_a"]), x)[2])
                for x in (None, full)]
        return dict(params=[_np(gather_tree(x[0], specs, mesh)) for x in out],
                    losses=[float(x[2]) for x in out], none_full=none)
    losses = []
    for t in inp[run["tokens"]][:run["steps"]]:
        p, o, loss = mapped(p, o, torch.from_numpy(t))
        losses.append(float(loss))
    return dict(params=_np(gather_tree(p, specs, mesh)), losses=losses,
                local_w_up=tuple(p.blocks.w_up.shape),
                slot_w_up=list(opt_specs.mu.blocks.w_up), slot_wq=list(opt_specs.mu.blocks.wq))


def _lm_trainer(run, mesh, inp):
    """LMTrainer(dp_mode=ep|pp) from the run's params: its lines, result,
    the canonical state, this rank's parameter shapes and the
    to/from_canonical round trip."""
    import torch

    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                       TokenDataset(inp["val"], seed=3))
    lines = []
    tr = LMTrainer(_gpt(run["model"]), ds, TrainConfig(**run["config"]), mesh=mesh, device="cpu",
                   print_fn=lines.append, optimizer=optim.adam(1e-3),
                   pp_microbatches=run.get("m", 4))
    tr.state = tr._init_state(_gpt_params(inp, run["params"]))
    out = tr.run()
    c = tr.to_canonical()
    back = tr.from_canonical(c)
    same = back.step == tr.state.step and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back[:2]), tree_leaves(tr.state[:2])))
    return dict(lines=lines, result=out, mode=tr.mode, params=_np(c.params),
                mu=_np(c.opt_state.mu), round_trip=same, perplexity=tr.evaluate(),
                local={k: tuple(v.shape) for k, v in tr.state.params.blocks._asdict().items()},
                local_mu_w_up=tuple(tr.state.opt_state.mu.blocks.w_up.shape))


def _convert(run, mesh, inp):
    """A JAX canonical state as numpy → this rank's ep or pp blocks → back
    to numpy, and the local shapes."""
    from distributed_tensorflow_tpu_torch.convert import (
        lm_sharded_state_from_numpy,
        lm_sharded_state_to_numpy,
    )
    from distributed_tensorflow_tpu_torch.models.gpt import (
        expert_parallel_specs,
        pipeline_parallel_specs,
    )

    model, pre = _gpt(run["model"]), run["params"]
    stages = mesh.axis_size("stage") if "stage" in run["axes"] else None
    specs = (pipeline_parallel_specs(model) if stages else expert_parallel_specs(model))
    tree = _gpt_tree(inp, pre)
    adam = {"count": inp["adam/count"], "mu": _gpt_tree(inp, f"{pre}_mu"),
            "nu": _gpt_tree(inp, f"{pre}_nu")}
    p, o = lm_sharded_state_from_numpy(tree, adam, mesh, specs, device="cpu", stages=stages)
    back = lm_sharded_state_to_numpy(p, o, mesh, specs, staged=stages is not None)
    return dict(params=back[0], adam=back[1], w_up=tuple(p.blocks.w_up.shape),
                mu_w_up=tuple(o.mu.blocks.w_up.shape), mu_embed=tuple(o.mu.embed.shape))


def _pipe(run, mesh, inp):
    """parallel/pipeline.pipeline_apply of tanh-GELU(x @ w + b) stages over
    "stage": the output, and the gradients of sum(c · out) (this rank's
    stage, and the input's)."""
    import torch
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.parallel.pipeline import microbatch, pipeline_apply

    s = mesh.axis_index("stage")
    w = torch.from_numpy(inp["pipe/w"])[s:s + 1].clone().requires_grad_(True)
    b = torch.from_numpy(inp["pipe/b"])[s:s + 1].clone().requires_grad_(True)
    x = torch.from_numpy(inp["pipe/x"]).clone().requires_grad_(True)

    def stage_fn(params, h):
        return F.gelu(h @ params[0][0] + params[1][0], approximate="tanh")

    out = pipeline_apply(stage_fn, (w, b), microbatch(x, run["m"]), mesh)
    y = out.reshape(x.shape)
    (y * torch.from_numpy(inp["pipe/c"])).sum().backward()
    with torch.no_grad():
        plain = pipeline_apply(stage_fn, (w, b), microbatch(x, run["m"]), mesh)
    return dict(y=_np(y), no_grad=_np(plain.reshape(x.shape)), w=_np(w.grad), b=_np(b.grad),
                x=_np(x.grad))


def _pp_fwd(run, mesh, inp):
    """apply_pipeline_parallel's logits on the whole batch."""
    import torch

    from distributed_tensorflow_tpu_torch.models.gpt import (
        pipeline_parallel_specs,
        pipeline_stage_params,
    )
    from distributed_tensorflow_tpu_torch.parallel.specs import shard_tree

    model = _gpt(run["model"])
    s = mesh.axis_size("stage")
    p = shard_tree(pipeline_stage_params(model, _gpt_params(inp, run["params"]), s),
                   pipeline_parallel_specs(model), mesh)
    with torch.no_grad():
        logits = model.apply_pipeline_parallel(p, torch.from_numpy(inp[run["tokens"]]), mesh,
                                               num_microbatches=run["m"])
    return dict(logits=_np(logits), wq=tuple(p.blocks.wq.shape))


def _pp_step(run, mesh, inp):
    """make_lm_pp_parts' update, ``steps`` steps (Adam, or SGD at ``sgd``)
    on the global batches of ``tokens``; with ``ragged``, one step on each
    of two batches that differ past the lengths. Also this rank's
    replicated leaves, to compare across the stages."""
    import torch

    from distributed_tensorflow_tpu_torch.models.gpt import (
        make_lm_pp_parts,
        pipeline_stage_params,
        pipeline_unstage_params,
    )
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.specs import gather_tree, shard_tree

    model = _gpt(run["model"])
    opt = optim.sgd(run["sgd"]) if run.get("sgd") else optim.adam(1e-3)
    data = "data" if "data" in run["axes"] else None
    specs, opt_specs, mapped = make_lm_pp_parts(model, opt, mesh, num_microbatches=run["m"],
                                                data_axis=data)
    s = mesh.axis_size("stage")
    p = shard_tree(pipeline_stage_params(model, _gpt_params(inp, run["params"]), s), specs, mesh)
    o = opt.init(p)

    def canonical(params):
        return _np(pipeline_unstage_params(gather_tree(params, specs, mesh)))

    if run.get("ragged"):
        lens = torch.from_numpy(inp["pp_lengths"])
        out = [mapped(p, o, torch.from_numpy(inp[t]), lens) for t in ("pp_ragged_a", "pp_ragged_b")]
        return dict(params=[canonical(x[0]) for x in out], losses=[float(x[2]) for x in out])
    losses = []
    for t in inp[run["tokens"]][:run["steps"]]:
        p, o, loss = mapped(p, o, torch.from_numpy(t))
        losses.append(float(loss))
    out = dict(params=canonical(p), losses=losses, wq=tuple(p.blocks.wq.shape),
               replicated={k: _np(getattr(p, k)) for k in ("embed", "pos", "lnf_scale")})
    if hasattr(opt_specs, "mu"):  # Adam's slots
        out.update(slot_wq=list(opt_specs.mu.blocks.wq), slot_embed=list(opt_specs.mu.embed))
    return out


_EP_PP = {"moe": _ep_moe, "ep_fwd": _ep_fwd, "ep_step": _ep_step, "trainer": _lm_trainer,
          "convert": _convert, "pipe": _pipe, "pp_fwd": _pp_fwd, "pp_step": _pp_step}


def case_local_sgd(world, inp, args):
    """The LM's async, ZeRO and DiLoCo modes on a (4,) ``("data",)`` mesh
    of the world's ranks, each run of ``args["runs"]`` by its kind
    (``_LSGD``), from the inputs' parameters and batches."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((world.size,), ("data",), device="cpu")
    return {run["name"]: _LSGD[run["kind"]](run, mesh, inp) for run in args["runs"]}


def _lsgd_opt(run):
    from distributed_tensorflow_tpu_torch.ops import optim

    return optim.make(run.get("opt", "adam"), run.get("lr", 1e-3))


def _counting(mesh):
    """Count the mesh's all-reduces (every collective of these modes goes
    through ``Mesh.all_reduce_``): a list that grows a call."""
    calls, orig = [], mesh.all_reduce_

    def counted(t, axes=None, op="sum"):
        calls.append(int(t.numel()))
        return orig(t, axes, op)

    mesh.all_reduce_ = counted
    return calls


def _lsgd_parts(run, mesh, inp):
    """make_lm_async_parts (``async``), the dp step (``dp``) or
    make_lm_diloco_parts (``diloco``) over ``steps`` global batches of
    ``tokens``: this rank's parameters after each step, its losses, the
    all-reduces of each step, and (diloco) the final DiLoCoState."""
    import torch

    from distributed_tensorflow_tpu_torch.convert import diloco_state_to_numpy
    from distributed_tensorflow_tpu_torch.models import gpt as gpt_lib
    from distributed_tensorflow_tpu_torch.train import local_sgd

    model, opt = _gpt(run["model"]), _lsgd_opt(run)
    params = _gpt_params(inp, run["params"])
    kind = run["kind"]
    if kind == "dp":
        step = gpt_lib.make_lm_train_step(model, opt, mesh)
        p, o, count = params, opt.init(params), 0
    elif kind == "async":
        init, mapped = gpt_lib.make_lm_async_parts(model, opt, mesh, **run["kw"])
        p, o, count = init(params, opt.init(params))
    else:
        init, mapped = local_sgd.make_lm_diloco_parts(model, opt, mesh, **run["kw"])
        p, o, count = init(params, opt.init(params))
    out = dict(params=[], losses=[], reduces=[])
    for t in inp[run["tokens"]][:run["steps"]]:
        calls = _counting(mesh)
        if kind == "dp":
            p, o, loss = step(p, o, torch.from_numpy(t))
        else:
            p, o, loss = mapped(p, o, torch.from_numpy(t), None, count)
        del mesh.all_reduce_
        count += 1
        out["params"].append(_np(p))
        out["losses"].append(float(loss))
        out["reduces"].append(calls)
    if kind == "diloco":
        out["state"] = diloco_state_to_numpy(o, mesh)
        out["landing_is_copy"] = o.inflight is None or all(
            a.data_ptr() != b.data_ptr() for a, b in zip(_leaves_of(o.theta),
                                                          _leaves_of(o.inflight.landing)))
    return out


def _leaves_of(tree):
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    return tree_leaves(tree)


def _host_reads():
    """A TorchDispatchMode counting host reads of a tensor's value
    (``aten._local_scalar_dense``) in ``.reads``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                self.reads += 1
            return func(*args, **(kwargs or {}))

    return Mode()


def _lsgd_trainer(run, mesh, inp):
    """LMTrainer in the run's mode from the run's params: its lines, result,
    the canonical state, the held-out perplexity, this rank's shapes, the
    to/from_canonical round trip, the all-reduces of its steps (the
    collectives of the log lines counted apart) and, with ``compiled``,
    run_compiled's host reads inside its loop."""
    import torch

    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.convert import diloco_state_to_numpy
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                       TokenDataset(inp["val"], seed=3))
    lines = []
    tr = LMTrainer(_gpt(run["model"]), ds, TrainConfig(**run["config"]), mesh=mesh, device="cpu",
                   print_fn=lines.append, optimizer=_lsgd_opt(run), **run.get("trainer", {}))
    tr.state = tr._init_state(_gpt_params(inp, run["params"]))
    step, reduces = tr._train_step, []

    def counted(toks, lens):
        calls = _counting(mesh)
        cost = step(toks, lens)
        del mesh.all_reduce_
        reduces.append(calls)
        return cost

    tr._train_step = counted
    reads = None
    if run.get("compiled"):
        tr.evaluate = lambda split="validation": 0.0  # the final full-split evaluate
        mode = _host_reads()
        with mode:
            out = tr.run_compiled()
        reads = mode.reads
        del tr.evaluate
    else:
        out = tr.run()
    c = tr.to_canonical()
    back = tr.from_canonical(c)
    again = tr.to_canonical(back)
    same = all(torch.equal(a, b) for a, b in zip(_leaves_of(c[:2]), _leaves_of(again[:2])))
    res = dict(lines=lines, result=out, mode=tr.mode, params=_np(c.params),
               opt=_np(c.opt_state), round_trip=same and again.step == c.step,
               perplexity=tr.evaluate(), reduces=reduces, reads=reads,
               local={k: tuple(v.shape) for k, v in tr.state.params._asdict().items()
                      if k != "blocks"},
               local_blocks={k: tuple(v.shape) for k, v in tr.state.params.blocks._asdict().items()},
               own=_np(tr.state.params))
    if tr.mode == "zero":
        res["local_mu"] = {k: tuple(v.shape) for k, v in tr.state.opt_state.mu._asdict().items()
                           if k != "blocks"}
    if tr.mode == "diloco":
        res["state"] = diloco_state_to_numpy(tr.state.opt_state, mesh)
        fresh = back.opt_state
        res["fresh_outer"] = dict(
            theta_is_params=all(torch.equal(a, b) for a, b in zip(_leaves_of(fresh.theta),
                                                                  _leaves_of(c.params))),
            momentum_zero=all(not a.any() for a in _leaves_of(fresh.momentum)),
            residual_zero=fresh.residual is None or all(not a.any()
                                                        for a in _leaves_of(fresh.residual)))
    return res


def _lsgd_convert(run, mesh, inp):
    """The numpy round trips: a JAX async state's rows (this rank's copy)
    stacked back, a canonical state's ZeRO slices gathered back, and a
    DiLoCoState (this rank's inner state) gathered back; this rank's
    shapes."""
    from distributed_tensorflow_tpu_torch import convert as cv
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_zero_parts
    from distributed_tensorflow_tpu_torch.ops import optim

    pre = run["params"]
    stacked = _gpt_tree(inp, f"{pre}_stack")
    adam_stack = {"count": inp["stack/count"], "mu": _gpt_tree(inp, f"{pre}_stack_mu"),
                  "nu": _gpt_tree(inp, f"{pre}_stack_nu")}
    p, o = cv.lm_async_state_from_numpy(stacked, adam_stack, mesh, device="cpu")
    out = dict(async_back=cv.lm_async_state_to_numpy(p, o, mesh),
               async_embed=float(p.embed[0, 0]))
    model = _gpt(run["model"])
    specs, _, _ = make_lm_zero_parts(model, optim.adam(1e-3), mesh)
    tree = _gpt_tree(inp, pre)
    adam = {"count": inp["adam/count"], "mu": _gpt_tree(inp, f"{pre}_mu"),
            "nu": _gpt_tree(inp, f"{pre}_nu")}
    zp, zo = cv.lm_sharded_state_from_numpy(tree, adam, mesh, specs, device="cpu")
    out["zero_back"] = cv.lm_sharded_state_to_numpy(zp, zo, mesh, specs)
    out["zero_embed"], out["zero_mu_embed"] = tuple(zp.embed.shape), tuple(zo.mu.embed.shape)
    for lever in ("off", "on"):
        d = {"inner": adam_stack, "theta": tree, "momentum": _gpt_tree(inp, f"{pre}_mu"),
             "residual": None, "inflight": None}
        if lever == "on":
            d.update(residual=_gpt_tree(inp, f"{pre}_nu"),
                     inflight={"delta": _gpt_tree(inp, f"{pre}_mu"), "landing": tree})
        st = cv.diloco_state_from_numpy(d, mesh, device="cpu")
        out[f"diloco_{lever}"] = cv.diloco_state_to_numpy(st, mesh)
        out[f"diloco_{lever}_count"] = int(st.inner.count)
    return out


_LSGD = {"dp": _lsgd_parts, "async": _lsgd_parts, "diloco": _lsgd_parts,
         "trainer": _lsgd_trainer, "convert": _lsgd_convert}


def case_ckpt(world, inp, args):
    """Checkpoints across LM modes on the world's ranks (``args["runs"]``):
    each run trains its source mode on a mesh of every rank with a
    checkpoint directory (every rank gathers, the chief writes, the ranks
    meet after the final save), then builds its target mode on the same
    directory, which restores there. Each side's canonical state (a
    collective of its mesh), its layout sidecar and the target's start
    step; for a DiLoCo target the outer state it carried."""
    import torch

    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    def trainer(side, ckdir):
        ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                           TokenDataset(inp["val"], seed=3))
        mesh = None
        if side.get("mesh"):
            shape, names = side["mesh"]
            mesh = make_mesh(tuple(shape), tuple(names), device="cpu")
        cfg = TrainConfig(**{**args["config"], **side.get("config", {}), "checkpoint_dir": ckdir})
        return LMTrainer(_gpt(args["model"]), ds, cfg, mesh=mesh, device="cpu",
                         print_fn=lambda *a: None, optimizer=optim.make("adam", 1e-2),
                         **side.get("trainer", {}))

    def canonical(tr):
        c = tr.to_canonical()
        return dict(params=_np(c.params), opt=_np(c.opt_state), step=int(c.step))

    out = {}
    for run in args["runs"]:
        ckdir = os.path.join(args["dir"], f"ck-{run['name']}")
        src = trainer(run["src"], ckdir)
        src.run()
        res = dict(src=canonical(src), src_layout=src._layout_meta())
        d = src.state.opt_state
        if src.mode == "diloco":
            res["src_outer"] = _np([d.theta, d.momentum])
        dst = trainer(run["dst"], ckdir)
        res.update(dst=canonical(dst), start_step=dst.start_step, dst_mode=dst.mode)
        if dst.mode == "diloco":
            e = dst.state.opt_state
            res["dst_outer"] = _np([e.theta, e.momentum])
        torch.distributed.barrier()
        out[run["name"]] = res
    return out


CASES = {"classifiers": case_classifiers, "strategies": case_strategies, "single": case_single,
         "trainer": case_trainer, "fused": case_fused, "bootstrap": case_bootstrap,
         "sync_global": case_sync_global, "ring": case_ring, "sp": case_sp, "tp": case_tp,
         "ep_pp": case_ep_pp, "local_sgd": case_local_sgd, "ckpt": case_ckpt}
NO_GROUP = ("bootstrap",)  # cases that join their own group


def run_task(d: str, argv) -> None:
    """One task of a cluster started by ``tools/launch_local.py``:
    ``launch.run`` on the CPU with the inputs' data, the reference's flags
    in ``argv``."""
    from distributed_tensorflow_tpu_torch.config import ClusterConfig, TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import run

    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    with open(os.path.join(d, "args.json")) as f:
        args = json.load(f)
    port = args["port"]
    cluster = ClusterConfig(
        worker_svrs=tuple(f"127.0.0.1:{port + i}" for i in range(args["workers"])),
        ps_svrs=(f"127.0.0.1:{port + 100}",), connect_timeout_s=60, connect_attempts=1)
    ds = Datasets(train=DataSet(inp["train_x"], inp["train_y"], seed=1),
                  validation=DataSet(inp["test_x"][:10], inp["test_y"][:10], seed=3),
                  test=DataSet(inp["test_x"], inp["test_y"], seed=2))
    out = run(cluster, TrainConfig(compute_dtype="float32", **args["config"]), argv=argv,
              device="cpu", datasets=ds)
    print("RESULT", json.dumps(out))


def main(argv) -> None:
    if argv[0] == "task":
        return run_task(argv[1], argv[2:])
    case, rank, n, d = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch

    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    with open(os.path.join(d, "args.json")) as f:
        args = json.load(f)
    if case in NO_GROUP:
        args["rank"] = rank
        res = CASES[case](None, inp, args)
    else:
        from distributed_tensorflow_tpu_torch.parallel.mesh import init_world

        world = init_world(f"file://{os.path.join(d, 'store')}", n, rank,
                           device=args.get("device", "cpu"), timeout_s=WORLD_TIMEOUT_S)
        res = CASES[case](world, inp, args)
        torch.distributed.destroy_process_group()
    res = {"result": res, "jax_loaded": any(m.split(".")[0] in ("jax", "jaxlib")
                                            for m in sys.modules),
           "jax_package_loaded": "distributed_tensorflow_tpu" in sys.modules}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
