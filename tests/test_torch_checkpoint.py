"""PyTorch port: checkpoints through the trainers, resume and restore
across modes, mirroring the JAX package's ``tests/test_resume.py``,
``tests/test_checkpoint_sharded.py``, ``tests/test_cross_topology_restore.py``
and ``tests/test_lm_trainer.py::test_supervisor_resume_bitwise``.

- Resume in the port itself, bit for bit: ``Trainer`` and ``LMTrainer`` run
  straight against split with a restore between (sync and async saves);
  ``epochs_per_dispatch`` against one dispatch.
- The layout sidecar (``_layout_meta``) and ``layout_shape`` equal the
  JAX package's for every LM mode.
- Across modes in one process (layouts of one rank, and the one-device
  DiLoCo gang at two widths), and across modes in one 2-rank gloo world
  (``tests/_torch_dist.py`` case ``ckpt``): dp→zero, zero→dp, pp→dp,
  async→dp and DiLoCo 2→1 with its outer state carried, each restored
  canonical state the source's gathered state bit for bit.
- ``Predictor.from_checkpoint`` of a sync and an async checkpoint.

The ``cuda`` cases (the async snapshot of card tensors, a restore onto the
card) skip here.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
from distributed_tensorflow_tpu_torch.models.mlp import MLP
from distributed_tensorflow_tpu_torch.ops import optim
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
from distributed_tensorflow_tpu_torch.train import resilience as R
from distributed_tensorflow_tpu_torch.train.supervisor import (
    LAYOUT_SHAPE_KEYS,
    Supervisor,
    checkpoint_steps,
    layout_shape,
)
from distributed_tensorflow_tpu_torch.train.trainer import Trainer

_QUIET = dict(print_fn=lambda *a, **k: None)
LM = dict(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=2)


@pytest.fixture(autouse=True)
def _one_thread():
    """Bitwise comparisons of two CPU runs need one thread (the threaded
    products do not repeat bit for bit)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def _mlp_ds(rows=800, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((rows, 784), dtype=np.float32)
    labs = np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]
    return Datasets(train=DataSet(imgs, labs, seed=1), validation=None,
                    test=DataSet(imgs[:100], labs[:100], seed=2))


def _lm(**kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(**{**LM, **kw}, compute_dtype=torch.float32)


def _corpus():
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus

    return copy_corpus(num=576, half_len=8, vocab=61, n_val=64, n_test=64, seed=0)


def _lm_trainer(ckpt=None, mesh=None, opt="adam", **cfg):
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    kw = dict(epochs=2, batch_size=64, optimizer=opt, learning_rate=3e-3, log_frequency=10**9,
              logs_path="", checkpoint_dir=ckpt)
    return LMTrainer(_lm(), _corpus(), TrainConfig(**{**kw, **cfg}), mesh=mesh, device="cpu",
                     **_QUIET)


# ---------------------------------------------------------------------------
# Resume, bit for bit.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_checkpoint", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("scan", [False, True], ids=["eager", "scanned"])
def test_resume_matches_uninterrupted(tmp_path, scan, async_checkpoint):
    """The MLP Trainer, 4 epochs straight against 2 + a new Trainer that
    restores (the host data stream replayed to the checkpoint, the
    reference's convention): the same parameters, costs and accuracy bit
    for bit (test_resume.py, held at rtol 1e-6 there)."""
    cfg = TrainConfig(epochs=4, log_frequency=10**9, logs_path="", scan_epoch=scan,
                      optimizer="adam", learning_rate=0.01, async_checkpoint=async_checkpoint)
    opt = optim.adam(0.01)
    mk = lambda ds, c: Trainer(MLP(hidden_dim=16, compute_dtype=torch.float32), ds, c,  # noqa: E731
                               optimizer=opt, device="cpu", **_QUIET)
    full = mk(_mlp_ds(), cfg)
    want = full.run()
    ck = str(tmp_path / "ck")
    mk(_mlp_ds(), cfg.replace(checkpoint_dir=ck)).run(epochs=2)
    ds = _mlp_ds()
    t_b = mk(ds, cfg.replace(checkpoint_dir=ck))
    spe = 8
    assert t_b.start_step == 2 * spe and t_b.epochs_completed == 2
    if scan:
        for _ in range(2):
            t_b._scan_rng.permutation(800)
    else:
        for _ in range(2 * spe):
            ds.train.next_batch(100)
    got = t_b.run(epochs=2)
    assert got == want
    assert _equal(full.state.params, t_b.state.params)
    assert _equal(full.state.opt_state, t_b.state.opt_state)


def test_compiled_run_checkpoints_and_resumes(tmp_path):
    cfg = TrainConfig(epochs=2, log_frequency=10**9, checkpoint_dir=str(tmp_path / "ck"),
                      compute_dtype="float32", logs_path="")
    model = MLP(hidden_dim=16, compute_dtype=torch.float32)
    t1 = Trainer(model, _mlp_ds(), cfg, device="cpu", **_QUIET)
    r1 = t1.run_compiled()
    assert r1["global_step"] == 2 * 8
    t2 = Trainer(model, _mlp_ds(), cfg, device="cpu", **_QUIET)
    assert t2.start_step == 16 and t2.epochs_completed == 2
    assert _equal(t2.state.params, t1.state.params)
    r2 = t2.run_compiled(epochs=1)
    assert r2["global_step"] == 3 * 8


@pytest.mark.parametrize("trainer", ["mlp", "lm"])
def test_epochs_per_dispatch_equals_one_dispatch(tmp_path, trainer):
    """``epochs_per_dispatch=1`` over 2 epochs saves 2 steps and equals one
    ``run_compiled(2)`` bit for bit: the LM's costs (each chunk draws the
    next indices of the same stream), the MLP's per-chunk shuffles seeded
    by the chunk's first step (as JAX folds the step into its key), so its
    chunks equal two ``run_compiled(1)`` calls."""
    lines = {}
    if trainer == "lm":
        chunked = _lm_trainer(str(tmp_path / "ck"), epochs_per_dispatch=1)
        res = chunked.run()
        one = _lm_trainer()
        want = one.run_compiled(2)
        assert res["final_cost"] == want["final_cost"] and res["perplexity"] == want["perplexity"]
    else:
        cfg = TrainConfig(epochs=2, log_frequency=10**9, logs_path="", compute_dtype="float32")
        mk = lambda c, out: Trainer(MLP(hidden_dim=16, compute_dtype=torch.float32),  # noqa: E731
                                    _mlp_ds(), c, device="cpu", print_fn=out.append)
        lines["chunked"], lines["one"] = [], []
        chunked = mk(cfg.replace(checkpoint_dir=str(tmp_path / "ck"), epochs_per_dispatch=1),
                     lines["chunked"])
        res = chunked.run()
        one = mk(cfg, lines["one"])
        one.run_compiled(1, finalize=False)
        want = one.run_compiled(1, epoch_offset=1)
        assert res == want
        strip = lambda ls: [ln.split(" AvgTime")[0] for ln in ls  # noqa: E731
                            if not ln.startswith("Total Time")]
        assert strip(lines["chunked"]) == strip(lines["one"])
    assert _equal(chunked.state.params, one.state.params)
    assert checkpoint_steps(str(tmp_path / "ck")) == [res["global_step"] // 2, res["global_step"]]


@pytest.mark.parametrize("async_checkpoint", [False, True], ids=["sync", "async"])
def test_supervisor_resume_bitwise(tmp_path, async_checkpoint):
    """LMTrainer interrupted after epoch 2 of 4 and restored by a new
    trainer (which fast-forwards the index stream itself): every loss,
    the parameters and the Adam slots equal the uninterrupted run's bit
    for bit (test_lm_trainer.py::test_supervisor_resume_bitwise)."""
    ck = str(tmp_path / "ck")
    kw = dict(epochs=4, async_checkpoint=async_checkpoint)
    full = _lm_trainer(**kw)
    want = full.run()
    part = _lm_trainer(ck, **kw)
    part.run(epochs=2)
    assert part.supervisor.latest_step() == 14
    resumed = _lm_trainer(ck, **kw)
    assert resumed.start_step == 14 and resumed.global_step == 14
    got = resumed.run(epochs=2)
    assert got["final_cost"] == want["final_cost"] and got["global_step"] == 28
    assert _equal(full.state, resumed.state)


def test_lm_rollback_matches_jax(tmp_path):
    """A NaN epoch (the cost of epoch 2 scripted to NaN over real
    training) through both packages' LMTrainers: the same ``Rollback:``
    line, the restored step of epoch 1 and 3 good epochs."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data import copy_corpus as jcorpus
    from distributed_tensorflow_tpu.models.gpt import GPTLM as JGPT
    from distributed_tensorflow_tpu.train import LMTrainer as JLM

    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    def scripted(base):
        class Scripted(base):
            def run_epoch(self, epoch, logger):
                super().run_epoch(epoch, logger)
                self._ran = getattr(self, "_ran", 0) + 1
                if self._ran == 2:
                    self.last_cost = float("nan")
                    self._epoch_costs = None

        return Scripted

    kw = dict(epochs=3, batch_size=64, optimizer="sgd", learning_rate=0.05,
              log_frequency=10**9, logs_path="", max_rollbacks=1, spike_threshold=0.0)
    lines = {"jax": [], "port": []}
    jt = scripted(JLM)(JGPT(**LM, compute_dtype=jnp.float32),
                       jcorpus(num=576, half_len=8, vocab=61, n_val=64, n_test=64, seed=0),
                       JConfig(checkpoint_dir=str(tmp_path / "j"), scan_epoch=False, **kw),
                       print_fn=lambda *a: lines["jax"].append(" ".join(map(str, a))))
    jres = jt.run()
    pt = scripted(LMTrainer)(_lm(), _corpus(), TrainConfig(checkpoint_dir=str(tmp_path / "p"),
                                                            **kw),
                             device="cpu", print_fn=lambda *a: lines["port"].append(
                                 " ".join(map(str, a))))
    pres = pt.run()
    roll = {k: [ln for ln in v if ln.startswith("Rollback:")] for k, v in lines.items()}
    assert roll["port"] == roll["jax"] == [
        "Rollback: kind=nan epoch=1 detected_step=14 restored_step=7 rollback=1/1 "
        "data_window=skipped"]
    assert pres["global_step"] == jres["global_step"] == 21
    assert checkpoint_steps(str(tmp_path / "p")) == checkpoint_steps(str(tmp_path / "j"))


# ---------------------------------------------------------------------------
# Round trips of every MLP strategy's state (test_checkpoint_sharded.py).
# ---------------------------------------------------------------------------


def _strategy(kind):
    from distributed_tensorflow_tpu_torch.parallel.fsdp import ShardedDataParallel
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        AsyncDataParallel,
        SingleDevice,
        SyncDataParallel,
    )

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    return {"single": lambda: SingleDevice("cpu"), "sync": lambda: SyncDataParallel(mesh),
            "tp": lambda: SyncDataParallel(mesh, param_specs=MLP().partition_specs()),
            "zero": lambda: ShardedDataParallel(mesh),
            "async": lambda: AsyncDataParallel(mesh, avg_every=3)}[kind]()


@pytest.mark.parametrize("kind", ["sync", "tp", "async", "zero"],
                         ids=["sync-replicated", "sync-tp", "async-stacked", "zero"])
def test_checkpoint_round_trip(tmp_path, kind):
    """A trained state of each strategy saved and restored by a new
    Trainer of the same strategy: every leaf bitwise, the step kept; the
    checkpoint holds JAX's layout (async: the copies stacked [n, ...] and
    an [n] step vector)."""
    cfg = TrainConfig(epochs=1, log_frequency=10**9, logs_path="", scan_epoch=False,
                      optimizer="adam", learning_rate=0.01,
                      checkpoint_dir=str(tmp_path / "ck"))
    mk = lambda: Trainer(MLP(compute_dtype=torch.float32), _mlp_ds(), cfg,  # noqa: E731
                         strategy=_strategy(kind), optimizer=optim.adam(0.01), **_QUIET)
    a = mk()
    a.run()
    b = mk()
    assert b.start_step == a.strategy.global_step(a.state) == 8
    assert _equal(a.state, b.state)
    m = R.load_manifest(str(tmp_path / "ck"), 8)
    if kind == "async":
        assert m["leaves"][".step"]["shape"] == [1]
        assert m["leaves"][".params.w1"]["shape"] == [1, 784, 100]
    else:
        assert m["leaves"][".step"]["shape"] == [] and m["leaves"][".params.w1"]["shape"] == [
            784, 100]


@pytest.mark.parametrize("src,dst", [("async", "sync"), ("sync", "async"), ("sync", "tp"),
                                     ("async", "single")])
def test_trainer_cross_strategy_resume(tmp_path, src, dst):
    """A checkpoint of one strategy resumes under another through the
    sidecar: async's copies fold to their mean (one copy here: itself),
    sync broadcasts into copies, tp lays out blocks; the step is kept and
    training continues."""
    cfg = TrainConfig(epochs=1, batch_size=100, scan_epoch=False, log_frequency=10**9,
                      logs_path="", checkpoint_dir=str(tmp_path))
    mk = lambda k: Trainer(MLP(compute_dtype=torch.float32), _mlp_ds(), cfg,  # noqa: E731
                           strategy=_strategy(k), **_QUIET)
    a = mk(src)
    a.run()
    saved = a.strategy.global_step(a.state)
    want = a.strategy.effective_params(a.state)
    b = mk(dst)
    assert b.start_step == saved == b.strategy.global_step(b.state)
    assert _equal(b.strategy.effective_params(b.state), want)
    res = b.run()
    assert res["global_step"] > saved


def test_predictor_from_checkpoint_sync_and_async(tmp_path):
    """``Predictor.from_checkpoint`` serves a sync checkpoint's parameters
    and an async one's copies at their mean, each the trainer's effective
    parameters."""
    from distributed_tensorflow_tpu_torch.inference import Predictor

    ds = _mlp_ds()
    for kind in ("sync", "async"):
        d = str(tmp_path / kind)
        tr = Trainer(MLP(compute_dtype=torch.float32), ds,
                     TrainConfig(epochs=1, log_frequency=10**9, logs_path="", scan_epoch=False,
                                 checkpoint_dir=d), strategy=_strategy(kind), **_QUIET)
        tr.run()
        pred = Predictor.from_checkpoint(MLP(compute_dtype=torch.float32), d, device="cpu")
        assert _equal(pred.params, tr.strategy.effective_params(tr.state))
        live = Predictor.from_state(MLP(compute_dtype=torch.float32), tr.state,
                                    strategy=tr.strategy, device="cpu")
        assert np.array_equal(pred.predict(ds.test.images), live.predict(ds.test.images))


# ---------------------------------------------------------------------------
# The layout sidecar against the JAX package's, and restores across modes.
# ---------------------------------------------------------------------------

_MODES = {  # mode -> (mesh shape, config, delta_exchange world or None)
    "single": ({}, {}, None), "dp": ({"data": 8}, {}, None), "zero": ({"data": 8}, {}, None),
    "tp": ({"data": 4, "model": 2}, {}, None), "ep": ({"data": 2, "expert": 4}, {}, None),
    "sp": ({"data": 2, "seq": 4}, {}, None), "pp": ({"data": 2, "stage": 4}, {}, None),
    "async": ({"data": 8}, {}, None), "diloco": ({"data": 8}, dict(sync_every=3), None),
    "diloco-levers": ({"data": 4}, dict(sync_every=2, delta_dtype="int8", delta_overlap=True),
                      None),
    "diloco-vmapped": (None, dict(diloco_workers=3, delta_dtype="fp8"), None),
    "diloco-mailbox": (None, dict(diloco_workers=1, delta_dtype="int8", stale_limit=2), 3),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_layout_meta_and_shape_match_jax(mode):
    """``_layout_meta`` of each LM mode (the sidecar) is the JAX trainer's
    dict for the same mode, mesh, knobs and gang, and ``layout_shape`` of
    it (and ``LAYOUT_SHAPE_KEYS``) the same."""
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.train.lm_trainer import LMTrainer as JLM
    from distributed_tensorflow_tpu.train.supervisor import LAYOUT_SHAPE_KEYS as JKEYS
    from distributed_tensorflow_tpu.train.supervisor import layout_shape as jshape
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    shape, cfg, world = _MODES[mode]
    base = mode.split("-")[0]
    knobs = dict(cfg, batch_size=48)
    if base == "diloco":
        knobs["dp_mode"] = "diloco"
    mesh = None if shape is None else SimpleNamespace(
        shape=dict(shape), size=int(np.prod(list(shape.values()))) if shape else 1)
    if not shape:
        mesh = None
    metas = []
    for cls, conf in ((LMTrainer, TrainConfig), (JLM, JConfig)):
        stub = SimpleNamespace(mode="diloco" if base == "diloco" else base, mesh=mesh,
                               stage_axis="stage", data_axis="data", config=conf(**knobs),
                               delta_exchange=None if world is None else SimpleNamespace(
                                   world=world))
        stub._gang_size = lambda stub=stub, cls=cls: cls._gang_size(stub)
        metas.append(cls._layout_meta(stub))
    assert metas[0] == metas[1]
    assert layout_shape(metas[0]) == jshape(metas[1]) and LAYOUT_SHAPE_KEYS == JKEYS


def test_real_trainers_write_the_sidecar_they_describe(tmp_path):
    """The sidecar on disk is ``_layout_meta`` of the trainer that wrote it
    (pp over a stage axis of one rank: the staged [1, L, ...] blocks), and
    its manifest leaf shapes are JAX's for the mode."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    tr = _lm_trainer(str(tmp_path), mesh=make_mesh((1,), ("stage",), device="cpu"),
                     dp_mode="pp", epochs=1)
    tr.run()
    step = tr.supervisor.latest_step()
    assert tr.supervisor.saved_layout(step) == tr._layout_meta() == {
        "mode": "pp", "stages": 1, "world": 1, "global_batch": 64}
    leaves = R.load_manifest(str(tmp_path), step)["leaves"]
    assert leaves[".params.blocks.wq"]["shape"] == [1, 2, 32, 32]
    assert leaves[".opt_state.mu.blocks.wq"]["shape"] == [1, 2, 32, 32]
    assert leaves[".params.embed"]["shape"] == [61, 32] and leaves[".step"]["shape"] == []


@pytest.mark.parametrize("src,dst", [("pp", "single"), ("single", "pp"), ("async", "single"),
                                     ("single", "diloco"), ("diloco", "single")])
def test_cross_restore_state_matches_canonical(tmp_path, src, dst):
    """One epoch in the source layout (one rank: pp's staged blocks,
    async's stacked copy, the one-device DiLoCo gang of 2), then the
    destination trainer on the same directory: its canonical state is the
    source's bit for bit, and training goes on from the saved step."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    def make(mode, ck, epochs=1):
        kw = {"pp": dict(dp_mode="pp"), "async": dict(sync=False, async_avg_every=2),
              "diloco": dict(dp_mode="diloco", diloco_workers=2, sync_every=3)}.get(mode, {})
        mesh = {"pp": lambda: make_mesh((1,), ("stage",), device="cpu"),
                "async": lambda: make_mesh((1,), ("data",), device="cpu")}.get(mode,
                                                                               lambda: None)()
        return _lm_trainer(ck, mesh=mesh, epochs=epochs, **kw)

    ck = str(tmp_path / "ck")
    a = make(src, ck)
    a.run()
    want = a.to_canonical()
    b = make(dst, ck)
    assert b.start_step == a.global_step == 7
    got = b.to_canonical()
    assert _equal(got.params, want.params) and _equal(got.opt_state, want.opt_state)
    assert b.run(epochs=1)["global_step"] == 14


def test_cross_world_diloco_resize_carries_outer_and_lever_state(tmp_path):
    """The one-device DiLoCo gang resized 4 → 2 workers with both levers:
    the copies re-derive from the merged canonical state, θ_start, the
    momentum, the residual and the in-flight state carry verbatim."""
    kw = dict(dp_mode="diloco", sync_every=3, outer_lr=1.0, outer_momentum=0.4,
              delta_dtype="int8", delta_overlap=True, epochs=1)
    ck = str(tmp_path / "ck")
    a = _lm_trainer(ck, diloco_workers=4, **kw)
    a.run()
    b = _lm_trainer(ck, diloco_workers=2, **kw)
    assert b.start_step == 7
    da, db = a.state.opt_state, b.state.opt_state
    for f in ("theta", "momentum", "residual", "inflight"):
        assert _equal(getattr(da, f), getattr(db, f)), f
    assert b.state.params.embed.shape[0] == 2
    assert _equal(b.to_canonical().params, a.to_canonical().params)


def test_dense_to_lever_diloco_restores_zero_lever_state(tmp_path):
    """A dense checkpoint into a DiLoCo gang with both levers: a fresh
    outer round: θ_start the restored parameters, zero momentum, zero
    residual, nothing in flight and the landing point at the restored
    parameters."""
    ck = str(tmp_path / "ck")
    a = _lm_trainer(ck, epochs=1)
    a.run()
    b = _lm_trainer(ck, dp_mode="diloco", diloco_workers=2, sync_every=3, delta_dtype="int8",
                    delta_overlap=True, epochs=1)
    d = b.state.opt_state
    assert b.start_step == 7
    assert _equal(d.theta, a.state.params) and _equal(d.inflight.landing, a.state.params)
    for t in (d.momentum, d.residual, d.inflight.delta):
        assert all(not x.any() for x in tree_leaves(t))


def test_lever_sidecar_keys_are_shape_keys(tmp_path):
    """A lever flipped between save and resume routes through the restore
    across layouts (the state's structure differs), and a lever-off DiLoCo
    sidecar carries no lever keys."""
    ck = str(tmp_path / "ck")
    a = _lm_trainer(ck, dp_mode="diloco", diloco_workers=2, sync_every=3, epochs=1)
    a.run()
    meta = a._layout_meta()
    assert "delta_dtype" not in meta and "overlap" not in meta
    b = _lm_trainer(ck, dp_mode="diloco", diloco_workers=2, sync_every=3, delta_dtype="int8",
                    epochs=1)
    assert not b._layout_compatible(meta) and b.start_step == 7
    assert _equal(b.state.opt_state.theta, a.state.opt_state.theta)
    assert all(not x.any() for x in tree_leaves(b.state.opt_state.residual))


def test_same_mode_diloco_resume_stays_bitwise(tmp_path):
    """The same layout resumes bit for bit: the mid-round copies, their
    inner states and the outer state, no merge."""
    ck = str(tmp_path / "ck")
    kw = dict(dp_mode="diloco", diloco_workers=2, sync_every=3, outer_momentum=0.5, epochs=1)
    a = _lm_trainer(ck, **kw)
    a.run()
    b = _lm_trainer(ck, **kw)
    assert b.start_step == 7 and _equal(a.state, b.state)


def test_restore_refuses_another_global_batch(tmp_path):
    """The LM batch is global: resuming with another batch_size is refused
    (JAX :322-335)."""
    ck = str(tmp_path / "ck")
    _lm_trainer(ck, epochs=1).run()
    with pytest.raises(ValueError, match="global batch 64"):
        _lm_trainer(ck, epochs=1, batch_size=32)


def test_cross_mode_restores_in_a_gloo_world(tmp_path):
    """2 CPU ranks over gloo: dp→zero, zero→dp, pp→dp, async→dp and DiLoCo
    2→1. Each source saves in its JAX layout (every rank gathers, the
    chief writes), each target restores: its canonical state equals the
    source's gathered canonical state bit for bit, from the saved step;
    DiLoCo's outer state (θ_start, momentum) carries into the one-worker
    gang verbatim."""
    from _torch_dist import run_world

    rng = np.random.default_rng(0)
    half = rng.integers(1, 61, (80, 8))
    toks = np.concatenate([half, half], 1).astype(np.int32)
    d = str(tmp_path)
    dl = dict(dp_mode="diloco", sync_every=2, outer_lr=0.7, outer_momentum=0.9)
    data = [[2], ["data"]]
    runs = [
        dict(name="dp-zero", src=dict(mesh=data), dst=dict(mesh=data, config=dict(dp_mode="zero"))),
        dict(name="zero-dp", src=dict(mesh=data, config=dict(dp_mode="zero")), dst=dict(mesh=data)),
        dict(name="pp-dp", src=dict(mesh=[[2], ["stage"]], config=dict(dp_mode="pp")),
             dst=dict(mesh=data)),
        dict(name="async-dp", src=dict(mesh=data, config=dict(sync=False, async_avg_every=3)),
             dst=dict(mesh=data)),
        dict(name="diloco-2-1", src=dict(mesh=data, config=dl),
             dst=dict(config=dict(dl, diloco_workers=1))),
    ]
    res = run_world("ckpt", 2, tmp_path, dict(train=toks[:64], val=toks[64:]),
                    dict(dir=d, model=LM, runs=runs,
                         config=dict(epochs=1, batch_size=16, log_frequency=10**9, logs_path="",
                                     compute_dtype="float32")))
    assert not any(r["jax_loaded"] or r["jax_package_loaded"] for r in res)

    def flat(x):
        if isinstance(x, dict):
            return [v for k in x for v in flat(x[k])]
        if isinstance(x, list):
            return [v for k in x for v in flat(k)]
        return [x]

    modes = {"dp-zero": "zero", "zero-dp": "dp", "pp-dp": "dp", "async-dp": "dp",
             "diloco-2-1": "diloco"}
    for rank in res:
        for name, r in rank["result"].items():
            s, t = r["src"], r["dst"]
            assert r["start_step"] == s["step"] == t["step"] == 4, name
            a, b = flat(s["params"]) + flat(s["opt"]), flat(t["params"]) + flat(t["opt"])
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), name
            assert r["dst_mode"] == modes[name]
            assert r["src_layout"]["world"] == 2 and r["src_layout"]["global_batch"] == 16
    r = res[0]["result"]
    assert r["pp-dp"]["src_layout"]["stages"] == 2
    assert r["async-dp"]["src_layout"]["replicas"] == 2
    assert r["diloco-2-1"]["src_layout"]["replicas"] == 2
    assert all(np.array_equal(x, y) for x, y in zip(flat(r["diloco-2-1"]["src_outer"]),
                                                    flat(r["diloco-2-1"]["dst_outer"])))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_async_snapshot_of_card_tensors_and_restore_on_the_card(tmp_path):
    """An async save of card tensors that the caller then overwrites on the
    card commits the values of the save boundary (the snapshot is a copy
    in host memory, done before save returns); a restore places every leaf
    on the card, bit for bit; the CRC backend is the native one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState
    from distributed_tensorflow_tpu_torch.runtime import native
    from distributed_tensorflow_tpu_torch.train import failpoints

    assert native.backend() == "native"
    st = TrainState({"w": torch.randn(256, 256, device="cuda"),
                     "h": torch.randn(64, device="cuda").to(torch.bfloat16)}, (), 3)
    want = {k: v.clone() for k, v in st.params.items()}
    sup = Supervisor(checkpoint_dir=str(tmp_path), async_checkpoint=True)
    failpoints.configure("ckpt.async:delay=0.2")
    try:
        sup.save(st, 3)
        st.params["w"].mul_(0.0)
        sup.wait_pending()
    finally:
        failpoints.reset()
    fresh = TrainState({k: torch.zeros_like(v) for k, v in want.items()}, (), 0)
    got, step = Supervisor(checkpoint_dir=str(tmp_path)).prepare_or_restore(fresh)
    assert step == 3 and all(got.params[k].device.type == "cuda" for k in want)
    assert all(torch.equal(got.params[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# The examples.
# ---------------------------------------------------------------------------


def test_resilient_example_runs_and_resumes(tmp_path, monkeypatch):
    """The port's ``examples/resilient.py`` on the CPU: a fresh start with
    durable checkpoints (manifests, retention), then a second run resuming
    from the newest valid step through the same ``DTF_CHECKPOINT``."""
    from distributed_tensorflow_tpu_torch.examples import resilient
    from distributed_tensorflow_tpu_torch.train.supervisor import latest_checkpoint_step

    ck = str(tmp_path / "ck")
    for k, v in dict(DTF_CHECKPOINT=ck, DTF_EPOCHS="1", DTF_DEVICE="cpu", DTF_LOGS="").items():
        monkeypatch.setenv(k, v)
    lines = []
    resilient.main(print_fn=lines.append, datasets=_mlp_ds())
    assert "fresh start" in lines and any(ln.startswith("Test-Accuracy:") for ln in lines)
    step = latest_checkpoint_step(ck, verify=True)
    assert step == 8
    lines.clear()
    res = resilient.main(print_fn=lines.append, datasets=_mlp_ds())
    assert f"resuming from step {step}" in lines and res["global_step"] == 2 * step


def test_legacy_dist_example_ps_task_is_a_no_op():
    """The port's ``examples/legacy_dist.py``: its hard-coded cluster, async
    every 50 steps; a ps task sets up and exits without training."""
    from distributed_tensorflow_tpu_torch.examples import legacy_dist

    assert legacy_dist.worker_svrs == ["10.88.104.31:2222", "10.88.102.119:2222"]
    assert legacy_dist.main(["--job_name=ps", "--task_index=0"], device="cpu") is None
