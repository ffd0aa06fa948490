"""PyTorch port, sequence-parallel GPT training and LM data parallelism:
``make_lm_sp_train_step`` / ``make_lm_sp_parts`` on gloo worlds of 4 ranks
(``tests/_torch_dist.py``) laid out as ``("data", "seq")`` meshes of 2×2
and 1×4, the LM's data-parallel step on a ``("data",)`` mesh of 4, and
``LMTrainer`` in its dp and sp modes, each against the port's
single-device step (or trainer) on the global batch and, where the JAX
package runs the same function on the CPU, against JAX on a mesh of the
same shape (the 8 virtual devices of ``tests/conftest.py``). Also the
ragged exact loss, the transformer classifier's sequence-parallel forward
against JAX's, and the refusals.

Tolerances. Against the port's own single-device step, those of JAX's
test of its sp step (``tests/test_gpt.py:1751``): the loss within rtol
1e-5, the parameters after 3 Adam steps within rtol 1e-4, atol 3e-6.
Against JAX, those of the port's single-device LM parity tests
(``tests/test_torch_lm.py``): the loss within 1e-5, the parameters within
5e-5 (Adam's m/√v magnifies last-bit differences of a gradient near 0).
The trainers' final parameters after 4 Adam steps also within 5e-5 of
the single-device trainer's (one element of 2,048 in a dp×sp run moved
3.6e-5: a gradient near 0 summed in another order, which Adam's m/√v
magnifies). The classifier's probabilities within rtol 2e-4, atol 2e-5
(JAX's ``test_sequence_parallel_matches_dense``).
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest
import torch

from _torch_dist import run_world_once
from _torch_parity import SMALL, jax_model, jax_params, numpy_params, torch_params

STEPS, BATCH, LEN = 3, 8, 32
LOSS_TOL, PARAM_RTOL, PARAM_ATOL, JAX_PARAM_TOL = 1e-5, 1e-4, 3e-6, 5e-5
FLASH = dict(attention_impl="flash", flash_min_len=0)
GQA_WINDOW = dict(num_kv_heads=2, window=6)
TRAIN_CFG = dict(epochs=1, batch_size=BATCH, log_frequency=1, compute_dtype="float32",
                 optimizer="adam", learning_rate=1e-3)
# name -> (kind, mesh shape, axes, model knobs, sp attention, extra)
RUNS = {
    "sp22_ring": ("sp", (2, 2), ("data", "seq"), {}, "ring", {}),
    "sp22_ulysses": ("sp", (2, 2), ("data", "seq"), {}, "ulysses", {}),
    "sp14_flash_window": ("sp", (1, 4), ("data", "seq"), {**FLASH, **GQA_WINDOW}, "ring_flash",
                          {}),
    "sp22_flash": ("sp", (2, 2), ("data", "seq"), FLASH, "ring_flash", {}),
    "sp14_remat": ("sp", (1, 4), ("data", "seq"), {**FLASH, **GQA_WINDOW, "remat": True},
                   "ring_flash", {}),
    "ragged22": ("ragged", (2, 2), ("data", "seq"), {**FLASH, **GQA_WINDOW}, "ring_flash", {}),
    "dp4": ("dp", (4,), ("data",), {}, None, {}),
    "trainer_sp": ("trainer", (1, 4), ("data", "seq"), {**FLASH, **GQA_WINDOW}, "ring_flash",
                   {"config": {**TRAIN_CFG, "dp_mode": "sp"}}),
    "trainer_dpsp": ("trainer", (2, 2), ("data", "seq"), {}, None,
                     {"config": {**TRAIN_CFG, "dp_mode": "sp"}}),
    "trainer_dp": ("trainer", (4,), ("data",), {}, None, {"config": TRAIN_CFG}),
    "transformer_ring": ("transformer", (4,), ("seq",), {}, "ring", {}),
    "transformer_ring_flash": ("transformer", (4,), ("seq",), {}, "ring_flash", {}),
    "transformer_ulysses": ("transformer", (4,), ("seq",), {}, "ulysses", {}),
}


def _flat(tree: dict, prefix: str) -> dict:
    out = {f"{prefix}/{k}": v for k, v in tree.items() if k != "blocks"}
    out.update({f"{prefix}/blocks/{k}": v for k, v in tree["blocks"].items()})
    return out


def _prefix(model_kw) -> str:
    """The inputs' parameter set of a model: "g" for GQA, "p" otherwise."""
    return "g" if "num_kv_heads" in model_kw else "p"


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(61)
    trees = {"p": numpy_params(jax_model(), seed=61),
             "g": numpy_params(jax_model(num_kv_heads=2), seed=62)}
    toks = rng.integers(0, SMALL["vocab_size"], (STEPS, BATCH, LEN)).astype(np.int32)
    lengths = rng.integers(5, LEN + 1, BATCH).astype(np.int32)
    ra = rng.integers(0, SMALL["vocab_size"], (BATCH, LEN)).astype(np.int32)
    rb = ra.copy()
    for b, n in enumerate(lengths):
        rb[b, n:] = (rb[b, n:] + 13) % SMALL["vocab_size"]
    train = rng.integers(0, SMALL["vocab_size"], (4 * BATCH, LEN)).astype(np.int32)
    val = rng.integers(0, SMALL["vocab_size"], (16, LEN)).astype(np.int32)
    from distributed_tensorflow_tpu.models.transformer import TransformerClassifier

    import jax.numpy as jnp

    tf = TransformerClassifier(compute_dtype=jnp.float32).init(seed=1)
    tf = {f"tf/{k}": np.asarray(v) + (0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
          for k, v in tf._asdict().items()}
    tf_x = rng.random((4, 784), dtype=np.float32)
    return trees, dict(**_flat(trees["p"], "p"), **_flat(trees["g"], "g"), tokens=toks,
                       lengths=lengths, ragged_a=ra, ragged_b=rb, train=train, val=val,
                       tf_x=tf_x, **tf)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    trees, inp = _data()
    runs = [dict(name=k, kind=v[0], shape=list(v[1]), axes=list(v[2]),
                 model={**SMALL, **v[3]}, attention=v[4], steps=STEPS, params=_prefix(v[3]),
                 **v[5]) for k, v in RUNS.items()]
    out = run_world_once("sp", 4, tmp_path_factory, inp, {"runs": runs})
    for r in out:
        assert not r["jax_loaded"] and not r["jax_package_loaded"]
    return trees, inp, [r["result"] for r in out]


def _leaves(tree):
    return [tree[k] for k in sorted(k for k in tree if k != "blocks")] + \
        [tree["blocks"][k] for k in sorted(tree["blocks"])]


def _port_leaves(p):
    from distributed_tensorflow_tpu_torch.convert import gpt_params_to_numpy

    return _leaves(gpt_params_to_numpy(p))


def _single(tree, model_kw, toks):
    """The port's single-device step on the global batches."""
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim

    model = torch_model_kw(model_kw)
    opt = optim.adam(1e-3)
    step = make_lm_train_step(model, opt)
    p = torch_params(tree)
    o, losses = opt.init(p), []
    for t in toks:
        p, o, loss = step(p, o, torch.from_numpy(t))
        losses.append(float(loss))
    return _port_leaves(p), losses


def torch_model_kw(kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(**{**SMALL, **kw}, compute_dtype=torch.float32)


def _jax_steps(tree, model_kw, step_fn, toks):
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import optim as joptim

    opt = joptim.make("adam", 1e-3)
    step = step_fn(jax_model(**model_kw), opt)
    p = jax_params(tree)
    o, losses = opt.init(p), []
    for t in toks:
        p, o, loss = step(p, o, jnp.asarray(t))
        losses.append(float(loss))
    leaves = {k: np.asarray(v) for k, v in p._asdict().items() if k != "blocks"}
    leaves["blocks"] = {k: np.asarray(v) for k, v in p.blocks._asdict().items()}
    return _leaves(leaves), losses


def _jax_mesh(shape, axes):
    import jax

    from distributed_tensorflow_tpu.parallel import make_mesh

    return make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])


def _close(got, want, rtol, atol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("name", ["sp22_ring", "sp22_ulysses", "sp14_flash_window",
                                  "sp22_flash", "sp14_remat"])
def test_sp_step_matches_single_device(world, name):
    """Every rank's parameters and losses after 3 Adam steps equal the
    port's single-device step on the global batches, at the JAX sp test's
    tolerances; the ranks agree bit for bit (one all-reduce of the summed
    gradients). ``remat=True`` recomputes each block, its ring hops
    included, in the backward."""
    trees, inp, res = world
    model_kw = RUNS[name][3]
    want, want_losses = _single(trees[_prefix(model_kw)], model_kw, inp["tokens"])
    got = [_leaves(r[name]["params"]) for r in res]
    for g in got[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(g, got[0]))
    np.testing.assert_allclose(res[0][name]["losses"], want_losses, rtol=LOSS_TOL)
    _close(got[0], want, PARAM_RTOL, PARAM_ATOL, name)


@pytest.mark.parametrize("name", ["sp22_ring"])
def test_sp_step_matches_jax(world, name):
    """The same steps against JAX ``make_lm_sp_train_step`` on a 2×2
    ("data", "seq") mesh, on the XLA ring. (JAX's Pallas ring-flash needs
    check_vma=False, which its sp step does not take on the CPU, and the
    JAX installed here fails to differentiate its Ulysses all-to-all, a
    cotangent layout error inside ``jax.value_and_grad``; the port's
    ring-flash and Ulysses steps are held to its single-device step.)"""
    from distributed_tensorflow_tpu.models.gpt import make_lm_sp_train_step

    trees, inp, res = world
    mesh = _jax_mesh((2, 2), ("data", "seq"))
    want, losses = _jax_steps(trees["p"], {}, lambda m, o: make_lm_sp_train_step(
        m, o, mesh, data_axis="data", attention=RUNS[name][4]), inp["tokens"])
    np.testing.assert_allclose(res[0][name]["losses"], losses, rtol=LOSS_TOL)
    _close(_leaves(res[0][name]["params"]), want, 0, JAX_PARAM_TOL, name)


def test_sp_ragged_loss_exact_and_pad_independent(world):
    """The ragged sp loss is the single-device masked loss (the global
    masked mean, not a mean of shard means), and the update does not
    depend on the tokens past each length (JAX :1797), under GQA and a
    window (the bounded ring with its offset hops)."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    trees, inp, res = world
    out = res[0]["ragged22"]
    assert out["losses"][0] == out["losses"][1]
    for a, b in zip(_leaves(out["params"][0]), _leaves(out["params"][1])):
        np.testing.assert_array_equal(a, b)
    model = GPTLM(**{**SMALL, **FLASH, **GQA_WINDOW}, compute_dtype=torch.float32)
    with torch.no_grad():
        want = float(model.loss(torch_params(trees["g"]), torch.from_numpy(inp["ragged_a"]),
                                torch.from_numpy(inp["lengths"])))
    np.testing.assert_allclose(out["losses"][0], want, rtol=1e-5)


def test_lm_dp_step_matches_jax_and_single_device(world):
    """make_lm_train_step(model, opt, mesh, "data") on 4 ranks: the batch
    split over "data", gradients and loss averaged; against the JAX dp step
    on a mesh of 4 and the port's single-device step."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_train_step as jstep

    trees, inp, res = world
    got = res[0]["dp4"]
    want, losses = _single(trees["p"], {}, inp["tokens"])
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    _close(_leaves(got["params"]), want, PARAM_RTOL, PARAM_ATOL, "dp vs single")
    mesh = _jax_mesh((4,), ("data",))
    jwant, jlosses = _jax_steps(trees["p"], {}, lambda m, o: jstep(m, o, mesh, "data"),
                                inp["tokens"])
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_TOL)
    _close(_leaves(got["params"]), jwant, 0, JAX_PARAM_TOL, "dp vs jax")


def _no_times(lines):
    return [re.sub(r",\s+AvgTime: .*", "", x) for x in lines if not x.startswith("Total Time")]


@pytest.mark.parametrize("name", ["trainer_sp", "trainer_dpsp", "trainer_dp"])
def test_lm_trainer_parallel_modes_match_single_device(world, name):
    """LMTrainer(mesh=..., dp_mode="sp" | "replicated"): the mode, the
    chief's lines (costs to 4 decimals, the held-out perplexity), the other
    ranks' step lines only, and the final parameters against the same
    trainer on one device."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    trees, inp, res = world
    kind, shape, axes, model_kw, attention, extra = RUNS[name]
    ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                       TokenDataset(inp["val"], seed=3))
    lines = []
    tr = LMTrainer(torch_model_kw(model_kw), ds, TrainConfig(**extra["config"]), device="cpu",
                   print_fn=lines.append, optimizer=optim.adam(1e-3))
    tr.state = tr._init_state(torch_params(trees[_prefix(model_kw)]))
    want = tr.run()
    assert res[0][name]["mode"] == ("dp" if name == "trainer_dp" else "sp")
    assert _no_times(res[0][name]["lines"])[:-3] == _no_times(lines)[:-3]
    got = res[0][name]["result"]
    assert got["global_step"] == want["global_step"] == 4
    np.testing.assert_allclose([got["perplexity"], got["final_cost"]],
                               [want["perplexity"], want["final_cost"]], rtol=1e-5)
    for r in res[1:]:
        assert all(x.startswith("Step: ") for x in r[name]["lines"])
    _close(_leaves(res[0][name]["params"]), _port_leaves(tr.state.params), 0, JAX_PARAM_TOL,
           name)


@pytest.mark.parametrize("attention", ["ring", "ring_flash", "ulysses"])
def test_transformer_sequence_parallel_matches_jax(world, attention):
    """TransformerClassifier.apply_sequence_parallel on 4 ranks (4 heads:
    Ulysses' divisibility holds) against JAX's dense forward (which JAX's
    ``tests/test_transformer.py:30`` holds its three sequence-parallel
    forwards to) and the port's."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.transformer import (
        TransformerClassifier,
        TransformerParams,
    )
    from distributed_tensorflow_tpu_torch.convert import transformer_params_from_numpy
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerClassifier as TorchTransformer,
    )

    _, inp, res = world
    model = TransformerClassifier(compute_dtype=jnp.float32)
    tp = {k.split("/", 1)[1]: v for k, v in inp.items() if k.startswith("tf/")}
    params = TransformerParams(**{k: jnp.asarray(v) for k, v in tp.items()})
    got = [r[f"transformer_{attention}"] for r in res]
    want = np.asarray(model.apply(params, jnp.asarray(inp["tf_x"])))
    for g in got:
        np.testing.assert_allclose(g, want, rtol=2e-4, atol=2e-5)
    dense = TorchTransformer(compute_dtype=torch.float32).apply(
        transformer_params_from_numpy(tp, "cpu"), torch.from_numpy(inp["tf_x"]))
    np.testing.assert_allclose(got[0], dense.numpy(), rtol=2e-4, atol=2e-5)


def _fake_mesh(shape, axes=("data", "seq")):
    """A Mesh of rank 0 with no groups: enough for the checks that read
    only its shape (no collective runs)."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    return Mesh(dict(zip(axes, shape)), 0, torch.device("cpu"), None, {})


def test_sp_refusals_match_jax():
    """The sequence-parallel refusals in the JAX package's words: MoE
    blocks, a sequence past max_len, Ulysses with heads the axis does not
    divide, an unknown attention; make_lm_sp_parts' axis checks against
    JAX's own on a mesh of the same shape."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_sp_parts as jparts
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, make_lm_sp_parts
    from distributed_tensorflow_tpu_torch.ops import optim

    mesh = _fake_mesh((2, 4))
    toks = torch.zeros(2, 16, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="MoE blocks are not supported on the "
                                                  "sequence-parallel path"):
        GPTLM(**SMALL, moe_experts=4).apply_sequence_parallel(None, toks, mesh)
    m = GPTLM(**SMALL, compute_dtype=torch.float32)
    p = m.init(1, device="cpu")
    with pytest.raises(ValueError, match=r"global sequence 128 exceeds max_len 64"):
        m.apply_sequence_parallel(p, torch.zeros(2, 32, dtype=torch.long), mesh)
    with pytest.raises(ValueError, match=r"ulysses needs heads \(4\) and kv heads \(2\) "
                                         r"divisible by the axis size 4"):
        GPTLM(**SMALL, num_kv_heads=2).apply_sequence_parallel(p, toks, mesh,
                                                              attention="ulysses")
    with pytest.raises(ValueError, match="unknown attention 'dense'; ring|ring_flash|ulysses"):
        m.apply_sequence_parallel(p, toks, mesh, attention="dense")
    jmesh = _jax_mesh((2, 4), ("data", "seq"))
    jm = jax_model()
    for kw, err, msg in ((dict(data_axis="nope"), ValueError, "mesh has no 'nope' axis"),
                         (dict(data_axis="seq"), ValueError, "must differ")):
        with pytest.raises(err, match=msg):
            jparts(jm, joptim.make("adam", 1e-3), jmesh, "seq", **kw)
        with pytest.raises(err, match=msg):
            make_lm_sp_parts(m, optim.adam(1e-3), mesh, "seq", **kw)
    for fn, model, opt in ((jparts, jax_model(moe_experts=4), joptim.make("adam", 1e-3)),
                           (make_lm_sp_parts, GPTLM(**SMALL, moe_experts=4), optim.adam(1e-3))):
        with pytest.raises(NotImplementedError, match="expert parallelism"):
            fn(model, opt, jmesh if fn is jparts else mesh)


def test_lm_trainer_mode_refusals():
    """LMTrainer's mode checks (JAX lm_trainer.py:540-565): dp_mode="sp"
    needs a seq axis that divides the sequence, no MoE blocks, and a batch
    the data axis divides; the data-parallel mode needs the data axis; the
    LM's ZeRO and async modes with a mesh, refused naming A7d until the
    local-SGD slice, are built."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    t = np.zeros((64, 15), np.int32)  # sequences of 15 tokens
    ds = TokenDatasets(TokenDataset(t), TokenDataset(t[:8]), TokenDataset(t[:8]))
    model = GPTLM(vocab_size=61, max_len=32, model_dim=32, num_heads=4, num_layers=1)
    sp = TrainConfig(dp_mode="sp", batch_size=6)
    cases = (
        (dict(mesh=_fake_mesh((2,), ("data",))), sp, ValueError,
         "dp_mode='sp' needs a 'seq' mesh axis"),
        (dict(mesh=_fake_mesh((1, 2))), sp, ValueError,
         "dp_mode='sp' shards the 15-token sequence over the 2-way 'seq' axis: must divide"),
        (dict(mesh=_fake_mesh((4, 1))), sp, ValueError,
         "dp×sp shards the batch over the 4-way 'data' axis: batch_size 6 must divide"),
        (dict(mesh=_fake_mesh((1,), ("seq",))), TrainConfig(batch_size=6), ValueError,
         "mesh has no 'data' axis"),
        (dict(mesh=_fake_mesh((4,), ("data",))), TrainConfig(batch_size=6), ValueError,
         "batch_size 6 must be divisible by the axis size 4"),
    )
    for kw, cfg, err, msg in cases:
        with pytest.raises(err, match=msg):
            LMTrainer(model, ds, cfg, device="cpu", **kw)
    for cfg, mode in ((TrainConfig(dp_mode="zero", batch_size=6), "zero"),
                      (TrainConfig(sync=False, batch_size=6), "async")):
        assert LMTrainer(model, ds, cfg, device="cpu",
                         mesh=_fake_mesh((2,), ("data",))).mode == mode
    with pytest.raises(ValueError, match="dp_mode='sp' is not defined for MoE blocks"):
        LMTrainer(GPTLM(vocab_size=61, max_len=32, model_dim=32, num_heads=4, num_layers=1,
                        moe_experts=4), ds, sp, device="cpu", mesh=_fake_mesh((1, 1)))
    # Without a mesh every dp_mode trains on one device, as in JAX.
    assert LMTrainer(model, ds, sp, device="cpu").mode == "single"


@pytest.mark.parametrize("field,value", [
    ("sync_every", 4), ("outer_lr", 0.7), ("outer_momentum", 0.9), ("diloco_workers", 2),
    ("delta_dtype", "int8"), ("delta_overlap", True), ("stale_limit", 2)])
def test_diloco_fields_refused_naming_a7d(field, value):
    """The JAX TrainConfig's DiLoCo fields, refused naming ROADMAP A7d until
    the local-SGD slice, are taken with dp_mode="diloco" (which is taken
    too), the mailbox gang's ``stale_limit`` too since the checkpoint slice
    (and, as in JAX, only under dp_mode="diloco"). "ep" and "pp", once
    refused naming A7c, are taken."""
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu_torch.config import TrainConfig

    import dataclasses

    assert field in {f.name for f in dataclasses.fields(JConfig)}  # a JAX field
    assert getattr(TrainConfig(dp_mode="diloco", **{field: value}), field) == value
    if field == "stale_limit":
        with pytest.raises(ValueError, match="silently ignored"):
            TrainConfig(**{field: value})
    assert TrainConfig(dp_mode="diloco").dp_mode == "diloco"
    assert TrainConfig(dp_mode="sp").dp_mode == "sp"
    assert TrainConfig(dp_mode="tp").dp_mode == "tp"  # lifted by the tensor-parallel slice
    for mode in ("ep", "pp"):  # lifted by the expert- and pipeline-parallel slice
        assert TrainConfig(dp_mode=mode).dp_mode == mode
