"""PyTorch port, tensor parallelism of GPT training: ``GPTLM.partition_specs``,
``make_lm_train_step(mesh, tp_axis=)`` (dp×tp) and ``(..., seq_axis=)``
(dp×tp×sp), ``LMTrainer(dp_mode="tp")``, Megatron's three collectives and
the numpy round trip of a tensor-parallel state, on the one 4-rank gloo
world of ``tests/_torch_tp.py`` (meshes of (2, 2) and (1, 4) ``("data",
"model")`` and (1, 2, 2) ``("data", "model", "seq")``), each against the
port's single-device step (or trainer) on the global batches and, where the
JAX package runs the same function on the CPU, against JAX's GSPMD step on
a mesh of the same shape (4 of the 8 virtual devices of
``tests/conftest.py``). Also the refusals in JAX's words and the port's
envelope (a dim the axis size does not divide).

Tolerances. Against the port's single-device step, those of JAX's tests of
its tp steps (``tests/test_gpt.py:1515``, ``:1556``): the loss within rtol
1e-5, the parameters after 3 Adam steps within rtol 1e-4, atol 2e-6.
Against JAX, those of the port's other parallel-LM tests
(``tests/test_torch_sp.py``): the loss within 1e-5, the parameters within
5e-5 absolute (Adam's m/√v magnifies last-bit differences of a gradient
near 0, which the all-reduce sums in another order). The trainers' final
parameters after 4 Adam steps within 5e-5 of the single-device trainer's,
their perplexity within rtol 1e-5.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from _torch_parity import SMALL, jax_model, jax_params, torch_params
from _torch_tp import FLASH, GQA, RUNS, TRAIN_CFG, tp_world

LOSS_TOL, PARAM_RTOL, PARAM_ATOL, JAX_PARAM_TOL = 1e-5, 1e-4, 2e-6, 5e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tp_world(tmp_path_factory)


def _leaves(tree):
    return [tree[k] for k in sorted(k for k in tree if k != "blocks")] + \
        [tree["blocks"][k] for k in sorted(tree["blocks"])]


def _port_leaves(p):
    from distributed_tensorflow_tpu_torch.convert import gpt_params_to_numpy

    return _leaves(gpt_params_to_numpy(p))


def _torch_model(kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(**{**SMALL, **kw}, compute_dtype=torch.float32)


def _single(tree, model_kw, toks, clip=None):
    """The port's single-device step on the global batches."""
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim

    opt = optim.adam(1e-3) if clip is None else optim.clip(optim.adam(1e-3), clip)
    step = make_lm_train_step(_torch_model(model_kw), opt)
    p = torch_params(tree)
    o, losses = opt.init(p), []
    for t in toks:
        p, o, loss = step(p, o, torch.from_numpy(t))
        losses.append(float(loss))
    return _port_leaves(p), losses


def _jax_steps(tree, model_kw, make_step, toks, place=lambda p, o: (p, o)):
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import optim as joptim

    opt = joptim.make("adam", 1e-3)
    model = jax_model(**model_kw)
    step = make_step(model, opt)
    p = jax_params(tree)
    p, o = place(p, opt.init(p))
    losses = []
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


# -- layouts ------------------------------------------------------------------


def test_partition_specs_match_jax():
    """GPTLM.partition_specs is JAX's PartitionSpec tree entry for entry
    (``P(None, None, "model")`` as ``(None, None, "model")``), on any axis
    name; MoE blocks are refused in JAX's words."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    for axis in ("model", "tp"):
        got = GPTLM(**SMALL).partition_specs(axis)
        want = jax_model().partition_specs(axis)
        assert [tuple(x) for x in want[:2] + want[3:]] == list(got[:2] + got[3:])
        assert got.blocks._fields == want.blocks._fields
        assert [tuple(x) for x in want.blocks] == list(got.blocks)
    for model in (GPTLM(**SMALL, moe_experts=4), jax_model(moe_experts=4)):
        with pytest.raises(NotImplementedError, match="tensor parallelism is not defined for "
                                                      "the MoE blocks"):
            model.partition_specs()


def test_slot_specs_match_by_path_not_shape():
    """``slot_specs`` lays Adam's moments out like their parameters by tree
    path: wq and wo are both [L, d, d] and split on different dims, and the
    count is replicated; ``shard_tree`` then cuts each as its parameter."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.parallel.specs import shard_tree, slot_specs

    model = GPTLM(**SMALL, compute_dtype=torch.float32)
    params = model.init(1, device="cpu")
    assert params.blocks.wq.shape == params.blocks.wo.shape
    specs = model.partition_specs()
    for opt in (optim.adam(1e-3), optim.accumulate(optim.clip(optim.adam(1e-3), 1.0), 2)):
        slots = slot_specs(opt, params, specs)
        adam = slots if hasattr(slots, "mu") else slots.inner_opt_state
        for tree in (adam.mu, adam.nu):
            assert tree.blocks.wq == (None, None, "model") and tree.blocks.wo == (None, "model",
                                                                                  None)
            assert tree.embed == ()
        assert adam.count == ()
    mesh = Mesh({"data": 1, "model": 2}, rank=1)
    opt = optim.adam(1e-3)
    state = opt.init(params)
    local = shard_tree(state, slot_specs(opt, params, specs), mesh)
    assert local.mu.blocks.wq.shape == (2, 32, 16) and local.mu.blocks.wo.shape == (2, 16, 32)
    assert torch.equal(local.mu.blocks.wo, state.mu.blocks.wo[:, 16:])


# -- the steps ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tp22", "tp14", "tp14_gqa_flash", "tp22_gqa_window_selective",
                                  "tp22_clip", "tp122_ring", "tp122_flash_gqa"])
def test_tp_step_matches_single_device(world, name):
    """Every rank's gathered parameters and losses after 3 Adam steps equal
    the port's single-device step on the global batches: dp×tp on (2, 2),
    pure tp on (1, 4) (a head a rank), the GQA model at tp 4 (the axis
    does not divide its 2 KV heads: k and v gathered), flash with a window
    under selective remat, global-norm clipping (the norm summed over every
    rank's blocks, a replicated leaf once) and dp×tp×sp on (1, 2, 2) over
    the ring and ring-flash. The ranks agree bit for bit."""
    trees, _, _, inp, res = world
    _, _, _, model_kw, prefix, extra = RUNS[name]
    want, want_losses = _single(trees[prefix], model_kw, inp["tokens"], extra.get("clip"))
    got = [_leaves(r[name]["params"]) for r in res]
    for g in got[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(g, got[0]))
    np.testing.assert_allclose(res[0][name]["losses"], want_losses, rtol=LOSS_TOL)
    _close(got[0], want, PARAM_RTOL, PARAM_ATOL, name)


def test_tp_blocks_are_the_local_shards(world):
    """Each rank holds its block of every split leaf: wq's columns of its
    heads (a quarter at tp 4), wo's and w_down's rows, b_up's units; the
    replicated leaves whole and equal on every rank."""
    trees, _, _, _, res = world
    shape = (SMALL["num_layers"], SMALL["model_dim"])
    for name, tp in (("tp22", 2), ("tp14", 4)):
        full = res[0][name]["params"]["blocks"]
        for rank, r in enumerate(res):
            mi = rank % tp
            blk = r[name]["local"]["blocks"]
            assert r[name]["wq"] == (*shape, SMALL["model_dim"] // tp)
            w = SMALL["model_dim"] // tp
            np.testing.assert_array_equal(blk["wq"], full["wq"][:, :, mi * w:(mi + 1) * w])
            np.testing.assert_array_equal(blk["wo"], full["wo"][:, mi * w:(mi + 1) * w])
            u = 4 * SMALL["model_dim"] // tp
            np.testing.assert_array_equal(blk["b_up"], full["b_up"][:, mi * u:(mi + 1) * u])
            np.testing.assert_array_equal(r[name]["local"]["embed"],
                                          res[0][name]["params"]["embed"])


def test_tp_step_matches_jax(world):
    """make_lm_train_step(model, opt, mesh, tp_axis="model") on (2, 2)
    against JAX's GSPMD step (``tests/test_gpt.py:1515``) on a (2, 2) mesh
    of the same layout, 3 Adam steps; and its first step against JAX's
    ordinary jitted step on the tp-placed parameters (``:531``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax

    from distributed_tensorflow_tpu.models.gpt import make_lm_train_step as jstep

    trees, _, _, inp, res = world
    mesh = _jax_mesh((2, 2), ("data", "model"))
    got = res[0]["tp22"]

    def place(p, o):
        sh = jax.tree.map(lambda sp: NamedSharding(mesh, sp), jax_model().partition_specs(),
                          is_leaf=lambda x: isinstance(x, type(P())))
        p = jax.device_put(p, sh)
        return p, o

    want, losses = _jax_steps(trees["p"], {}, lambda m, o: jstep(m, o, mesh, tp_axis="model"),
                              inp["tokens"], place)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    _close(_leaves(got["params"]), want, 0, JAX_PARAM_TOL, "tp vs jax")
    _, first = _jax_steps(trees["p"], {}, lambda m, o: jstep(m, o), inp["tokens"][:1], place)
    np.testing.assert_allclose(got["losses"][0], first[0], rtol=LOSS_TOL)


def test_dp_tp_sp_step_matches_jax(world):
    """make_lm_train_step(..., tp_axis="model", seq_axis="seq") on (1, 2, 2)
    against JAX's 3-D GSPMD step (``tests/test_gpt.py:1556``) on a mesh of
    the same shape: the port composes tp's local heads with the ring over
    "seq", JAX gathers by GSPMD; the same single-device math."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_train_step as jstep

    trees, _, _, inp, res = world
    mesh = _jax_mesh((1, 2, 2), ("data", "model", "seq"))
    want, losses = _jax_steps(trees["p"], {}, lambda m, o: jstep(
        m, o, mesh, tp_axis="model", seq_axis="seq"), inp["tokens"])
    got = res[0]["tp122_ring"]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    _close(_leaves(got["params"]), want, 0, JAX_PARAM_TOL, "dp×tp×sp vs jax")


def test_tp_ragged_loss_exact_and_pad_independent(world):
    """The ragged tp step's loss is the single-device masked loss (the
    global masked mean over the data axis), and its update does not depend
    on the tokens past each length."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    trees, _, _, inp, res = world
    out = res[0]["tp22_ragged"]
    assert out["losses"][0] == out["losses"][1]
    for a, b in zip(_leaves(out["params"][0]), _leaves(out["params"][1])):
        np.testing.assert_array_equal(a, b)
    model = GPTLM(**{**SMALL, **FLASH, **GQA}, compute_dtype=torch.float32)
    with torch.no_grad():
        want = float(model.loss(torch_params(trees["g"]), torch.from_numpy(inp["ragged_a"]),
                                torch.from_numpy(inp["lengths"])))
    np.testing.assert_allclose(out["losses"][0], want, rtol=1e-5)


def test_tp_collectives_forward_and_backward(world):
    """Megatron's operators over a 4-way axis: copy_to the identity with
    the gradient summed; reduce_from the sum with the gradient as it is;
    gather_from the concatenation in axis order with the summed gradient's
    own block (the reduce-scatter)."""
    _, _, _, _, res = world
    n = 4
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(n)]
    for r in range(n):
        got = res[r]["collectives"]
        ws = [np.arange(6, dtype=np.float32).reshape(2, 3) + q for q in range(n)]
        np.testing.assert_array_equal(got["copy_to"]["y"], xs[r])
        np.testing.assert_array_equal(got["copy_to"]["grad"], sum(ws))
        np.testing.assert_array_equal(got["reduce_from"]["y"], sum(xs))
        np.testing.assert_array_equal(got["reduce_from"]["grad"], ws[r])
        np.testing.assert_array_equal(got["gather_from"]["y"], np.concatenate(xs, -1))
        wg = [np.arange(24, dtype=np.float32).reshape(2, 12) + q for q in range(n)]
        np.testing.assert_array_equal(got["gather_from"]["grad"], sum(wg)[:, 3 * r:3 * r + 3])


def test_convert_round_trip_is_bitwise(world):
    """A JAX canonical GPT state as numpy (params and Adam's count and
    moments) → each rank's tp blocks → gathered back to numpy, bit for bit;
    the blocks are the local shapes."""
    trees, _, adam, inp, res = world
    for r in res:
        got = r["convert"]
        assert got["wq"] == (2, 32, 16) and got["mu_wo"] == (2, 16, 32)
        for a, b in zip(_leaves(got["params"]), _leaves(trees["p"])):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for m in ("mu", "nu"):
            for a, b in zip(_leaves(got["adam"][m]), _leaves(adam[m])):
                assert np.array_equal(a, b)
        assert int(got["adam"]["count"]) == int(inp["adam/count"])


# -- the trainer ----------------------------------------------------------------


def _no_times(lines):
    return [re.sub(r",\s+AvgTime: .*", "", x) for x in lines if not x.startswith("Total Time")]


@pytest.mark.parametrize("name", ["trainer_tp", "trainer_tp_compiled"])
def test_tp_trainer_matches_single(world, name):
    """LMTrainer(mesh=..., dp_mode="tp") (JAX ``tests/test_lm_trainer.py:620``),
    eager on (2, 2) and the compiled run on (1, 4) with the GQA flash
    model: the mode, the chief's lines (costs to 4 decimals, the held-out
    perplexity), the other ranks' step lines only, the canonical parameters
    against the same trainer on one device, Adam's slots laid out like
    their parameters, evaluate() under tp, and the to_canonical /
    from_canonical round trip bit for bit."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    trees, _, _, inp, res = world
    kind, shape, axes, model_kw, prefix, extra = RUNS[name]
    ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                       TokenDataset(inp["val"], seed=3))
    lines = []
    cfg = {k: v for k, v in extra["config"].items() if k != "dp_mode"}
    tr = LMTrainer(_torch_model(model_kw), ds, TrainConfig(**cfg), device="cpu",
                   print_fn=lines.append, optimizer=optim.adam(1e-3))
    tr.state = tr._init_state(torch_params(trees[prefix]))
    want = tr.run()
    tp = shape[1]
    for r in res:
        assert r[name]["mode"] == "tp" and r[name]["round_trip"]
        assert r[name]["local_mu_wq"] == (2, 32, 32 // tp)
        assert r[name]["local_mu_wo"] == (2, 32 // tp, 32)
    assert _no_times(res[0][name]["lines"])[:-3] == _no_times(lines)[:-3]
    got = res[0][name]["result"]
    assert got["global_step"] == want["global_step"] == 4
    np.testing.assert_allclose([got["perplexity"], got["final_cost"]],
                               [want["perplexity"], want["final_cost"]], rtol=1e-5)
    np.testing.assert_allclose(res[0][name]["perplexity"], tr.evaluate(), rtol=1e-5)
    for r in res[1:]:
        assert all(x.startswith("Step: ") for x in r[name]["lines"])
    _close(_leaves(res[0][name]["params"]), _port_leaves(tr.state.params), 0, JAX_PARAM_TOL,
           name)
    _close(_leaves(res[0][name]["mu"]), _port_leaves(tr.state.opt_state.mu), 0, 1e-6, name)


def test_tp_trainer_refusals_match_jax():
    """The tp mode's refusals in JAX's words (``tests/test_lm_trainer.py:580``):
    sync=False does not compose, a mesh without the axis, MoE blocks; and
    the port's envelope: a model whose heads the axis does not divide."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    toks = np.zeros((16, 16), np.int32)
    ds = TokenDatasets(TokenDataset(toks), TokenDataset(toks), TokenDataset(toks))
    cfg = dict(TRAIN_CFG)

    def make(mesh, model_kw=None, **kw):
        LMTrainer(_torch_model(model_kw or {}), ds, TrainConfig(**{**cfg, **kw}), device="cpu",
                  mesh=mesh)

    m22 = Mesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="does not compose"):
        make(m22, sync=False)
    with pytest.raises(ValueError, match="'model' mesh axis"):
        make(Mesh({"data": 4}))
    with pytest.raises(ValueError, match="not defined for MoE"):
        make(m22, dict(moe_experts=4, moe_capacity_factor=4.0))
    with pytest.raises(ValueError, match="num_heads = 4 does not split over a 3-way"):
        make(Mesh({"data": 1, "model": 3}))
    with pytest.raises(ValueError, match="batch_size 6 must divide"):
        make(Mesh({"data": 4, "model": 1}), batch_size=6)


def test_make_lm_train_step_refusals_match_jax():
    """make_lm_train_step's tp refusals against JAX's on meshes of the same
    shape: seq_axis without tp_axis, tp_axis without a mesh, an unknown
    seq axis; and the port's envelope: the heads, the KV columns and
    matmul_dtype (4·d splits wherever the heads do)."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_train_step as jstep
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    jmesh = _jax_mesh((2, 2, 1), ("data", "model", "seq"))
    mesh = Mesh({"data": 2, "model": 2, "seq": 1})
    tm, opt, jm, jopt = _torch_model({}), optim.adam(1e-3), jax_model(), joptim.make("adam", 1e-3)
    for kw, match in ((dict(mesh=True, seq_axis="seq"), "composes on the GSPMD tp path"),
                      (dict(tp_axis="model"), "tp_axis requires a mesh"),
                      (dict(mesh=True, tp_axis="model", seq_axis="nope"), "no 'nope' axis")):
        for fn, m, o, me in ((make_lm_train_step, tm, opt, mesh), (jstep, jm, jopt, jmesh)):
            args = dict(kw)
            if args.pop("mesh", False):
                args["mesh"] = me
            with pytest.raises(ValueError, match=match):
                fn(m, o, **args)
    m3 = Mesh({"data": 1, "model": 8})
    with pytest.raises(ValueError, match="num_heads = 4 does not split"):
        make_lm_train_step(tm, opt, m3, tp_axis="model")
    with pytest.raises(ValueError, match=r"KV columns \(num_kv_heads·head_dim\) = 3 does not"):
        make_lm_train_step(_torch_model(dict(model_dim=12, num_kv_heads=1)), opt,
                           Mesh({"data": 1, "model": 4, "seq": 1}), tp_axis="model")
    with pytest.raises(ValueError, match="matmul_dtype='int8'"):
        make_lm_train_step(_torch_model(dict(matmul_dtype="int8")), opt, mesh, tp_axis="model")
    with pytest.raises(ValueError, match="mesh has no 'tensor' axis"):
        make_lm_train_step(tm, opt, mesh, tp_axis="tensor")


def _one_rank_equals_dense(device):
    """The tp forward and step over a model axis of one rank against the
    dense ones, bit for bit, on seeded weights (no residual weight zero)."""
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step, map_params
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.collectives import TensorParallel
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    g = torch.Generator().manual_seed(18)
    toks = torch.randint(0, SMALL["vocab_size"], (4, 16), generator=g).to(device)
    mesh = Mesh({"data": 1, "model": 1}, device=device)
    for kw in ({}, {**FLASH, **GQA}):
        model = _torch_model(kw)
        params = map_params(model.init(1, device="cpu"),
                            lambda t: (t + 0.05 * torch.randn(t.shape, generator=g)).to(device))
        with torch.no_grad():
            assert torch.equal(model.apply(params, toks),
                               model.apply(params, toks, tp=TensorParallel(mesh)))
        opt = optim.adam(1e-3)
        a = make_lm_train_step(model, opt)(params, opt.init(params), toks)
        b = make_lm_train_step(model, opt, mesh, tp_axis="model")(params, opt.init(params), toks)
        assert torch.equal(a[2], b[2])
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])))


def test_tp_on_one_rank_is_the_single_device_step():
    """On a model axis of one rank the tp forward and step are the dense
    ones bit for bit (the operators are the identity; the blocks are the
    whole leaves), for the GQA flash model too."""
    _one_rank_equals_dense("cpu")


@pytest.mark.cuda
def test_tp_on_one_rank_is_the_single_device_step_on_gpu():
    """The same on the card, through the flash kernels (B3, B4a)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _one_rank_equals_dense("cuda")
