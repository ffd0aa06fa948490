"""PyTorch port, pipeline parallelism: ``parallel/pipeline.py``
(``pipeline_apply``, ``microbatch``), ``GPTLM.pipeline_stage_blocks`` /
``apply_pipeline_parallel``, ``pipeline_parallel_specs`` /
``pipeline_stage_params``, ``make_lm_pp_parts`` / ``make_lm_pp_train_step``
(pp, dp×pp, remat, ragged), ``LMTrainer(dp_mode="pp")`` and the numpy round
trip of a pipeline state, on the one 4-rank gloo world of
``tests/_torch_ep_pp.py`` (meshes of (4,) ``("stage",)``, (2, 2) ``("data",
"stage")`` and (1, 4)), each against the JAX package on the CPU (its
sequential and single-device references, and its shard_map pipeline on a
mesh of the same shape: 4 of the 8 virtual devices of
``tests/conftest.py``) or the port's single-device step and trainer. JAX's
8-stage cases run here at 4 stages, on both sides, and its 8-device dp×pp
test (``tests/test_gpt.py:1635``, (2, 4)) at (2, 2).

Tolerances. The pipeline against the sequential stages,
``tests/test_pipeline.py``'s: rtol 2e-4, atol 2e-5 (outputs and
gradients). The GPT forward against ``GPTLM.apply``,
``tests/test_gpt.py:1154``'s: rtol 2e-4, atol 2e-5. The steps against the
single-device step, ``tests/test_gpt.py:1228``'s and ``:1635``'s: the loss
within rtol 1e-5, the parameters after 3 Adam steps within rtol 1e-4, atol
2e-6 (pp) and 3e-6 (dp×pp); against JAX's own steps the parameters within
5e-5 absolute (the port's other parallel-LM tests' bound). Remat against
no remat, ``:1262``'s: the loss within rel 1e-6, the parameters within atol
1e-6. The ragged loss against the dense masked loss, ``:1680``'s: rtol
1e-6. The trainers against the port's single-device trainer: perplexity
and final cost within rtol 1e-5, the final parameters within 5e-5.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from _torch_ep_pp import DS, FLASH, RUNS, SMALL, TRAIN_CFG, ep_pp_world
from _torch_parity import jax_model, jax_params, torch_params

LOSS_RTOL, PARAM_RTOL, JAX_PARAM_TOL = 1e-5, 1e-4, 5e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return ep_pp_world(tmp_path_factory)


def _leaves(tree):
    return [tree[k] for k in sorted(k for k in tree if k != "blocks")] + \
        [tree["blocks"][k] for k in sorted(tree["blocks"])]


def _jax_leaves(p):
    tree = {k: np.asarray(v) for k, v in p._asdict().items() if k != "blocks"}
    tree["blocks"] = {k: np.asarray(v) for k, v in p.blocks._asdict().items()}
    return _leaves(tree)


def _port_leaves(p):
    from distributed_tensorflow_tpu_torch.convert import gpt_params_to_numpy

    return _leaves(gpt_params_to_numpy(p))


def _jax_mesh(shape, axes):
    import jax

    from distributed_tensorflow_tpu.parallel import make_mesh

    return make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])


def _close(got, want, rtol, atol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")


def _torch_model(kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(**{**SMALL, **kw}, compute_dtype=torch.float32)


def _single(tree, model_kw, toks, opt):
    """The port's single-device step on the global batches."""
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step

    step = make_lm_train_step(_torch_model(model_kw), opt)
    p = torch_params(tree)
    o, losses = opt.init(p), []
    for t in toks:
        p, o, loss = step(p, o, torch.from_numpy(t))
        losses.append(float(loss))
    return _port_leaves(p), losses


# -- the pipeline -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["pipe_m4", "pipe_m8"])
def test_pipeline_matches_sequential(world, name):
    """pipeline_apply of gelu(x @ w + b) stages on 4 stages with 4 and 8
    microbatches (``tests/test_pipeline.py:34``): every rank's output equals
    the stages applied in turn, and JAX's shard_map pipeline on a 4-device
    mesh; the gradients of sum(c · out) (each rank's stage, and the input's
    on every rank, summed over the stages by ``copy_to``) equal JAX's
    gradients of the sequential stages; the no-grad forward is the same."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.parallel.pipeline import microbatch, pipeline_apply

    _, _, inp, res = world
    m = RUNS[name][5]["m"]
    w, b, x, c = (jnp.asarray(inp[f"pipe/{k}"]) for k in "wbxc")

    def sequential(w, b, x):
        for i in range(w.shape[0]):
            x = jax.nn.gelu(x @ w[i] + b[i])
        return x

    want = np.asarray(sequential(w, b, x))
    gw, gb, gx = jax.grad(lambda *a: jnp.sum(sequential(*a) * c), argnums=(0, 1, 2))(w, b, x)
    mesh = _jax_mesh((4,), ("stage",))
    jfn = jax.jit(jax.shard_map(
        lambda p, xs: pipeline_apply(lambda q, h: jax.nn.gelu(h @ q[0][0] + q[1][0]), p, xs,
                                     "stage"),
        mesh=mesh, in_specs=((P("stage"), P("stage")), P()), out_specs=P()))
    jout = np.asarray(jfn((w, b), microbatch(x, m))).reshape(x.shape)
    for s, r in enumerate(res):
        got = r[name]
        np.testing.assert_allclose(got["y"], want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["y"], jout, rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(got["no_grad"], got["y"])
        np.testing.assert_allclose(got["w"][0], gw[s], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["b"][0], gb[s], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["x"], gx, rtol=2e-4, atol=2e-5)


def test_microbatch_shapes():
    """``microbatch`` (``tests/test_pipeline.py:53``): [16, 3] into 4 is
    [4, 4, 3]; 5 does not divide 16 and is refused (JAX asserts)."""
    from distributed_tensorflow_tpu_torch.parallel.pipeline import microbatch

    assert microbatch(torch.zeros(16, 3), 4).shape == (4, 4, 3)
    with pytest.raises(ValueError, match="does not split into 5 microbatches"):
        microbatch(torch.zeros(16, 3), 5)


# -- the GPT forward ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pp_fwd_s4", "pp_fwd_s2"])
def test_pipeline_parallel_matches_dense(world, name):
    """apply_pipeline_parallel (``tests/test_gpt.py:1154``) on 4 stages of
    one layer and on 2 stages of two (the (2, 2) mesh, the batch the same
    on both data rows), 4 microbatches: every rank's logits equal JAX's
    ``apply``; each rank holds [1, L/S, ...] of every block leaf."""
    trees, _, inp, res = world
    _, shape, _, model_kw, prefix, _ = RUNS[name]
    want = np.asarray(jax_model(**model_kw).apply(jax_params(trees[prefix]), inp["pp_fwd"]))
    s = shape[-1]
    for r in res:
        np.testing.assert_allclose(r[name]["logits"], want, rtol=2e-4, atol=2e-5)
        assert r[name]["wq"] == (1, 4 // s, 32, 32)


def test_pipeline_parallel_stage_layout_validated():
    """pipeline_stage_blocks refuses a stage count that does not divide the
    layers, in JAX's words (``tests/test_gpt.py:1193``), and stages
    layer-major (stage s holds layers s·L/S ..)."""
    m3 = _torch_model(dict(num_layers=3))
    with pytest.raises(ValueError, match="not divisible"):
        m3.pipeline_stage_blocks(m3.init(1, device="cpu").blocks, 2)
    m4 = _torch_model(dict(num_layers=4))
    blocks = m4.init(1, device="cpu").blocks
    staged = m4.pipeline_stage_blocks(blocks, 2)
    assert staged.wq.shape == (2, 2, 32, 32)
    assert torch.equal(staged.wq[1, 0], blocks.wq[2])


# -- the steps ------------------------------------------------------------------------


def test_pp_train_step_matches_single_device(world):
    """make_lm_pp_parts on 4 stages of 2 layers, 4 microbatches, 3 Adam steps
    (``tests/test_gpt.py:1228``, its 8-stage case at 4): the gathered and
    unstaged parameters and every loss equal the port's single-device step
    and JAX's make_lm_pp_train_step on a 4-device mesh; the ranks agree bit
    for bit; each holds its stage's layer group, and Adam's slots follow
    their parameters (a block slot split on the stage dim, embed's
    replicated)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distributed_tensorflow_tpu.models.gpt import (
        make_lm_pp_train_step,
        pipeline_parallel_specs,
        pipeline_stage_params,
    )
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.ops import optim

    trees, _, inp, res = world
    _, _, _, model_kw, prefix, extra = RUNS["pp_step"]
    toks = inp["pp_steps"][:extra["steps"]]
    want, losses = _single(trees[prefix], model_kw, toks, optim.adam(1e-3))
    got = [_leaves(r["pp_step"]["params"]) for r in res]
    for g in got[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(g, got[0]))
    np.testing.assert_allclose(res[0]["pp_step"]["losses"], losses, rtol=LOSS_RTOL)
    _close(got[0], want, PARAM_RTOL, 2e-6, "pp vs single")
    assert res[0]["pp_step"]["wq"] == (1, 2, 32, 32)
    assert res[0]["pp_step"]["slot_wq"] == ["stage"] and res[0]["pp_step"]["slot_embed"] == []
    model = jax_model(**model_kw)
    mesh = _jax_mesh((4,), ("stage",))
    opt = joptim.make("adam", 1e-3)
    step = make_lm_pp_train_step(model, opt, mesh, num_microbatches=4)
    shardings = jax.tree.map(lambda sp: NamedSharding(mesh, sp), pipeline_parallel_specs(model),
                             is_leaf=lambda x: isinstance(x, type(P())))
    p = jax.device_put(pipeline_stage_params(model, jax_params(trees[prefix]), 4), shardings)
    o, jl = opt.init(p), []
    for t in toks:
        p, o, loss = step(p, o, t)
        jl.append(float(loss))
    merged = p._replace(blocks=jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), p.blocks))
    np.testing.assert_allclose(res[0]["pp_step"]["losses"], jl, rtol=LOSS_RTOL)
    _close(got[0], _jax_leaves(merged), 0, JAX_PARAM_TOL, "pp vs jax")


def test_pp_replicated_leaves_agree_across_stages(world):
    """After pp and dp×pp steps every rank holds the same embed, pos and
    final norm, bit for bit: the embedding's input gradient reaches every
    stage through the pipeline's ``copy_to`` (without it the stages'
    replicas drift apart while the loss still matches)."""
    _, _, _, res = world
    for name in ("pp_step", "pp_dp", "pp_remat_on", "pp_flash_selective"):
        first = res[0][name]["replicated"]
        for r in res[1:]:
            for k, v in r[name]["replicated"].items():
                np.testing.assert_array_equal(v, first[k], err_msg=f"{name} {k}")


@pytest.mark.parametrize("pair", [("pp_remat_off", "pp_remat_on"),
                                  ("pp_flash", "pp_flash_selective")])
def test_pp_train_step_remat_identical(world, pair):
    """remat around each stage's layer group (``tests/test_gpt.py:1262``:
    4 stages, 2 microbatches, one SGD step at 1e-2) does not change the
    step: True against False, and on the flash path "selective" against
    none; the step equals the single-device step."""
    from distributed_tensorflow_tpu_torch.ops import optim

    trees, _, inp, res = world
    (a, b) = (res[0][n] for n in pair)
    assert a["losses"][0] == pytest.approx(b["losses"][0], rel=1e-6)
    _close(_leaves(b["params"]), _leaves(a["params"]), 0, 1e-6, " vs ".join(pair))
    _, _, _, model_kw, prefix, extra = RUNS[pair[0]]
    want, losses = _single(trees[prefix], model_kw, inp["pp_steps"][:1], optim.sgd(1e-2))
    np.testing.assert_allclose(a["losses"], losses, rtol=LOSS_RTOL)
    _close(_leaves(a["params"]), want, PARAM_RTOL, 2e-6, pair[0])


def test_pp_train_step_dp_composes(world):
    """dp×pp on a (2, 2) ``("data", "stage")`` mesh (``tests/test_gpt.py:1635``
    at (2, 2)): each microbatch's rows split over "data", 3 Adam steps equal
    the single-device step; JAX's refusals: an unknown data axis, and the
    stage axis given as the data axis."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_pp_parts as jparts
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_pp_parts
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    trees, _, inp, res = world
    _, _, _, model_kw, prefix, extra = RUNS["pp_dp"]
    want, losses = _single(trees[prefix], model_kw, inp["pp_dp_steps"], optim.adam(1e-3))
    got = res[0]["pp_dp"]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _close(_leaves(got["params"]), want, PARAM_RTOL, 3e-6, "dp×pp vs single")
    for fn, m, opt, me in ((make_lm_pp_parts, _torch_model(model_kw), optim.adam(1e-3),
                            Mesh({"data": 2, "stage": 2})),
                           (jparts, jax_model(**model_kw), joptim.make("adam", 1e-3),
                            _jax_mesh((2, 2), DS))):
        with pytest.raises(ValueError, match="no 'nope' axis"):
            fn(m, opt, me, data_axis="nope")
        with pytest.raises(ValueError, match="must differ"):
            fn(m, opt, me, data_axis="stage")


def test_pp_ragged_loss_pad_independent(world):
    """The pipeline step's masked CE (``tests/test_gpt.py:1680``): two
    batches that differ only past the lengths give the same loss and
    parameters bit for bit, and the loss equals the dense masked loss."""
    trees, _, inp, res = world
    got = res[0]["pp_ragged"]
    assert got["losses"][0] == got["losses"][1]
    for a, b in zip(_leaves(got["params"][0]), _leaves(got["params"][1])):
        np.testing.assert_array_equal(a, b)
    model = jax_model(num_layers=4)
    dense = float(model.loss(jax_params(trees["d4"]), inp["pp_ragged_a"], inp["pp_lengths"]))
    np.testing.assert_allclose(got["losses"][0], dense, rtol=1e-6)


# -- layouts and refusals ----------------------------------------------------------------


def test_pipeline_parallel_specs_match_jax():
    """pipeline_parallel_specs and pipeline_stage_params against JAX's: the
    same spec tree (``P("stage")`` as ``("stage",)``), the same staged
    shapes; MoE blocks refused in JAX's words."""
    from distributed_tensorflow_tpu.models.gpt import (
        pipeline_parallel_specs as jspecs,
        pipeline_stage_params as jstage,
    )
    from distributed_tensorflow_tpu_torch.models.gpt import (
        pipeline_parallel_specs,
        pipeline_stage_params,
        pipeline_unstage_params,
    )

    kw = dict(num_layers=4)
    for axis in ("stage", "pp"):
        got, want = pipeline_parallel_specs(_torch_model(kw), axis), jspecs(jax_model(**kw), axis)
        assert [tuple(x) for x in want[:2] + want[3:]] == list(got[:2] + got[3:])
        assert [tuple(x) for x in want.blocks] == list(got.blocks)
    tm = _torch_model(kw)
    p = tm.init(1, device="cpu")
    staged = pipeline_stage_params(tm, p, 2)
    jstaged = jstage(jax_model(**kw), jax_model(**kw).init(1), 2)
    assert [tuple(a.shape) for a in staged.blocks] == [a.shape for a in jstaged.blocks]
    back = pipeline_unstage_params(staged)
    assert all(torch.equal(a, b) for a, b in zip(back.blocks, p.blocks))
    for fn, m in ((pipeline_parallel_specs, _torch_model(dict(moe_experts=4))),
                  (jspecs, jax_model(moe_experts=4))):
        with pytest.raises(NotImplementedError, match="expert parallelism"):
            fn(m)


def test_pp_train_step_validates_layout():
    """make_lm_pp_train_step's refusals against JAX's on a 4-stage mesh
    (``tests/test_gpt.py:1284``): 3 layers, and MoE blocks; and
    apply_pipeline_parallel's for MoE blocks."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_pp_train_step as jstep
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_pp_train_step
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    for fn, mk, opt, mesh in ((make_lm_pp_train_step, _torch_model, optim.sgd(1e-2),
                               Mesh({"stage": 4})),
                              (jstep, lambda kw: jax_model(**kw), joptim.make("sgd", 1e-2),
                               _jax_mesh((4,), ("stage",)))):
        with pytest.raises(ValueError, match="not divisible"):
            fn(mk(dict(num_layers=3)), opt, mesh)
        with pytest.raises(NotImplementedError, match="expert parallelism"):
            fn(mk(dict(num_layers=4, moe_experts=4)), opt, mesh)
    moe = _torch_model(dict(num_layers=4, moe_experts=4))
    with pytest.raises(NotImplementedError, match="not defined for MoE blocks"):
        moe.apply_pipeline_parallel(moe.init(1, device="cpu"), torch.zeros(4, 8, dtype=torch.int64),
                                    Mesh({"stage": 1}))


def _one_stage(device):
    """apply_pipeline_parallel and the pp step over a stage axis of one rank
    (a layout-only mesh) against apply and the single-device step, dense
    and flash under selective remat; on the card the flash forward launches
    B3 a layer a microbatch."""
    from distributed_tensorflow_tpu_torch.models.gpt import (
        make_lm_pp_train_step,
        make_lm_train_step,
        map_params,
        pipeline_stage_params,
        pipeline_unstage_params,
    )
    from distributed_tensorflow_tpu_torch.ops import _build, optim
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    g = torch.Generator().manual_seed(19)
    toks = torch.randint(0, SMALL["vocab_size"], (8, 16), generator=g).to(device)
    mesh = Mesh({"stage": 1}, device=device)
    exact = device == "cpu"
    for kw in ({}, {**FLASH, "remat": "selective"}):
        model = _torch_model(kw)
        p = map_params(model.init(1, device="cpu"),
                       lambda t: (t + 0.05 * torch.randn(t.shape, generator=g)).to(device))
        staged = pipeline_stage_params(model, p, 1)
        before = _build.LAUNCHES["flash_fwd"]
        with torch.no_grad():
            want, got = model.apply(p, toks), model.apply_pipeline_parallel(staged, toks, mesh)
        if exact:
            assert torch.equal(want, got)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert _build.LAUNCHES["flash_fwd"] - before == (
                SMALL["num_layers"] * (1 + 4) if kw else 0)  # apply, then 4 microbatches
        opt = optim.adam(1e-3)
        a = make_lm_train_step(model, opt)(p, opt.init(p), toks)
        b = make_lm_pp_train_step(model, opt, mesh)(staged, opt.init(staged), toks)
        if exact:
            assert float(a[2]) == float(b[2])
        else:
            assert float(b[2]) == pytest.approx(float(a[2]), rel=LOSS_RTOL)
        for x, y in zip(tree_leaves(a[0]), tree_leaves(pipeline_unstage_params(b[0]))):
            torch.testing.assert_close(y, x, rtol=PARAM_RTOL, atol=2e-6)


def test_pp_on_one_stage_is_the_single_device_step():
    """On a stage axis of one rank the pipeline is the M microbatches in
    turn: the forward equals ``apply`` bit for bit and the step the
    single-device step within f32 rounding of the split batch, on the flash
    path under selective remat too."""
    _one_stage("cpu")


@pytest.mark.cuda
def test_pp_on_one_stage_is_the_single_device_step_on_gpu():
    """The same on the card, through the flash kernels (B3 a layer a
    microbatch, B4a in the backward), within f32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _one_stage("cuda")


# -- the trainer ----------------------------------------------------------------------


def _no_times(lines):
    return [re.sub(r",\s+AvgTime: .*", "", x) for x in lines if not x.startswith("Total Time")]


@pytest.mark.parametrize("name", ["pp_trainer", "pp_trainer_compiled"])
def test_pp_trainer_matches_single(world, name):
    """LMTrainer(mesh=..., dp_mode="pp") (JAX ``tests/test_lm_trainer.py:648``),
    eager dp×pp on (2, 2) and the compiled run on (1, 4) under remat,
    against the port's single-device trainer from the same parameters and
    batches: the mode, the chief's lines (costs to 4 decimals, the held-out
    perplexity at the unstaged parameters), the other ranks' step lines
    only, the canonical parameters and Adam's first moments, each rank's
    staged blocks, evaluate() and the to_canonical / from_canonical round
    trip bit for bit."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    trees, _, inp, res = world
    _, shape, _, model_kw, prefix, extra = RUNS[name]
    ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                       TokenDataset(inp["val"], seed=3))
    lines = []
    cfg = {k: v for k, v in extra["config"].items() if k != "dp_mode"}
    tr = LMTrainer(_torch_model(model_kw), ds, TrainConfig(**cfg), device="cpu",
                   print_fn=lines.append, optimizer=optim.adam(1e-3))
    tr.state = tr._init_state(torch_params(trees[prefix]))
    want = tr.run()
    s = shape[-1]
    for r in res:
        assert r[name]["mode"] == "pp" and r[name]["round_trip"]
        assert r[name]["local"]["wq"] == (1, 4 // s, 32, 32)
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


def test_pp_trainer_refusals_match_jax():
    """The pp mode's refusals in JAX's words (``tests/test_lm_trainer.py:580``):
    a mesh without the stage axis, a batch the microbatches do not divide,
    a microbatch the data axis does not divide, layers the stages do not
    divide; MoE blocks."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    toks = np.zeros((64, 16), np.int32)
    ds = TokenDatasets(TokenDataset(toks), TokenDataset(toks), TokenDataset(toks))

    def make(mesh, model_kw=None, **kw):
        LMTrainer(_torch_model(model_kw or dict(num_layers=4)), ds,
                  TrainConfig(**{**TRAIN_CFG, "dp_mode": "pp", **kw}), device="cpu", mesh=mesh,
                  pp_microbatches=4)

    m24 = Mesh({"data": 2, "stage": 4})
    with pytest.raises(ValueError, match="'stage' mesh axis"):
        make(Mesh({"data": 8}))
    with pytest.raises(ValueError, match="splits the batch into 4 microbatches"):
        make(m24, batch_size=62)
    with pytest.raises(ValueError, match="dp×pp shards each 4-row microbatch over the 8-way"):
        make(Mesh({"data": 8, "stage": 1}))
    with pytest.raises(ValueError, match="not divisible"):
        make(m24, dict(num_layers=3))
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        make(m24, dict(num_layers=4, moe_experts=4))


# -- the numpy round trip ----------------------------------------------------------------


def test_pp_convert_round_trip_is_bitwise(world):
    """A JAX canonical state as numpy (params and Adam's count and moments)
    → each rank's stage of the staged blocks (and the slots that track
    them; embed's whole) → gathered and unstaged back to numpy, bit for
    bit."""
    trees, moments, inp, res = world
    for r in res:
        got = r["pp_convert"]
        for a, b in zip(_leaves(got["params"]), _leaves(trees["d4"])):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for m, want in zip(("mu", "nu"), moments["d4"]):
            for a, b in zip(_leaves(got["adam"][m]), _leaves(want)):
                assert np.array_equal(a, b)
        assert int(got["adam"]["count"]) == int(inp["adam/count"])
        assert got["mu_embed"] == trees["d4"]["embed"].shape


def test_jax_staged_tree_to_canonical():
    """A JAX staged tree (``pipeline_stage_params``) and its Adam state become
    the port's canonical tree through ``convert.unstage_numpy``, bit for
    bit, and train on one device from there."""
    from distributed_tensorflow_tpu.models.gpt import pipeline_stage_params as jstage
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.convert import (
        adam_state_from_numpy,
        gpt_params_from_numpy,
        unstage_numpy,
    )
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    jm = jax_model(num_layers=4)
    p = jm.init(seed=3)
    staged = jstage(jm, p, 2)
    st = joptim.make("adam", 1e-3).init(staged)
    back = unstage_numpy(staged)
    for a, b in zip(_leaves(back), _jax_leaves(p)):
        assert np.array_equal(a, b)
    adam = adam_state_from_numpy({"count": np.asarray(st[0].count),
                                  "mu": unstage_numpy(st[0].mu), "nu": unstage_numpy(st[0].nu)},
                                 "cpu")
    tp = gpt_params_from_numpy(back, device="cpu")
    assert all(tuple(a.shape) == tuple(b.shape) for a, b in
               zip(tree_leaves(adam.mu), tree_leaves(tp)))
