"""PyTorch port, expert parallelism: ``ops/moe.moe_ffn`` (the two
all-to-alls), ``GPTLM.apply_expert_parallel``, ``expert_parallel_specs``,
``make_lm_ep_parts`` / ``make_lm_ep_train_step`` (ep and dp×ep, ragged),
``LMTrainer(dp_mode="ep")`` and the numpy round trip of an expert-parallel
state, on the one 4-rank gloo world of ``tests/_torch_ep_pp.py`` (meshes of
(4,) ``("expert",)`` and (2, 2) ``("data", "expert")``), each against the
JAX package on the CPU: its dense references and, where it runs the same
function, its shard_map program on a mesh of the same shape (4 of the 8
virtual devices of ``tests/conftest.py``). JAX's 8-device dp×ep test
(``tests/test_gpt.py:1467``, 4 experts on (2, 4)) runs here at (2, 2) with
2 experts, on both sides. Also the refusals in JAX's words.

Tolerances. The FFN against the dense reference a source block, those of
``tests/test_moe.py``: rtol 2e-4, atol 1e-5 (outputs and gradients). The
forward against ``GPTLM.apply``, ``tests/test_gpt.py:682``'s: rtol 2e-4,
atol 2e-5. The steps: the loss within rtol 1e-5 (``tests/test_gpt.py:1416``'s),
the parameters after one Adam step within 5e-5 absolute, the bound of the
port's other parallel-LM tests against JAX (``tests/test_torch_sp.py``,
``test_torch_tp.py``): Adam's m/√v magnifies last-bit differences of a
gradient near 0, which the port sums in another order (at (2, 2) one
element of w_down in 16,384 sits 3.1e-6 from JAX's, past JAX's own atol
1e-6). The trainer against JAX's ep trainer on the same mesh: its printed
costs within 2e-4 (printed to 4 places), its perplexity within rtol 1e-4,
the final parameters within 5e-5.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest
import torch

from _torch_ep_pp import DE, MOE2, MOE4, MOE_T, RUNS, SMALL, TRAIN_CFG, ep_pp_world
from _torch_parity import jax_model, jax_params

LOSS_RTOL, JAX_PARAM_TOL = 1e-5, 5e-5


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


def _jax_mesh(shape, axes):
    import jax

    from distributed_tensorflow_tpu.parallel import make_mesh

    return make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])


def _close(got, want, rtol, atol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")


def _ep_place(params, model, mesh):
    import jax
    from jax.sharding import NamedSharding

    from distributed_tensorflow_tpu.models.gpt import expert_parallel_specs

    return jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                               expert_parallel_specs(model)))


# -- the FFN ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["moe_k1", "moe_k2"])
def test_moe_ffn_matches_dense_reference(world, name):
    """moe_ffn over a 4-way expert axis (``tests/test_moe.py:55``, :67 and
    :173) equals JAX's ``moe_ffn_dense`` on each rank's block of tokens,
    which reproduces the per-source capacity, at every capacity: drops
    (where dropped tokens give exact zeros), partial drops and none; top-1
    and the renormalized top-2. The gradients of sum(w · out) too: each
    rank's expert's weights and tokens, and the replicated gate's summed
    over the ranks."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops.moe import MoEParams, moe_ffn_dense

    _, _, inp, res = world
    k = RUNS[name][5]["k"]
    params = MoEParams(**{f: jnp.asarray(inp[f"moe/{f}"]) for f in MoEParams._fields})
    x, w = jnp.asarray(inp["moe/x"]), jnp.asarray(inp["moe/w"])
    n = len(res)
    t = x.shape[0] // n
    @functools.partial(jax.jit, static_argnums=2)
    def dense(p, x, cap):
        return jnp.concatenate([moe_ffn_dense(p, x[i * t:(i + 1) * t], cap, k=k)
                                for i in range(n)])

    grad = jax.jit(jax.grad(lambda p, x, cap: jnp.sum(dense(p, x, cap) * w), argnums=(0, 1)),
                   static_argnums=2)
    for cap in RUNS[name][5]["caps"]:
        want = np.asarray(dense(params, x, cap))
        gp, gx = grad(params, x, cap)
        got = [r[name][cap] for r in res]
        y = np.concatenate([g["y"] for g in got])
        np.testing.assert_allclose(y, want, rtol=2e-4, atol=1e-5, err_msg=f"cap {cap}")
        if cap == 1:
            assert np.all(y == 0.0, axis=-1).any(), "capacity 1 must drop tokens"
        if cap == MOE_T:
            assert not np.all(y == 0.0, axis=-1).any()
        np.testing.assert_allclose(np.concatenate([g["x"] for g in got]), gx, rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(sum(g["wg"] for g in got), gp.wg, rtol=2e-4, atol=1e-5)
        for f in ("w_up", "b_up", "w_down", "b_down"):
            np.testing.assert_allclose(np.concatenate([g[f] for g in got]), getattr(gp, f),
                                       rtol=2e-4, atol=1e-5, err_msg=f"{f} cap {cap}")


# -- the forward ----------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_expert_parallel_matches_dense(world, top_k):
    """apply_expert_parallel on a 4-way expert axis (``tests/test_gpt.py:682``):
    each rank's logits on its 2-row shard equal JAX's dense ``apply`` on
    those rows, at a capacity factor where nothing drops (the drop
    fraction is 0 on every rank), for Switch top-1 and top-2."""
    trees, _, inp, res = world
    name = f"ep_fwd_k{top_k}"
    model = jax_model(**RUNS[name][3])
    want = np.asarray(model.apply(jax_params(trees["e4"]), inp["ep_toks"]))
    got = np.concatenate([r[name]["logits"] for r in res])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert all(np.all(r[name]["drop"] == 0) for r in res)


# -- the steps --------------------------------------------------------------------


def _shardwise_step(tree, model_kw, toks, shards):
    """JAX's reference of the ep step (``tests/test_gpt.py:1439``): the mean
    over the shards of each shard's ``model.loss`` (CE and router terms on
    its rows, data-major), one Adam step."""
    import jax
    import optax

    from distributed_tensorflow_tpu.ops import optim as joptim

    model = jax_model(**model_kw)
    params = jax_params(tree)
    b = toks.shape[0] // shards
    opt = joptim.make("adam", 1e-3)

    def ref_total(p):  # the shards' losses, one vmapped program
        return jax.vmap(lambda t: model.loss(p, t))(toks.reshape(shards, b, -1)).mean()

    loss, grads = jax.jit(jax.value_and_grad(ref_total))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    return _jax_leaves(optax.apply_updates(params, updates)), float(loss)


def _jax_ep_step(tree, model_kw, mesh, toks, data_axis=None):
    """JAX's make_lm_ep_train_step on ``mesh``, one Adam step."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_ep_train_step
    from distributed_tensorflow_tpu.ops import optim as joptim

    model = jax_model(**model_kw)
    opt = joptim.make("adam", 1e-3)
    step = make_lm_ep_train_step(model, opt, mesh, data_axis=data_axis)
    p = _ep_place(jax_params(tree), model, mesh)
    p, _, loss = step(p, opt.init(p), toks)
    return _jax_leaves(p), float(loss)


@pytest.mark.parametrize("top_k", [1, 2])
def test_ep_train_step_matches_dense_dp(world, top_k):
    """make_lm_ep_parts on a 4-way expert axis (``tests/test_gpt.py:1416``):
    one Adam step equals JAX's shard-wise reference (the mean of the 4
    shards' losses), top-1 and top-2; the ranks agree bit for bit; the
    expert leaves and their slots are split on dim 1 (a rank holds one
    expert), the rest replicated. (JAX's own step is held on (2, 2) in
    the dp×ep and ragged tests.)"""
    trees, _, inp, res = world
    name = f"ep_step_k{top_k}"
    model_kw = RUNS[name][3]
    toks = inp["ep_steps"][0]
    want, loss = _shardwise_step(trees["e4"], model_kw, toks, 4)
    got = [_leaves(r[name]["params"]) for r in res]
    for g in got[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(g, got[0]))
    np.testing.assert_allclose(res[0][name]["losses"][0], loss, rtol=LOSS_RTOL)
    _close(got[0], want, 0, JAX_PARAM_TOL, name)
    assert res[0][name]["local_w_up"] == (SMALL["num_layers"], 1, 32, 128)
    assert res[0][name]["slot_w_up"] == [None, "expert"] and res[0][name]["slot_wq"] == []


def test_ep_train_step_dp_composes(world):
    """dp×ep on a (2, 2) ``("data", "expert")`` mesh (``tests/test_gpt.py:1467``
    at 2 experts): one Adam step equals JAX's shard-wise reference over the
    4 data-major shards and JAX's make_lm_ep_train_step(data_axis="data") on
    a (2, 2) mesh; an expert leaf is summed over "data" only, a replicated
    one over both axes. JAX's refusals: an unknown data axis, and the
    expert axis given as the data axis."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_ep_train_step as jstep
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, make_lm_ep_train_step
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    trees, _, inp, res = world
    toks = inp["ep_dp_steps"][0]
    got = res[0]["ep_step_dp"]
    want, loss = _shardwise_step(trees["e2"], MOE2, toks, 4)
    np.testing.assert_allclose(got["losses"][0], loss, rtol=LOSS_RTOL)
    _close(_leaves(got["params"]), want, 0, JAX_PARAM_TOL, "dp×ep")
    mesh = _jax_mesh((2, 2), DE)
    jwant, jloss = _jax_ep_step(trees["e2"], MOE2, mesh, toks, data_axis="data")
    np.testing.assert_allclose(got["losses"][0], jloss, rtol=LOSS_RTOL)
    _close(_leaves(got["params"]), jwant, 0, JAX_PARAM_TOL, "dp×ep vs jax")
    tm = GPTLM(**{**SMALL, **MOE2}, compute_dtype=torch.float32)
    for fn, m, opt, me in ((make_lm_ep_train_step, tm, optim.adam(1e-3), Mesh({"data": 2,
                                                                                "expert": 2})),
                           (jstep, jax_model(**MOE2), joptim.make("adam", 1e-3), mesh)):
        with pytest.raises(ValueError, match="no 'nope' axis"):
            fn(m, opt, me, data_axis="nope")
        with pytest.raises(ValueError, match="must differ"):
            fn(m, opt, me, data_axis="expert")


def test_ep_train_step_reduces_loss(world):
    """60 Adam steps (rate 3e-3) of a one-layer 4-expert model on batches
    of half-repeated rows (``tests/test_gpt.py:1612``): the loss ends below
    0.95 of the first step's."""
    _, _, _, res = world
    losses = res[0]["ep_reduces"]["losses"]
    assert len(losses) == 60 and losses[-1] < losses[0] * 0.95, (losses[0], losses[-1])


def test_ep_ragged_step_pad_independent(world):
    """The ragged dp×ep update (``tests/test_gpt.py:1713``, at (2, 2) and 2
    experts, factor 4): two batches that differ only past the lengths give
    the same loss and parameters bit for bit (pads take no capacity and
    stay out of the router's statistics), equal to JAX's ragged
    make_lm_ep_parts on a (2, 2) mesh; and lengths None gives the loss of
    full lengths (``:1834``, JAX's ``_default_lens``)."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.gpt import make_lm_ep_parts
    from distributed_tensorflow_tpu.ops import optim as joptim

    trees, _, inp, res = world
    got = res[0]["ep_ragged"]
    assert got["losses"][0] == got["losses"][1]
    for a, b in zip(_leaves(got["params"][0]), _leaves(got["params"][1])):
        np.testing.assert_array_equal(a, b)
    assert got["none_full"][0] == got["none_full"][1]
    model_kw = RUNS["ep_ragged"][3]
    model = jax_model(**model_kw)
    mesh = _jax_mesh((2, 2), DE)
    opt = joptim.make("adam", 1e-3)
    _, _, mapped = make_lm_ep_parts(model, opt, mesh, data_axis="data", ragged=True)
    mapped = jax.jit(mapped)
    p = _ep_place(jax_params(trees["e2"]), model, mesh)
    jp, _, jloss = mapped(p, opt.init(p), jnp.asarray(inp["ep_ragged_a"]),
                          jnp.asarray(inp["ep_lengths"]))
    np.testing.assert_allclose(got["losses"][0], float(jloss), rtol=LOSS_RTOL)
    _close(_leaves(got["params"][0]), _jax_leaves(jp), 0, JAX_PARAM_TOL, "ragged vs jax")


# -- layouts and refusals --------------------------------------------------------------


def test_expert_parallel_specs_match_jax():
    """expert_parallel_specs is JAX's PartitionSpec tree entry for entry
    (``P(None, "expert")`` as ``(None, "expert")``), on any axis name; a
    dense model is refused in JAX's words."""
    from distributed_tensorflow_tpu.models.gpt import expert_parallel_specs as jspecs
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, expert_parallel_specs

    for axis in ("expert", "ep"):
        got = expert_parallel_specs(GPTLM(**SMALL, **MOE4), axis)
        want = jspecs(jax_model(**MOE4), axis)
        assert [tuple(x) for x in want[:2] + want[3:]] == list(got[:2] + got[3:])
        assert got.blocks._fields == want.blocks._fields
        assert [tuple(x) for x in want.blocks] == list(got.blocks)
    for fn, m in ((expert_parallel_specs, GPTLM(**SMALL)), (jspecs, jax_model())):
        with pytest.raises(ValueError, match="requires moe_experts"):
            fn(m)


def test_ep_refusals_match_jax():
    """The ep forward's and factory's refusals in JAX's words, before any
    collective: a dense model, an axis whose size is not ``moe_experts``."""
    from distributed_tensorflow_tpu.models.gpt import make_lm_ep_parts as jparts
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, make_lm_ep_parts
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    dense = GPTLM(**SMALL, compute_dtype=torch.float32)
    moe = GPTLM(**SMALL, **MOE4, compute_dtype=torch.float32)
    toks = torch.zeros(2, 8, dtype=torch.int64)
    m2 = Mesh({"expert": 2})
    with pytest.raises(ValueError, match="apply_expert_parallel requires moe_experts"):
        dense.apply_expert_parallel(dense.init(1, device="cpu"), toks, m2)
    with pytest.raises(ValueError, match="'expert' axis size 2 != moe_experts 4"):
        moe.apply_expert_parallel(moe.init(1, device="cpu"), toks, m2)
    jm2 = _jax_mesh((2,), ("expert",))
    for fn, d, m, opt, me in ((make_lm_ep_parts, dense, moe, optim.adam(1e-3), m2),
                              (jparts, jax_model(), jax_model(**MOE4), joptim.make("adam", 1e-3),
                               jm2)):
        with pytest.raises(ValueError, match="requires moe_experts"):
            fn(d, opt, me)
        with pytest.raises(ValueError, match="'expert' axis size 2 != moe_experts 4"):
            fn(m, opt, me)


# -- the trainer ----------------------------------------------------------------------


def _costs(lines):
    return [float(m.group(1)) for m in (re.search(r"Cost: ([0-9.]+)", x) for x in lines) if m]


def test_ep_trainer_matches_jax(world):
    """LMTrainer(mesh=..., dp_mode="ep") on (2, 2) (JAX
    ``tests/test_lm_trainer.py:679``) against JAX's ep LMTrainer on a (2, 2)
    mesh from the same parameters and batches: every printed cost, the
    held-out perplexity (the dense forward at the gathered parameters) and
    the final parameters; the expert leaves and their Adam slots split on
    dim 1 on every rank; the other ranks print step lines only; the
    to_canonical / from_canonical round trip is bit for bit."""
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data.tokens import TokenDataset as JDS
    from distributed_tensorflow_tpu.data.tokens import TokenDatasets as JDSS
    from distributed_tensorflow_tpu.train import LMTrainer as JTrainer

    trees, _, inp, res = world
    model_kw = RUNS["ep_trainer"][3]
    ds = JDSS(JDS(inp["train"], seed=1), JDS(inp["val"], seed=2), JDS(inp["val"], seed=3))
    lines = []
    cfg = {k: v for k, v in TRAIN_CFG.items() if k != "compute_dtype"}
    jtr = JTrainer(jax_model(**model_kw), ds, JConfig(**cfg, dp_mode="ep", scan_epoch=False),
                   mesh=_jax_mesh((2, 2), DE), print_fn=lines.append)
    jtr.state = jtr._init_state(jax_params(trees["e2"]))
    want = jtr.run()
    got = res[0]["ep_trainer"]
    assert got["mode"] == "ep"
    assert len(_costs(got["lines"])) == len(_costs(lines)) == 4 + 1
    assert max(abs(a - b) for a, b in zip(_costs(got["lines"]), _costs(lines))) <= 2e-4
    np.testing.assert_allclose(got["result"]["perplexity"], want["perplexity"], rtol=1e-4)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-4)
    _close(_leaves(got["params"]), _jax_leaves(jtr.state.params), 0, JAX_PARAM_TOL, "ep trainer")
    for r in res:
        assert r["ep_trainer"]["round_trip"]
        assert r["ep_trainer"]["local"]["w_up"] == (SMALL["num_layers"], 1, 32, 128)
        assert r["ep_trainer"]["local"]["wg"] == (SMALL["num_layers"], 32, 2)
        assert r["ep_trainer"]["local_mu_w_up"] == (SMALL["num_layers"], 1, 32, 128)
    for r in res[1:]:
        assert all(x.startswith("Step: ") for x in r["ep_trainer"]["lines"])


def test_ep_trainer_refusals_match_jax():
    """The ep mode's refusals in JAX's words (``tests/test_lm_trainer.py:580``):
    a dense model, a mesh without the expert axis, a batch the shards do
    not divide."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    toks = np.zeros((64, 16), np.int32)
    ds = TokenDatasets(TokenDataset(toks), TokenDataset(toks), TokenDataset(toks))

    def make(mesh, model_kw, **kw):
        LMTrainer(GPTLM(**{**SMALL, **model_kw}, compute_dtype=torch.float32), ds,
                  TrainConfig(**{**TRAIN_CFG, "dp_mode": "ep", **kw}), device="cpu", mesh=mesh)

    with pytest.raises(ValueError, match="requires a MoE model"):
        make(Mesh({"data": 2, "expert": 2}), {})
    with pytest.raises(ValueError, match="'expert' mesh axis"):
        make(Mesh({"data": 4}), MOE4)
    with pytest.raises(ValueError, match="shards the batch 8 ways"):
        make(Mesh({"data": 2, "expert": 4}), MOE4, batch_size=60)
    with pytest.raises(ValueError, match="'expert' axis size 2 != moe_experts 4"):
        make(Mesh({"data": 2, "expert": 2}), MOE4)


# -- the numpy round trip ----------------------------------------------------------------


def test_ep_convert_round_trip_is_bitwise(world):
    """A JAX canonical MoE state as numpy (params and Adam's count and
    moments) → each rank's expert-parallel blocks (one expert's FFN leaves,
    the rest whole) → gathered back to numpy, bit for bit."""
    trees, moments, inp, res = world
    for r in res:
        got = r["ep_convert"]
        assert got["w_up"] == got["mu_w_up"] == (SMALL["num_layers"], 1, 32, 128)
        assert got["mu_embed"] == trees["e2"]["embed"].shape
        for a, b in zip(_leaves(got["params"]), _leaves(trees["e2"])):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for m, want in zip(("mu", "nu"), moments["e2"]):
            for a, b in zip(_leaves(got["adam"][m]), _leaves(want)):
                assert np.array_equal(a, b)
        assert int(got["adam"]["count"]) == int(inp["adam/count"])
