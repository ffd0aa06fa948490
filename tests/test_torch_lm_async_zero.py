"""PyTorch port, the LM's async local SGD and ZeRO modes:
``make_lm_async_parts`` / ``make_lm_async_train_step``,
``make_lm_zero_parts``, ``LMTrainer(sync=False)`` and
``LMTrainer(dp_mode="zero")`` with ``async_update_scale``, ``run_compiled``
in both, and the numpy round trips of async copies and ZeRO slices
(``convert.py``), on the one 4-rank gloo world of
``tests/_torch_local_sgd.py`` (a (4,) ``("data",)`` mesh), each against the
JAX package on 4 of the 8 virtual devices of ``tests/conftest.py`` and
against the port's own sync data-parallel step.

Tolerances. Async with ``avg_every=1, update_scale=1`` under SGD against
sync dp: JAX's (``tests/test_gpt.py:732``): the loss within rtol 1e-6, the
parameters within rtol 1e-5, atol 1e-7; at the trainer,
``tests/test_lm_trainer.py:379``'s rtol 1e-5, atol 1e-6. ZeRO against dp on
the same ranks: bit for bit (the forward runs on the exactly gathered
parameters, the gradients and the loss are summed in dp's one bucket, and
the update is elementwise on the slices). Against JAX: the loss within
1e-5, the ZeRO parameters after 4 AdamW steps within 5e-5 absolute (the
port's other parallel-LM tests' bound: Adam's m/√v magnifies last-bit
differences of a gradient near 0); the async runs step by SGD there (at
N = 4 times the update, an Adam element with a gradient near 0 sat 1.45e-4
off) and hold rtol 1e-5, atol 1e-6; the printed costs within 2e-4 (four
places), the perplexity within rtol 1e-4.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from _torch_local_sgd import MODEL, N, TRAIN_CFG, local_sgd_world
from _torch_parity import jax_model, jax_params

JAX_PARAM_TOL = 5e-5
# The async equivalences against JAX step by SGD (Adam's first steps are the
# gradient's sign, which a last-bit difference flips where a gradient is near
# 0), within JAX's own bound between its two DiLoCo engines.
SGD, SGD_TOL = ("sgd", 0.05), dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return local_sgd_world(tmp_path_factory)


def leaves(tree):
    """A numpy GPT tree's leaves in a fixed order (a JAX params tree too)."""
    if hasattr(tree, "_asdict"):
        tree = {k: (v._asdict() if hasattr(v, "_asdict") else v)
                for k, v in tree._asdict().items()}
    return [np.asarray(tree[k]) for k in sorted(k for k in tree if k != "blocks")] + \
        [np.asarray(tree["blocks"][k]) for k in sorted(tree["blocks"])]


def close(got, want, rtol=0.0, atol=JAX_PARAM_TOL, what=""):
    for i, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")


def equal(got, want):
    return all(np.array_equal(a, b) for a, b in zip(leaves(got), leaves(want)))


def jax_mesh():
    import jax

    from distributed_tensorflow_tpu.parallel import make_mesh

    return make_mesh((N,), ("data",), devices=jax.devices()[:N])


def jax_opt(name="adam", lr=1e-3):
    from distributed_tensorflow_tpu.ops import optim as joptim

    return joptim.make(name, lr)


def row(stacked, r):
    import jax

    return jax.tree.map(lambda x: np.asarray(x)[r], stacked)


def costs(lines):
    return [float(m.group(1)) for m in (re.search(r"Cost: ([0-9.]+)", x) for x in lines) if m]


# -- the async parts ------------------------------------------------------------------


def test_async_sgd_avg1_equals_sync_dp(world):
    """SGD is linear in the gradient, so local updates from a common point
    followed by the mean (``avg_every=1, update_scale=1``) are the sync dp
    step (JAX ``tests/test_gpt.py:732``): against the port's dp step and
    against JAX's async step on its 4-device mesh, every rank's copy."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.gpt import make_lm_async_parts

    tree, _, inp, res = world
    model, opt = jax_model(**MODEL), jax_opt("sgd", 0.01)
    init, mapped = make_lm_async_parts(model, opt, jax_mesh(), avg_every=1, update_scale=1.0)
    p, o, _ = init(jax_params(tree), opt.init(jax_params(tree)))
    step = jax.jit(mapped)
    for i in range(2):
        p, o, loss = step(p, o, jnp.asarray(inp["steps"][i]), None, jnp.asarray(i, jnp.int32))
        dp = res[0]["dp_sgd"]
        for r in res:
            got = r["async_sgd1"]
            close(got["params"][i], dp["params"][i], 1e-5, 1e-7, f"rank step {i} vs dp")
            close(got["params"][i], row(p, 0), 0.0, 1e-6, f"step {i} vs JAX")
        # Each rank's loss is its own shard's; their mean is dp's.
        mean = np.mean([r["async_sgd1"]["losses"][i] for r in res])
        np.testing.assert_allclose(mean, dp["losses"][i], rtol=1e-6)
        np.testing.assert_allclose(mean, float(loss), rtol=1e-6)


def test_async_copies_diverge_then_converge_on_exchange(world):
    """``avg_every=2`` under Adam (JAX ``tests/test_gpt.py:764``): after
    steps 1 and 3 the ranks' copies differ (each stepped on its own rows),
    after steps 2 and 4 every rank holds the mean, bit for bit."""
    _, _, _, res = world
    for i in range(4):
        first = res[0]["async_avg2"]["params"][i]
        same = all(equal(r["async_avg2"]["params"][i], first) for r in res[1:])
        assert same == (i % 2 == 1), i


def test_async_default_scale_matches_jax(world):
    """The default ``update_scale`` (N = 4, ``AsyncDataParallel``'s
    convention) under SGD: each rank's copy after a local step and after
    the exchange against JAX's on its mesh."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.gpt import make_lm_async_parts

    tree, _, inp, res = world
    model, opt = jax_model(**MODEL), jax_opt(*SGD)
    init, mapped = make_lm_async_parts(model, opt, jax_mesh(), avg_every=2)
    p, o, _ = init(jax_params(tree), opt.init(jax_params(tree)))
    step = jax.jit(mapped)
    for i in range(2):
        p, o, _ = step(p, o, jnp.asarray(inp["steps"][i]), None, jnp.asarray(i, jnp.int32))
        for r, got in enumerate(res):
            close(got["async_scale"]["params"][i], row(p, r), **SGD_TOL,
                  what=f"rank {r} step {i}")


def test_async_runs_one_all_reduce_an_exchange_and_none_between(world):
    """The traffic bound: an all-reduce of one flat bucket of the
    parameters (27,680 elements at these widths) on exchange steps only,
    none on the others (the loss stays the rank's own); dp's step reduces
    the gradients and the loss in one bucket every step; the ZeRO trainer
    two a step (the gather, then the gradient bucket)."""
    _, _, _, res = world
    pn = res[0]["async_sgd1"]["reduces"][0][0]
    assert pn == 27680
    for r in res:
        assert r["async_sgd1"]["reduces"] == [[pn], [pn]]
        assert r["async_avg2"]["reduces"] == [[], [pn], [], [pn]]
        assert r["dp_sgd"]["reduces"] == [[pn + 1], [pn + 1]]
        assert [len(x) for x in r["tr_async"]["reduces"]] == [0, 1, 0, 1]
        assert [len(x) for x in r["tr_zero"]["reduces"]] == [2, 2, 2, 2]


# -- the trainers ---------------------------------------------------------------------


def _jax_trainer(tree, inp, mesh, opt, **cfg):
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data.tokens import TokenDataset as JDS
    from distributed_tensorflow_tpu.data.tokens import TokenDatasets as JDSS
    from distributed_tensorflow_tpu.train import LMTrainer as JTrainer

    ds = JDSS(JDS(inp["train"], seed=1), JDS(inp["val"], seed=2), JDS(inp["val"], seed=3))
    lines = []
    base = {k: v for k, v in TRAIN_CFG.items() if k != "compute_dtype"}
    jtr = JTrainer(jax_model(**MODEL), ds, JConfig(**{**base, **cfg}, scan_epoch=False,
                                                   logs_path=""),
                   mesh=mesh, optimizer=opt, print_fn=lines.append)
    jtr.state = jtr._init_state(jax_params(tree))
    return jtr, jtr.run(), lines


def _lines_match(got, lines, want):
    assert [x.split(":")[0] for x in got["lines"]] == [x.split(":")[0] for x in lines]
    assert max(abs(a - b) for a, b in zip(costs(got["lines"]), costs(lines))) <= 2e-4
    np.testing.assert_allclose(got["result"]["perplexity"], want["perplexity"], rtol=1e-4)
    assert got["result"]["global_step"] == want["global_step"]


def test_async_trainer_matches_jax(world):
    """LMTrainer(mesh=..., sync=False, async_avg_every=2) under SGD at the
    default scale against JAX's async LMTrainer on its 4-device mesh from
    the same parameters and batches: the same lines (every cost the mean
    over the ranks, as JAX's pmean), the perplexity at the mean of the
    copies, the merged parameters; each rank's own copy
    against JAX's copy of its index. The other ranks print step lines
    only; to_canonical / from_canonical round-trips bit for bit."""
    import jax

    tree, _, inp, res = world
    jtr, want, lines = _jax_trainer(tree, inp, jax_mesh(), jax_opt(*SGD), sync=False,
                                    async_avg_every=2)
    got = res[0]["tr_async"]
    assert got["mode"] == "async"
    _lines_match(got, lines, want)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-4)
    merged = jax.tree.map(lambda x: np.asarray(x).mean(0), jtr.state.params)
    close(got["params"], merged, **SGD_TOL, what="merged params")
    for r, rank in enumerate(res):
        close(rank["tr_async"]["own"], row(jtr.state.params, r), **SGD_TOL,
              what=f"rank {r} copy")
        assert rank["tr_async"]["round_trip"]
    for rank in res[1:]:
        assert all(x.startswith("Step: ") for x in rank["tr_async"]["lines"])


def test_async_trainer_sgd_avg1_equals_dp(world):
    """The documented equivalence at the trainer (JAX
    ``tests/test_lm_trainer.py:379``): SGD, ``async_avg_every=1``,
    ``async_update_scale=1.0`` against the dp trainer on the same ranks."""
    _, _, _, res = world
    a, d = res[0]["tr_async_sgd1"], res[0]["tr_dp_sgd"]
    assert a["mode"] == "async" and d["mode"] == "dp"
    close(a["params"], d["params"], 1e-5, 1e-6, "async vs dp")
    assert max(abs(x - y) for x, y in zip(costs(a["lines"]), costs(d["lines"]))) <= 1e-4


def test_zero_trainer_shards_and_equals_dp(world):
    """LMTrainer(mesh=..., dp_mode="zero") (JAX ``tests/test_lm_trainer.py:358``):
    each leaf's largest dim the 4 ranks divide is split (``embed`` [61, 32]
    on dim 1, as JAX's ``fsdp_specs``; the blocks' [2, 32, 32] on a dim of
    32, ``pos`` [16, 32] on dim 1), Adam's slots alike, and the run equals
    the dp trainer's on the same ranks and batches bit for bit."""
    _, _, _, res = world
    for r in res:
        z, d = r["tr_zero"], r["tr_dp_adamw"]
        assert z["mode"] == "zero" and z["round_trip"]
        assert z["local"]["embed"] == z["local_mu"]["embed"] == (61, 8)
        assert z["local"]["pos"] == (16, 8)
        assert z["local"]["lnf_scale"] == (8,)
        assert z["local_blocks"]["wq"] == (2, 8, 32)
        assert z["local_blocks"]["w_up"] == (2, 32, 32)
        assert d["local"]["embed"] == (61, 32)
        assert equal(z["params"], d["params"])
        assert costs(z["lines"]) == costs(d["lines"])
        assert z["perplexity"] == d["perplexity"]


def test_zero_trainer_matches_jax(world):
    """The ZeRO trainer under AdamW against JAX's on its 4-device mesh
    (whose own tolerance against dp is rtol 2e-5, atol 1e-5): the lines,
    the perplexity at the gathered parameters and the parameters."""
    tree, _, inp, res = world
    jtr, want, lines = _jax_trainer(tree, inp, jax_mesh(), jax_opt("adamw"), dp_mode="zero")
    got = res[0]["tr_zero"]
    _lines_match(got, lines, want)
    close(got["params"], jtr.state.params, what="zero params")


def test_run_compiled_keeps_one_fetch_under_async(world):
    """run_compiled in the async mode: no host read while it runs (the
    costs are meaned over the ranks on the device, once, before its one
    fetch) and the same updates as run(): its parameters and printed costs
    equal the async run's bit for bit."""
    _, _, _, res = world
    c, r = res[0]["tr_async_compiled"], res[0]["tr_async"]
    assert c["reads"] == 0
    assert equal(c["params"], r["params"])
    assert costs(c["lines"]) == costs(r["lines"])


def test_mode_refusals_match_jax():
    """The async and ZeRO modes' checks in JAX's words: async with a sharded
    dp_mode, a batch the data axis does not divide; ZeRO without the data
    axis."""
    import torch

    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    t = np.zeros((64, 16), np.int32)
    ds = TokenDatasets(TokenDataset(t), TokenDataset(t[:8]), TokenDataset(t[:8]))
    model = GPTLM(**MODEL, compute_dtype=torch.float32)
    cases = (
        (Mesh({"data": 4}), dict(sync=False, dp_mode="zero"), "does not compose with sync=False"),
        (Mesh({"data": 4}), dict(sync=False, batch_size=6),
         "async mode shards the batch over 'data': batch_size 6 must be divisible by the axis "
         "size 4"),
        (Mesh({"model": 2}), dict(sync=False), "mesh has no 'data' axis"),
        (Mesh({"model": 2}), dict(dp_mode="zero"), "mesh has no 'data' axis"),
        (Mesh({"data": 4}), dict(dp_mode="zero", batch_size=6), "batch_size 6 must be divisible"),
    )
    for mesh, kw, msg in cases:
        with pytest.raises(ValueError, match=re.escape(msg)):
            LMTrainer(model, ds, TrainConfig(**kw), device="cpu", mesh=mesh)
    # The async copies on a layout-only mesh of one rank: the mode, the scale.
    tr = LMTrainer(model, ds, TrainConfig(sync=False, batch_size=8), device="cpu",
                   mesh=Mesh({"data": 1}), async_update_scale=2.0)
    assert tr.mode == "async" and tr.async_update_scale == 2.0
    assert LMTrainer(model, ds, TrainConfig(sync=False, batch_size=8),
                     device="cpu").mode == "single"


def test_async_train_step_matches_parts():
    """``make_lm_async_train_step`` (JAX :3094) is the parts' step on
    ``(params, opt_state, count)``: on a layout-only mesh of one rank with
    ``update_scale=1`` it is the single-device step bit for bit, the count
    advancing; ``avg_every < 1`` is refused as in JAX."""
    import torch

    from _torch_local_sgd import data
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy
    from distributed_tensorflow_tpu_torch.models.gpt import (
        GPTLM,
        make_lm_async_parts,
        make_lm_async_train_step,
        make_lm_train_step,
    )
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    tree, _, inp = data()
    model, opt = GPTLM(**MODEL, compute_dtype=torch.float32), optim.adam(1e-3)
    params = gpt_params_from_numpy(tree, device="cpu")
    toks = torch.from_numpy(inp["steps"][0])
    init, step = make_lm_async_train_step(model, opt, Mesh({"data": 1}), update_scale=1.0)
    state, loss = step(init(params, opt.init(params)), toks)
    p, _, ref = make_lm_train_step(model, opt)(params, opt.init(params), toks)
    assert state[2] == 1 and float(loss) == float(ref)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state[0]), tree_leaves(p)))
    with pytest.raises(ValueError, match="avg_every must be >= 1"):
        make_lm_async_parts(model, opt, Mesh({"data": 1}), avg_every=0)


# -- the numpy round trips ------------------------------------------------------------


def test_async_and_zero_convert_round_trips_are_bitwise(world):
    """A JAX async state as numpy (a copy a replica, stacked) → each rank's
    copy → stacked back; a JAX canonical state → each rank's ZeRO slices
    (``embed`` and its moments [61, 8]) → gathered back; both bit for
    bit."""
    tree, (mu, nu), inp, res = world
    stack = {k: (inp[f"d_stack/{k}"]) for k in tree if k != "blocks"}
    stack["blocks"] = {k: inp[f"d_stack/blocks/{k}"] for k in tree["blocks"]}
    for r, rank in enumerate(res):
        got = rank["convert"]
        params, adam = got["async_back"]
        assert equal(params, stack)
        assert adam["count"].tolist() == [7] * N
        assert got["async_embed"] == stack["embed"][r, 0, 0]
        zp, zo = got["zero_back"]
        assert equal(zp, tree) and equal(zo["mu"], mu) and equal(zo["nu"], nu)
        assert int(zo["count"]) == 7
        assert got["zero_embed"] == got["zero_mu_embed"] == (61, 8)


@pytest.mark.cuda
def test_async_and_zero_steps_run_the_flash_kernels_on_the_card():
    """On the card with flash attention, on layout-only meshes of one rank:
    the async step at ``update_scale=1`` and the ZeRO step are the
    single-device step bit for bit, B3 and B4 launching once a layer."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_tensorflow_tpu_torch.models.gpt import (
        GPTLM,
        make_lm_async_parts,
        make_lm_train_step,
        make_lm_zero_parts,
    )
    from distributed_tensorflow_tpu_torch.ops import _build, optim
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    model = GPTLM(**MODEL, compute_dtype=torch.float32, attention_impl="flash", flash_min_len=0)
    opt = optim.adamw(1e-3)
    params = model.init(seed=3, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 61, (8, 16))).cuda()
    ref, _, ref_loss = make_lm_train_step(model, opt)(params, opt.init(params), toks)
    mesh = Mesh({"data": 1}, device="cuda")
    init, mapped = make_lm_async_parts(model, opt, mesh, update_scale=1.0)
    _build.reset_launches()
    p, o, _ = init(params, opt.init(params))
    got, _, loss = mapped(p, o, toks, None, 0)
    assert _build.LAUNCHES["flash_fwd"] == MODEL["num_layers"]
    _, _, zstep = make_lm_zero_parts(model, opt, mesh)
    zgot, _, zloss = zstep(params, opt.init(params), toks)
    for x, xl in ((got, loss), (zgot, zloss)):
        assert float(xl) == float(ref_loss)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(x), tree_leaves(ref)))
