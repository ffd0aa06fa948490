"""PyTorch port: the MoE FFN (``ops/moe.py``) and MoE blocks of ``GPTLM``
against the JAX package on seeded numpy inputs, at small widths (d=32, 2
layers, 4 experts, top-1 and top-2, f32).

Routing is compared exactly: the experts chosen, each dispatch's capacity
slot and whether it is kept, for k=1 and k=2, with and without a token
mask, at a capacity that drops (the inputs' top-2 logit gaps are asserted
above 1e-4, so no near-tie decides a choice); the gate weights and the
router statistics within 1e-6. The FFNs within 1e-5 of JAX's (f32 products
in another order), ``moe_ffn_dense`` == ``moe_ffn_local`` within 1e-6. The
MoE GPT: loss and metrics within 1e-5 and every gradient within 1e-4 of a
leaf's largest (test_torch_lm.py's f32 tolerances), dense and flash
attention; greedy streams token for token with JAX's ``greedy_decode``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params
from test_torch_lm import FLASH, _assert_grads_close, _jax_value_and_grad

E, D, H = 4, 16, 32


def _router_inputs(t, seed, mask_from=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, D)).astype(np.float32)
    wg = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    logits = np.sort(x @ wg, axis=-1)[:, ::-1]
    assert (logits[:, 0] - logits[:, 1]).min() > 1e-4 and (logits[:, 1] - logits[:, 2]).min() > 1e-4
    mask = None if mask_from is None else np.arange(t) < mask_from
    return x, wg, mask


# (k, capacity, real tokens or None): ample capacity, a capacity that drops,
# and a token mask (pads never dispatched, never counted).
ROUTE_CASES = ((1, 24, None), (1, 3, None), (1, 4, 17), (2, 48, None), (2, 5, None),
               (2, 6, 13))


@pytest.mark.parametrize("k,capacity,real", ROUTE_CASES)
def test_route_matches_jax(k, capacity, real):
    """``_route``: expert_idx, slot and keep equal JAX's exactly; gate_w and
    every ``MoEAux`` statistic within 1e-6."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import moe as jmoe
    from distributed_tensorflow_tpu_torch.ops import moe as tmoe

    x, wg, mask = _router_inputs(24, seed=k * 100 + capacity, mask_from=real)
    jr = jmoe._route(jnp.asarray(x), jnp.asarray(wg), E, capacity,
                     None if mask is None else jnp.asarray(mask), k=k)
    tr = tmoe._route(torch.from_numpy(x), torch.from_numpy(wg), E, capacity,
                     None if mask is None else torch.from_numpy(mask), k=k)
    for name, j, t in zip(("expert_idx", "gate_w", "slot", "keep"), jr[:4], tr[:4]):
        if name == "gate_w":
            assert max_err(j, t.numpy()) < 1e-6
        else:
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    for name, j, t in zip(jr[4]._fields, jr[4], tr[4]):
        assert max_err(j, t.numpy()) < 1e-6, name
    if capacity < 6:
        assert float(tr[4].drop_fraction) > 0


def _moe_params(seed):
    from distributed_tensorflow_tpu_torch.ops.moe import MoEParams

    rng = np.random.default_rng(seed)
    arrays = dict(wg=rng.standard_normal((D, E)) / np.sqrt(D),
                  w_up=rng.standard_normal((E, D, H)) / np.sqrt(D),
                  b_up=0.1 * rng.standard_normal((E, H)),
                  w_down=rng.standard_normal((E, H, D)) / np.sqrt(H),
                  b_down=0.1 * rng.standard_normal((E, D)))
    arrays = {k_: v.astype(np.float32) for k_, v in arrays.items()}
    return arrays, MoEParams(**{k_: torch.from_numpy(v) for k_, v in arrays.items()})


@pytest.mark.parametrize("k,capacity,real", ROUTE_CASES)
def test_moe_ffns_match_jax(k, capacity, real):
    """``moe_ffn_dense`` == ``moe_ffn_local`` (within 1e-6), both within
    1e-5 of JAX's ``moe_ffn_local``, the aux statistics too; a dropped
    dispatch adds nothing (a token whose every choice dropped gives 0)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import moe as jmoe
    from distributed_tensorflow_tpu_torch.ops import moe as tmoe

    x, wg, mask = _router_inputs(24, seed=k * 100 + capacity, mask_from=real)
    arrays, tp = _moe_params(seed=capacity)
    arrays["wg"] = wg
    tp = tp._replace(wg=torch.from_numpy(wg))
    jp = jmoe.MoEParams(**{k_: jnp.asarray(v) for k_, v in arrays.items()})
    jm = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jout, jaux = jmoe.moe_ffn_local(jp, jnp.asarray(x), capacity, with_aux=True, token_mask=jm,
                                    k=k)
    xt = torch.from_numpy(x)
    local, aux = tmoe.moe_ffn_local(tp, xt, capacity, with_aux=True, token_mask=tmask, k=k)
    dense = tmoe.moe_ffn_dense(tp, xt, capacity, token_mask=tmask, k=k)
    assert max_err(local.numpy(), dense.numpy()) < 1e-6
    assert max_err(jout, local.numpy()) < 1e-5
    for j, t in zip(jaux, aux):
        assert max_err(j, t.numpy()) < 1e-6
    keep = tmoe._route(xt, tp.wg, E, capacity, tmask, k=k)[3]
    dropped = ~keep.any(1)
    assert torch.equal(local[dropped], torch.zeros_like(local[dropped]))


def test_top2_capacity_priority_is_choice_major():
    """As tests/test_moe.py:238: with capacity 1 each expert's slot goes to
    a token's FIRST choice, never to another token's second choice."""
    from distributed_tensorflow_tpu_torch.ops.moe import _route

    wg = torch.zeros(4, 2)
    wg[0, 0] = 10.0
    wg[1, 1] = 10.0
    x = torch.zeros(2, 4)
    x[0, 0] = 1.0  # logits (10, 0): e0 first, e1 second
    x[1, 1] = 1.0  # logits (0, 10): e1 first, e0 second
    idx, _, slot, keep, _ = _route(x, wg, 2, capacity=1, k=2)
    assert idx.tolist() == [[0, 1], [1, 0]]
    assert keep[:, 0].all() and not keep[:, 1].any()
    assert slot.tolist() == [[0, 1], [0, 1]]


def test_top2_no_drop_equals_hand_formula():
    """As tests/test_moe.py:204: without drops the top-2 output is
    Σ_{i in top2} (p_i / Σ_top2 p) · expert_i(x); the combine weights carry
    gradient into the gate."""
    from distributed_tensorflow_tpu_torch.ops.moe import _expert_ffn, init_moe, moe_ffn_dense

    p = init_moe(D, H, E, torch.Generator().manual_seed(3))
    assert [tuple(t.shape) for t in p] == [(D, E), (E, D, H), (E, H), (E, H, D), (E, D)]
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((12, D)).astype(np.float32))
    got = moe_ffn_dense(p, x, capacity=12, k=2)
    probs = torch.softmax(x @ p.wg, -1)
    top2 = torch.argsort(x @ p.wg, -1, descending=True)[:, :2]
    outs = torch.stack([_expert_ffn(x, p.w_up[i], p.b_up[i], p.w_down[i], p.b_down[i])
                        for i in range(E)])
    want = torch.zeros(12, D)
    for t in range(12):
        ps = probs[t, top2[t]]
        for c in range(2):
            want[t] += ps[c] / ps.sum() * outs[top2[t, c], t]
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)
    wg = p.wg.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(moe_ffn_dense(p._replace(wg=wg), x, 12, k=2).sum(), wg)
    assert g.abs().sum() > 0


def test_expert_parallel_body_waits_for_a7():
    """The expert-parallel body, refused until ROADMAP A7c, now runs: on an
    expert axis of one rank (a layout-only mesh, no process group) it is
    ``moe_ffn_local`` over that rank's one expert, output and gradients bit
    for bit (the exchanges are the identity), with a dropping capacity and
    top-1; a gate over another count of experts than the axis has ranks is
    refused. The 4-rank exchange is held against JAX in
    ``tests/test_torch_ep.py``."""
    from distributed_tensorflow_tpu_torch.ops.moe import MoEParams, moe_ffn, moe_ffn_local
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    _, p = _moe_params(seed=1)
    one = MoEParams(p.wg[:, :1], *(t[:1] for t in p[1:]))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((12, D)).astype(np.float32))
    mesh = Mesh({"expert": 1})
    for cap in (5, 12):
        outs = []
        for fn in (lambda q, y: moe_ffn(q, y, mesh, "expert", cap, with_aux=True),
                   lambda q, y: moe_ffn_local(q, y, cap, with_aux=True)):
            q = MoEParams(*(t.clone().requires_grad_(True) for t in one))
            y = x.clone().requires_grad_(True)
            out, aux = fn(q, y)
            out.square().sum().backward()
            outs.append([out, aux.drop_fraction, y.grad, *(t.grad for t in q)])
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        assert (float(outs[0][1]) > 0) == (cap < 12)
    with pytest.raises(ValueError, match="routes over 1 experts, one a rank: got a gate over 4"):
        moe_ffn(p, x, mesh, "expert", 4)


# -- MoE blocks in GPTLM ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def moe_models(k=1, **kw):
    """(JAX model, port model, JAX params, port params) of the parity tests'
    GPT with 4 experts, top-``k``, f32, every leaf seeded."""
    kw = dict(moe_experts=4, moe_top_k=k, **kw)
    jm, tm = jax_model(**kw), torch_model(**kw)
    tree = numpy_params(jm, seed=21)
    return jm, tm, jax_params(tree), torch_params(tree)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_gpt_loss_metrics_and_grads_match_jax(k, impl, ragged):
    """``loss_and_metrics`` (ce, balance_loss, z_loss, drop_fraction,
    expert_fraction) within 1e-5 and every parameter's gradient within
    1e-4 of its leaf's largest, against JAX's, at the default capacity
    factor (2.0), dense and flash attention, with and without lengths."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad
    from test_torch_lm import _tokens

    extra = tuple(sorted(FLASH.items())) if impl == "flash" else ()
    jm, tm, jp, tp = moe_models(k, **dict(extra))
    tree = numpy_params(jm, seed=21)
    toks, lens = _tokens(4)
    lens = lens if ragged else None
    args_j = (jnp.asarray(toks),) + (() if lens is None else (jnp.asarray(lens),))
    args_t = (torch.from_numpy(toks),) + (() if lens is None else (torch.from_numpy(lens),))
    jl, jmet = jm.loss_and_metrics(jp, *args_j)
    tl, tmet = tm.loss_and_metrics(tp, *args_t)
    assert set(tmet) == set(jmet) == {"ce", "balance_loss", "z_loss", "drop_fraction",
                                      "expert_fraction"}
    assert abs(float(jl) - float(tl)) < 1e-5
    for key in jmet:
        assert max_err(jmet[key], tmet[key].detach().numpy()) < 1e-5, key
    jloss, jg = _jax_value_and_grad(jm, tree, toks, lens)
    tloss, tg = lm_value_and_grad(tm, tp, *args_t)
    assert abs(float(tloss) - jloss) < 1e-5
    _assert_grads_close(jg, tg, 1e-4)


def test_moe_drop_metric_and_dense_loss():
    """As tests/test_gpt.py:985-1010: a dense model's total is its CE with
    only ``ce`` reported; an MoE model's total is CE + balance·coef + z·coef,
    its drop fraction 0 at ample capacity and above 0 at a tight one."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    kw = dict(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=2,
              compute_dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(31).integers(0, 61, (4, 16)))
    dense = GPTLM(**kw)
    total, met = dense.loss_and_metrics(dense.init(seed=30, device="cpu"), toks)
    assert set(met) == {"ce"} and torch.equal(total, met["ce"])
    model = GPTLM(**kw, moe_experts=4, moe_capacity_factor=16.0)
    total, met = model.loss_and_metrics(model.init(seed=31, device="cpu"), toks)
    assert float(met["drop_fraction"]) == 0.0 and met["expert_fraction"].shape == (4,)
    want = met["ce"] + model.moe_balance_coef * met["balance_loss"] + \
        model.moe_z_coef * met["z_loss"]
    assert abs(float(total) - float(want)) <= 1e-6 * float(total)
    tight = GPTLM(**kw, moe_experts=4, moe_capacity_factor=0.3)
    _, met = tight.loss_and_metrics(tight.init(seed=31, device="cpu"), toks)
    assert float(met["drop_fraction"]) > 0.0


@pytest.mark.parametrize("factor", [16.0, 1.0])
def test_ragged_moe_loss_is_pad_content_independent(factor):
    """As tests/test_gpt.py:1304: with ``lengths`` the pads take no capacity
    slot and enter no statistic, so the loss, metrics and gradients are the
    same under any pad content, at ample and at tight capacity."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, lm_value_and_grad
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    model = GPTLM(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=2,
                  compute_dtype=torch.float32, moe_experts=4, moe_capacity_factor=factor)
    params = model.init(seed=42, device="cpu")
    rng = np.random.default_rng(42)
    toks = rng.integers(0, 61, (3, 16))
    lengths = torch.tensor([16, 10, 5])
    pad_b = toks.copy()
    for b, n in enumerate(lengths.tolist()):
        pad_b[b, n:] = (pad_b[b, n:] + 11) % 61
    la, ma = model.loss_and_metrics(params, torch.from_numpy(toks), lengths)
    lb, mb = model.loss_and_metrics(params, torch.from_numpy(pad_b), lengths)
    assert float(la) == float(lb)
    for key in ("ce", "balance_loss", "z_loss", "drop_fraction"):
        assert torch.equal(ma[key], mb[key]), key
    _, ga = lm_value_and_grad(model, params, torch.from_numpy(toks), lengths)
    _, gb = lm_value_and_grad(model, params, torch.from_numpy(pad_b), lengths)
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_greedy_decode_matches_jax_on_every_engine(k):
    """Greedy decoding of the MoE GPT (f32): ``greedy_decode`` on "auto"
    (resolved to "xla") and "xla" equals JAX's ``greedy_decode`` token for
    token, and "fused" and "fused-layer" are refused with JAX's reason.
    TextServer's slab, pool and pool with speculation streams equal the JAX
    TextServer's on its XLA engine (a prefill routes the whole bucketed
    batch, so its capacity is the batch's, as there)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.serve import GenerationConfig as JCfg
    from distributed_tensorflow_tpu.serve import TextServer as JServer
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    jm, tm, jp, tp = moe_models(k)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 11, 3)]
    prompts[1] = np.tile(np.array([7, 3, 9], np.int32), 4)[:11]  # the drafter matches
    want = [np.asarray(jm.greedy_decode(jp, jnp.asarray(p[None]), 12))[0, p.size:].tolist()
            for p in prompts]
    for engine in ("auto", "xla"):
        got = [tm.greedy_decode(tp, torch.from_numpy(p[None]), 12,
                                engine=engine)[0, p.size:].tolist() for p in prompts]
        assert got == want, engine
    for engine in ("fused", "fused-layer"):
        with pytest.raises(ValueError, match="MoE blocks route through ops/moe"):
            tm.greedy_decode(tp, torch.from_numpy(prompts[0][None]), 2, engine=engine)
    for kw in (dict(), dict(paged=True, block_size=4), dict(paged=True, block_size=4,
                                                            spec_draft=3)):
        kw.update(slots=2, chunk=4, buckets=(8, 16))
        ref = JServer(jm, jp, decode_engine="xla", **kw).generate(prompts, JCfg(max_new=12))
        srv = TextServer(tm, tp, device="cpu", **kw)
        assert srv.engine == "xla"
        got = srv.generate(prompts, GenerationConfig(max_new=12))
        assert [o.tolist() for o in got] == [np.asarray(o).tolist() for o in ref], kw
        if kw.get("spec_draft"):
            assert srv.counters["spec_tokens_accepted"] > 0


def test_moe_server_at_a_capacity_that_never_drops_equals_greedy_decode():
    """At ``moe_capacity_factor = E / k`` no dispatch is ever dropped, so
    routing is per token and the server's greedy streams (slab and pool)
    equal the in-process ``greedy_decode`` token for token."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    _, tm, _, tp = moe_models(2, moe_capacity_factor=2.0 * 2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 13, 3, 9)]
    want = [tm.greedy_decode(tp, torch.from_numpy(p[None]), 10)[0, p.size:].tolist()
            for p in prompts]
    for kw in (dict(), dict(paged=True, block_size=4, spec_draft=2)):
        srv = TextServer(tm, tp, device="cpu", slots=3, chunk=4, buckets=(8, 16), **kw)
        got = srv.generate(prompts, GenerationConfig(max_new=10))
        assert [o.tolist() for o in got] == want, kw


def test_lm_trainer_trains_a_moe_model():
    """``LMTrainer`` trains a top-2 MoE GPT (flash attention) on the copy
    corpus to a finite cost and a perplexity below the first epoch's."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    model = GPTLM(vocab_size=61, max_len=16, model_dim=64, num_heads=2, num_layers=2,
                  compute_dtype=torch.float32, moe_experts=4, moe_top_k=2, **FLASH)
    out = []
    tr = LMTrainer(model, copy_corpus(num=768, n_val=128, n_test=128),
                   TrainConfig(epochs=3, batch_size=64,
                               optimizer="adam", learning_rate=3e-3),
                   device="cpu", print_fn=out.append)
    res = tr.run()
    assert np.isfinite(res["final_cost"]) and np.isfinite(res["perplexity"])
    assert res["perplexity"] < 61


def test_moe_params_round_trip_through_numpy():
    """MoE trees (``GPTMoEBlockParams``) go both ways through
    ``convert.py`` bit for bit, and a JAX MoE tree comes in as it is."""
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy, gpt_params_to_numpy
    from distributed_tensorflow_tpu_torch.models.gpt import GPTMoEBlockParams
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    jm, tm, jp, tp = moe_models(2)
    back = gpt_params_from_numpy(gpt_params_to_numpy(tp), device="cpu")
    assert isinstance(back.blocks, GPTMoEBlockParams)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(back)))
    got = gpt_params_from_numpy(jp, device="cpu")
    assert isinstance(got.blocks, GPTMoEBlockParams)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(got)))
    init = tm.init(seed=1, device="cpu").blocks
    ref = jm.init(seed=1).blocks
    for name in GPTMoEBlockParams._fields:
        assert tuple(getattr(init, name).shape) == tuple(getattr(ref, name).shape), name
