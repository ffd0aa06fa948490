"""PyTorch port: the quantized matmuls (``ops/quantized.py``
``quantized_dot``, ``quantize_tensor``, ``QuantizedLinear`` /
``quantize_linear_columns`` / ``wo_dot``), ``GPTLM(matmul_dtype=)``,
weight-only decode (``GPTLM.decode_weights``, ``TextServer(
decode_matmul_dtype=)``) and the decode engine's resolution for models
outside the kernels, against the JAX package on seeded numpy inputs.

Tolerances: ``quantized_dot`` int8 bit for bit (the int32 accumulation is
exact and both round half to even), fp8 within 1e-5 of the largest output
(f32 sums of exact products in another order); the STE gradients equal the
exact f32 products of the unquantized operands bit for bit and JAX's within
1e-5. Through a GPT the layernorms and attention sum in another order than
XLA's, so logits hold within 1e-5 of the largest (the dense parity tests'),
and a code can in principle land one step apart; greedy streams are held
token for token. On the card the int8 product (``torch._int_mm``, padded
operands) equals the exact product bit for bit and the fp8 one
(``torch._scaled_mm``) the f32 one within 1e-3 of the largest (the H100's
fp8 products accumulate in less than f32's precision).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params

SHAPES = (((5, 32), (32, 48)), ((2, 7, 64), (64, 16)), ((64, 128), (128, 96)))


def _operands(xs, ws, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            (rng.standard_normal(ws) / 8).astype(np.float32))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shapes", SHAPES, ids=["5x32x48", "2x7x64x16", "64x128x96"])
def test_quantized_dot_matches_jax(dtype, shapes):
    """The forward: int8 bit for bit, fp8 within 1e-5 of the largest."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import quantized as jq
    from distributed_tensorflow_tpu_torch.ops import quantized as tq

    x, w = _operands(*shapes, seed=sum(shapes[0]))
    ref = np.asarray(jq.quantized_dot(dtype, jnp.asarray(x), jnp.asarray(w)))
    got = tq.quantized_dot(dtype, torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    if dtype == "int8":
        np.testing.assert_array_equal(got, ref)
    else:
        assert max_err(got, ref) <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_dot_gradients_are_the_exact_transposes(dtype):
    """The straight-through estimator: dx = g · wᵀ and dw = xᵀ · g in f32
    on the unquantized operands (bit for bit), and JAX's custom VJP
    within 1e-5."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import quantized as jq
    from distributed_tensorflow_tpu_torch.ops import quantized as tq

    x, w = _operands((3, 5, 24), (24, 40), seed=7)
    g = np.random.default_rng(8).standard_normal((3, 5, 40)).astype(np.float32)
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    dx, dw = torch.autograd.grad(tq.quantized_dot(dtype, xt, wt), (xt, wt), torch.from_numpy(g))
    gt = torch.from_numpy(g)
    assert torch.equal(dx, gt @ torch.from_numpy(w).T)
    assert torch.equal(dw, torch.from_numpy(x).reshape(-1, 24).T @ gt.reshape(-1, 40))
    _, vjp = jax.vjp(lambda a, b: jq.quantized_dot(dtype, a, b), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    assert max_err(jdx, dx.numpy()) < 1e-5 and max_err(jdw, dw.numpy()) < 1e-5


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_zero_operands_quantize_to_zero(dtype):
    """An all-zero row, column or tensor quantizes to zero codes with a
    finite scale (eps-floored), so the products are exact zeros, no NaN."""
    from distributed_tensorflow_tpu_torch.ops import quantized as tq

    x, w = torch.zeros(4, 16), torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
    out = tq.quantized_dot(dtype, x, w)
    assert torch.equal(out, torch.zeros(4, 8))
    w[:, 3] = 0.0
    out = tq.quantized_dot(dtype, torch.randn(4, 16), w)
    assert torch.isfinite(out).all() and torch.equal(out[:, 3], torch.zeros(4))
    q, s = tq.quantize_tensor(torch.zeros(3, 5), dtype)
    assert torch.equal(q.float(), torch.zeros(3, 5)) and torch.isfinite(s)
    ql = tq.quantize_linear_columns(torch.zeros(6, 4), dtype)
    assert torch.equal(ql.qw.float(), torch.zeros(6, 4)) and torch.isfinite(ql.scale).all()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_tensor_and_linear_columns_match_jax(dtype):
    """``quantize_tensor`` (one scale a tensor) and
    ``quantize_linear_columns`` (one an output column, over a layer stack):
    scales bit for bit, codes bit for bit (fp8: XLA's double-rounded
    midpoints aside, at most one code apart); ``wo_dot`` within 1e-6 of
    the largest; ``dequantize_tensor`` the codes times the scale."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import quantized as jq
    from distributed_tensorflow_tpu_torch.ops import quantized as tq
    from test_torch_kv_quant import _code_diff

    rng = np.random.default_rng(3)
    a = (3 * rng.standard_normal((4, 9, 7))).astype(np.float32)
    jc, js = jq.quantize_tensor(jnp.asarray(a), dtype)
    tc, ts = tq.quantize_tensor(torch.from_numpy(a), dtype)
    assert float(js) == float(ts)
    assert _code_diff(jc, tc)[0] <= (0 if dtype == "int8" else 1)
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize_tensor(jc, js)), tq.dequantize_tensor(tc, ts).numpy())
    w = (rng.standard_normal((2, 24, 12)) / 5).astype(np.float32)
    jl = jq.quantize_linear_columns(jnp.asarray(w), dtype)
    tl = tq.quantize_linear_columns(torch.from_numpy(w), dtype)
    np.testing.assert_array_equal(np.asarray(jl.scale), tl.scale.numpy())
    assert _code_diff(jl.qw, tl.qw)[0] <= (0 if dtype == "int8" else 1)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    for cd in ("float32", "bfloat16"):
        ref = np.asarray(jq.wo_dot(jnp.asarray(x), jl.qw[1], jl.scale[1], getattr(jnp, cd)))
        got = tq.wo_dot(torch.from_numpy(x), tl.qw[1], tl.scale[1], getattr(torch, cd)).numpy()
        assert max_err(ref, got) <= 1e-6 * np.abs(ref).max()
    with pytest.raises(ValueError, match="tensor dtype"):
        tq.quantize_tensor(torch.zeros(2), "int4")
    with pytest.raises(ValueError, match="weight dtype"):
        tq.quantize_linear_columns(torch.zeros(2, 2), "int4")
    with pytest.raises(ValueError, match="matmul dtype"):
        tq.quantized_dot("int4", torch.zeros(2, 2), torch.zeros(2, 2))


# -- GPTLM(matmul_dtype=) --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_gpt_matmul_dtype_matches_jax(dtype):
    """Logits and every parameter's gradient of an f32 GPT with quantized
    projections against the JAX package's (1e-5 of the largest; gradients
    within 1e-4 relative a leaf); the logits head stays full precision (a
    zeroed block stack gives the dense model's logits bit for bit)."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad, map_params
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    jm, tm = jax_model(matmul_dtype=dtype), torch_model(matmul_dtype=dtype)
    tree = numpy_params(jm, seed=3)
    jp, tp = jax_params(tree), torch_params(tree)
    toks = np.random.default_rng(1).integers(0, 97, (3, 20)).astype(np.int32)
    jl = np.asarray(jm.apply(jp, jnp.asarray(toks)))
    tl = tm.apply(tp, torch.from_numpy(toks)).detach().numpy()
    assert max_err(jl, tl) <= 1e-5 * np.abs(jl).max()
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks))
    tloss, tg = lm_value_and_grad(tm, tp, torch.from_numpy(toks))
    assert abs(float(jloss) - float(tloss)) < 1e-5
    for j, t in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        j = np.asarray(j)
        assert max_err(j, t.numpy()) <= 1e-4 * max(np.abs(j).max(), 1e-6)
    zero = map_params(tp, torch.zeros_like)._replace(embed=tp.embed, pos=tp.pos,
                                                     lnf_scale=tp.lnf_scale, lnf_bias=tp.lnf_bias)
    dense = torch_model()
    assert torch.equal(tm.apply(zero, torch.from_numpy(toks)),
                       dense.apply(zero, torch.from_numpy(toks)))


def _copy_batches(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 30, size=(64, 8))
    hb = rng.integers(0, 30, size=(64, 8))
    return (torch.from_numpy(np.concatenate([base, base + 30], 1)),
            torch.from_numpy(np.concatenate([hb, hb + 30], 1)))


def _train(model, steps=40):
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim

    params = model.init(seed=1, device="cpu")
    opt = optim.adam(3e-3)
    step = make_lm_train_step(model, opt)
    state = opt.init(params)
    toks, held = _copy_batches(0)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    with torch.no_grad():
        return losses, float(model.loss(params, held))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_loss_parity_on_the_copy_corpus(dtype):
    """The JAX package's loss-parity contract (tests/test_quantized.py:208),
    on the port alone: 40 Adam steps with quantized projections reach a
    held-out perplexity within 15% of the full-precision run's, and both
    learn (held-out CE below 3.9; uniform is ln 61 = 4.11)."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    kw = dict(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=2,
              compute_dtype=torch.float32)
    _, ce_full = _train(GPTLM(**kw))
    losses, ce_q = _train(GPTLM(**kw, matmul_dtype=dtype))
    assert all(np.isfinite(losses))
    assert ce_full < 3.9 and ce_q < 3.9, (ce_full, ce_q)
    assert abs(np.exp(ce_q) - np.exp(ce_full)) / np.exp(ce_full) < 0.15, (ce_q, ce_full)


def test_lm_trainer_applies_matmul_dtype_to_a_copy():
    """``TrainConfig(matmul_dtype=)`` lands on the LM trainer's shallow
    copy of the model (the caller's keeps None, as in the JAX trainer), and
    ``DTF_MATMUL_DTYPE`` sets it through ``config_from_env``."""
    import os

    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.launch import config_from_env
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    model = GPTLM(vocab_size=61, max_len=16, model_dim=32, num_heads=4,
                  compute_dtype=torch.float32)
    out = []
    tr = LMTrainer(model, copy_corpus(num=640, n_val=64, n_test=64),
                   TrainConfig(epochs=1, batch_size=64, matmul_dtype="int8"),
                   device="cpu", print_fn=out.append)
    assert tr.model.matmul_dtype == "int8" and model.matmul_dtype is None
    res = tr.run()
    assert np.isfinite(res["final_cost"])
    old = os.environ.get("DTF_MATMUL_DTYPE")
    try:
        os.environ["DTF_MATMUL_DTYPE"] = "fp8"
        assert config_from_env().matmul_dtype == "fp8"
        os.environ["DTF_MATMUL_DTYPE"] = ""
        assert config_from_env().matmul_dtype is None
        os.environ["DTF_MATMUL_DTYPE"] = "int4"
        with pytest.raises(ValueError, match="matmul_dtype"):
            config_from_env()
    finally:
        if old is None:
            os.environ.pop("DTF_MATMUL_DTYPE", None)
        else:
            os.environ["DTF_MATMUL_DTYPE"] = old


# -- weight-only decode ----------------------------------------------------------


def test_decode_weights_exclusion_rules():
    """As tests/test_serve_quantized.py:431: the logits head is never
    quantized, dense blocks quantize q/k/v/out and the FFN pair, MoE blocks
    only their attention projections (the experts and the gate stay);
    ``serving_params`` leaves the quantized leaves and the gate as they
    are; the codes and scales equal JAX's ``decode_weights``' (int8)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu_torch.ops.quantized import QuantizedLinear
    from test_torch_moe import moe_models

    tm = torch_model()
    p = tm.init(seed=5, device="cpu")
    qp = tm.decode_weights(p, "int8")
    assert qp.embed is p.embed
    for nm in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        assert isinstance(getattr(qp.blocks, nm), QuantizedLinear)
    assert qp.blocks.wq.qw.dtype == torch.int8
    assert tm.decode_weights(p, "fp8").blocks.wo.qw.dtype == torch.float8_e4m3fn
    sp = torch_model("bfloat16").serving_params(qp)
    assert sp.blocks.wq is qp.blocks.wq and sp.blocks.w_up is qp.blocks.w_up
    with pytest.raises(ValueError, match="decode weight dtype"):
        tm.decode_weights(p, "int4")
    jm, mm, jp, mp = moe_models(k=1)
    qm = mm.decode_weights(mp, "int8")
    assert isinstance(qm.blocks.wo, QuantizedLinear)
    assert not isinstance(qm.blocks.w_up, QuantizedLinear) and qm.blocks.wg is mp.blocks.wg
    assert mm.serving_params(qm).blocks.wg is mp.blocks.wg
    jq = jm.decode_weights(jp, "int8")
    np.testing.assert_array_equal(np.asarray(jq.blocks.wq.qw), qm.blocks.wq.qw.numpy())
    np.testing.assert_array_equal(np.asarray(jq.blocks.wq.scale), qm.blocks.wq.scale.numpy())
    assert jnp.asarray(jq.blocks.wo.qw).dtype == jnp.int8


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_weight_only_greedy_decode_matches_jax(dtype):
    """``greedy_decode`` of ``decode_weights(params, dtype)`` (the plain
    decode through ``wo_dot``) equals JAX's token for token (f32)."""
    import jax.numpy as jnp

    jm, tm = jax_model(), torch_model()
    tree = numpy_params(jm, seed=9)
    jp, tp = jax_params(tree), torch_params(tree)
    prompt = np.random.default_rng(2).integers(0, 97, (2, 6)).astype(np.int32)
    ref = np.asarray(jm.greedy_decode(jm.decode_weights(jp, dtype), jnp.asarray(prompt), 10))
    got = tm.greedy_decode(tm.decode_weights(tp, dtype), torch.from_numpy(prompt), 10)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("paged,kv,spec,greedy", [
    (False, "bf16", 0, True), (True, "bf16", 0, True), (False, "bf16", 0, False),
    (True, "int8", 2, True)], ids=["slab", "pool", "slab-sampled", "pool-int8-spec2"])
def test_textserver_weight_only_streams_match_in_process(paged, kv, spec, greedy):
    """``TextServer(decode_matmul_dtype="int8")`` quantizes once and serves
    that tree everywhere: its streams equal the in-process decode of
    ``decode_weights(params, "int8")`` (greedy: ``greedy_decode``; sampled:
    a server over the pre-quantized tree, the same generator chain), also
    composed with an int8 cache and ``spec_draft=2`` (against the same
    server without speculation, the JAX test's rule). The engine resolves
    to "xla"; "fused" is refused at construction."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    tm = torch_model()
    p = tm.init(seed=3, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 9)]
    cfg = (GenerationConfig(max_new=10) if greedy else
           GenerationConfig(max_new=10, greedy=False, temperature=0.8, top_p=0.9, seed=51))
    kw = dict(slots=2, chunk=4, buckets=(8, 16), paged=paged, kv_dtype=kv,
              **({"block_size": 4} if paged else {}))
    srv = TextServer(tm, p, device="cpu", decode_matmul_dtype="int8", spec_draft=spec, **kw)
    assert srv.engine == "xla"
    out = srv.generate(prompts, cfg)
    qp = tm.decode_weights(p, "int8")
    if kv != "bf16" or not greedy:
        ref = TextServer(tm, qp, device="cpu", **kw).generate(prompts, cfg)
    else:
        ref = [tm.greedy_decode(qp, torch.from_numpy(pr[None]), 10)[0, pr.size:]
               for pr in prompts]
    assert [o.tolist() for o in out] == [np.asarray(r).tolist() for r in ref]
    with pytest.raises(ValueError, match="QuantizedLinear leaves"):
        TextServer(tm, p, device="cpu", decode_matmul_dtype="int8", decode_engine="fused", **kw)
    with pytest.raises(ValueError, match="decode_matmul_dtype"):
        TextServer(tm, p, device="cpu", decode_matmul_dtype="int4")


@pytest.mark.parametrize("case", ["moe", "matmul_dtype", "quantized_params"])
def test_engine_resolution_outside_the_kernels(case):
    """For each of JAX's three reasons, "fused" and "fused-layer" raise
    with JAX's words and "auto" resolves to "xla"; a dense model's "auto"
    stays the megakernel."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    kw = dict(vocab_size=97, max_len=64, model_dim=32, num_heads=4, num_layers=2,
              compute_dtype=torch.float32)
    words = {"moe": "MoE blocks route through ops/moe",
             "matmul_dtype": "matmul_dtype projections route through ops/quantized",
             "quantized_params": "weight-only quantized decode params"}[case]
    m = GPTLM(**kw, **({"moe_experts": 4} if case == "moe" else {}),
              **({"matmul_dtype": "int8"} if case == "matmul_dtype" else {}))
    p = m.init(seed=1, device="cpu")
    if case == "quantized_params":
        p = m.decode_weights(p, "fp8")
        assert m._resolve_decode_engine(None) == "fused"  # the dense tree
    for eng in ("fused", "fused-layer"):
        with pytest.raises(ValueError, match=words):
            m._resolve_decode_engine(eng, p)
    assert m._resolve_decode_engine("auto", p) == "xla"
    assert m._resolve_decode_engine(None, p) == "xla"
    assert m._resolve_decode_engine("xla", p) == "xla"
    assert GPTLM(**kw)._resolve_decode_engine("auto", GPTLM(**kw).init(device="cpu")) == "fused"
    if case != "quantized_params":
        assert words in m._decode_unsupported_reason(slots=8, nsm=132, smem_limit=232448)


def test_quantized_trees_round_trip_through_numpy():
    """``QuantizedLinear`` leaves go both ways through ``convert.py``: int8
    codes as int8, e4m3 codes as their bytes, bit for bit; a JAX
    ``decode_weights`` tree comes in as it is."""
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy, gpt_params_to_numpy
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.ops.quantized import movable

    jm, tm = jax_model(), torch_model()
    tree = numpy_params(jm, seed=2)
    tp = torch_params(tree)
    for dtype in ("int8", "fp8"):
        qp = tm.decode_weights(tp, dtype)
        back = gpt_params_from_numpy(gpt_params_to_numpy(qp), device="cpu")
        for a, b in zip(tree_leaves(qp), tree_leaves(back)):
            assert a.dtype == b.dtype and torch.equal(movable(a), movable(b))
        jq = jm.decode_weights(jax_params(tree), dtype)
        got = gpt_params_from_numpy(jq, device="cpu")
        assert got.blocks.wq.qw.dtype == qp.blocks.wq.qw.dtype
        np.testing.assert_array_equal(np.asarray(jq.blocks.wq.scale), got.blocks.wq.scale.numpy())


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 32, 96), (17, 40, 24), (5, 30, 10), (256, 512, 2048)])
def test_code_product_on_gpu(dtype, m, k, n):
    """``quantized_dot`` on the card (``torch._int_mm`` / ``torch._scaled_mm``
    on padded operands) against its plain version on the card: int8 bit for
    bit (the exact product in f64), fp8 within 1e-3 of the largest (the
    H100's fp8 products accumulate in less than f32's precision: 3.3e-4 of
    the largest measured at k=512); and against the CPU run within 1e-6 of
    the largest for int8 (the card divides a tensor by a Python scalar as a
    product by its reciprocal, so a scale may sit one ulp apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._int_mm and torch._scaled_mm run on the card")
    from distributed_tensorflow_tpu_torch.ops import quantized as tq

    g = torch.Generator().manual_seed(m + k + n)
    x, w = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g) / 8
    for xx in (x, x.reshape(1, m, k)):
        xc, wc = xx.cuda(), w.cuda()
        got = tq.quantized_dot(dtype, xc, wc)
        ref = tq.quantized_dot_plain(dtype, xc, wc)
        scale = ref.abs().max().item()
        if dtype == "int8":
            assert torch.equal(got, ref)
            cpu = tq.quantized_dot(dtype, xx, w)
            assert (got.cpu() - cpu).abs().max().item() <= 1e-6 * scale
        else:
            assert (got - ref).abs().max().item() <= 1e-3 * scale
