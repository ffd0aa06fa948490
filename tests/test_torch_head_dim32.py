"""PyTorch port: head_dim 32, the head dim of every gpt-s and ``decode-*``
configuration of ``tools/lm_bench.py`` (d=256, 8 heads), against the JAX
package. The plain flash forward and backward at D=32 against the Pallas
kernels in CPU interpret mode (causal, the window banded and not, GQA,
kv_lens); the cooperative plan at gpt-s widths; a small Dh=32 f32 model
through the slot, paged, verify and single-sequence decodes and the slab
and paged servers (the JAX XLA engine is the decode kernels' oracle), and
a training step with flash attention; on a GPU each D=32 kernel variant
(B3, B4a, B4b, B4c, B5, B6, B7) against its plain version."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params
from test_torch_decode import H100_SMEM, _check_plan, _plan

D32 = dict(model_dim=64, num_heads=2)  # the small model at head_dim 32
TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # as test_torch_decode.py's


def _qkv(b, l, hq, hkv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, 32)).astype(np.float32)
    k, v = (rng.standard_normal((b, l, hkv, 32)).astype(np.float32) for _ in range(2))
    return q, k, v, rng


# (causal, window, L, query heads, KV heads, kv_lens): the window banded
# (4W <= L) and not, GQA, ragged kv_lens.
FLASH_CASES = (
    (True, None, 64, 2, 2, None),
    (False, None, 48, 4, 2, (17, 48)),
    (True, 8, 64, 2, 1, None),
    (True, 24, 64, 4, 2, (30, 64)),
    (True, None, 40, 4, 1, (1, 40)),
)


@pytest.mark.parametrize("causal,w,l,hq,hkv,lens", FLASH_CASES)
def test_flash_forward_at_head_dim_32_matches_jax(causal, w, l, hq, hkv, lens):
    """out and lse of the port's flash forward (its plain version on the
    CPU) against the JAX Pallas kernel in interpret mode, at D=32."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    q, k, v, _ = _qkv(2, l, hq, hkv, seed=l + hq + (w or 0))
    lens = None if lens is None else np.asarray(lens, np.int32)
    jo, jlse = jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=w,
                      kv_lens=None if lens is None else jnp.asarray(lens), interpret=True)
    to, tlse = flash_attention_with_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                        causal=causal, window=w,
                                        kv_lens=None if lens is None else torch.from_numpy(lens))
    assert max_err(jo, to.numpy()) < 1e-5  # f32; sums in another order
    assert max_err(jlse, tlse.numpy()) < 1e-5


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", FLASH_CASES[::2])
def test_flash_backward_at_head_dim_32_matches_jax_vjp(case, fused):
    """dq, dk, dv through ``FlashAttention`` (the plain backward on the
    CPU) against the JAX VJP through its fused or split Pallas kernels, at
    D=32, with an lse cotangent."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    causal, w, l, hq, hkv, lens = case
    q, k, v, rng = _qkv(2, l, hq, hkv, seed=3 * l + hkv)
    do = rng.standard_normal((2, l, hq, 32)).astype(np.float32)
    dlse = rng.standard_normal((2, l, hq)).astype(np.float32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    jl = None if lens is None else jnp.asarray(lens)

    def f(q, k, v):
        return jflash(q, k, v, causal=causal, window=w, kv_lens=jl, interpret=True,
                      fused=fused)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    jg = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = flash_attention_with_lse(*args, causal=causal, window=w, fused=fused,
                                        kv_lens=None if lens is None else torch.from_numpy(lens))
    obj = (out * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dlse)).sum()
    for j, t, name in zip(jg, torch.autograd.grad(obj, args), "qkv"):
        np.testing.assert_allclose(t.numpy(), j, atol=2e-5, rtol=1e-4, err_msg=f"d{name}")


# gpt-s and the decode-* models: d=256, 8 heads of 32, F=1024, 4 layers.
GPT_S = dict(d=256, hq=8, hkv=8, dh=32, f=1024)


# (slots, rows a slot, KV heads, cache extent, blocks a slot, layers):
# decode-full's B6 slab and paged, its B7 (spec_draft=4), decode-gqa2's B6
# and B7, decode-window256's rolling slab, B5.
PLAN_CASES = (
    (8, 1, 8, 1024, 0, 4),
    (8, 1, 8, 1024, 64, 4),
    (8, 5, 8, 1024, 64, 4),
    (8, 1, 2, 1024, 0, 4),
    (8, 5, 2, 1024, 64, 4),
    (8, 1, 8, 256, 0, 4),
    (8, 1, 8, 1024, 0, 1),
)


@pytest.mark.parametrize("s,r,hkv,c,mb,n", PLAN_CASES)
def test_coop_plan_at_gpt_s_widths(s, r, hkv, c, mb, n):
    """The cooperative plan takes head_dim 32: at gpt-s widths every
    shape of the slice is one launch, one score tile, with the layout
    checks of test_torch_decode.py; decode-gqa2's KV width (64) bounds its
    q/k/v tiles."""
    dims = dict(GPT_S, hkv=hkv, n_layers=n)
    plan = _plan(s, r, c, mb, **dims)
    _check_plan(plan, s, r, c, mb, nsm=132, occupancy=1, **dims)
    assert plan.kb == c and plan.tasks == s * hkv
    assert (hkv * 32) % plan.products[0].tile_cols == 0


@pytest.mark.parametrize("s,want", [(8, 8), (64, 64), (100, 64)])
def test_block_group_at_gpt_s(s, want):
    """At gpt-s widths a launch takes 64 rows: 64 slots of the decode step,
    12 of decode-gqa2's verify at spec_draft=4."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    assert fd.slot_group(s, 1, *GPT_S.values(), 1024, 0, 132, H100_SMEM) == want
    assert fd.slot_group(s, 5, 256, 8, 2, 32, 1024, 1024, 64, 132, H100_SMEM) == min(s, 12)


# -- the model -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(dtype="float32", pos="learned", hkv=None):
    kw = dict(D32, pos_embedding=pos, num_kv_heads=hkv)
    jm, tm = jax_model(dtype, **kw), torch_model(dtype, **kw)
    assert tm.head_dim == 32
    tree = numpy_params(jm, seed=31)
    return jm, tm, jax_params(tree), torch_params(tree)


@pytest.mark.parametrize("engine,pos,hkv", [("fused", "learned", None),
                                            ("fused-layer", "learned", None),
                                            ("fused", "rope", 1)])
def test_head_dim_32_decode_slots_matches_jax_xla(engine, pos, hkv):
    """A ragged prefill, then sixteen decode steps through the slot cache:
    logits within the decode tolerance, greedy tokens bit for bit (f32),
    the cache as JAX's XLA engine leaves it; one row inactive."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(pos=pos, hkv=hkv)
    rng = np.random.default_rng(3)
    s, l = 4, 12
    toks = rng.integers(0, 97, (s, l)).astype(np.int32)
    lens = np.array([5, 12, 8, 1], np.int32)
    admit = np.ones(s, bool)
    jl, jc = jm.prefill_slots(jp, jm.empty_slot_cache(s), jnp.asarray(toks), jnp.asarray(lens),
                              jnp.asarray(admit))
    tl, tc = tm.prefill_slots(tp, tm.empty_slot_cache(s, device="cpu"), torch.from_numpy(toks),
                              torch.from_numpy(lens), torch.from_numpy(admit))
    assert max_err(jl, tl.numpy()) < TOL["float32"]
    act = np.array([True, False, True, True])
    jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(16):
        jl, jc = jm.decode_slots(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_slots(tp, torch.from_numpy(jt.copy()), tc, torch.from_numpy(act),
                                 engine=engine)
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL["float32"]
        jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(jt[act], tl.argmax(-1).numpy()[act])
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    assert max_err(np.asarray(jc.k), tc.k.float().numpy()) < TOL["float32"]


@pytest.mark.parametrize("engine,hkv", [("fused", None), ("fused-layer", 1)])
def test_head_dim_32_paged_extend_decode_verify_match_jax(engine, hkv):
    """Through the block pool (blocks of 4, scrambled tables): a ragged
    extend, ten decode steps and a verify of drafts at prefixes that are
    not block-aligned, against the JAX XLA engine; greedy tokens bit for
    bit."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(hkv=hkv)
    s, bs, nb = 4, 4, 72
    tables = np.random.default_rng(5).permutation(nb)[: s * 16].reshape(s, 16).astype(np.int32)
    jc = jm.empty_paged_cache(s, nb, bs)._replace(block_tables=jnp.asarray(tables))
    tc = tm.empty_paged_cache(s, nb, bs, device="cpu")._replace(
        block_tables=torch.from_numpy(tables))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 97, (s, 14)).astype(np.int32)
    slens = np.array([14, 3, 9, 11], np.int32)
    args = (toks, slens, np.zeros(s, np.int32), np.ones(s, bool))
    jl, jc = jm.extend_paged(jp, jc, *(jnp.asarray(a) for a in args))
    tl, tc = tm.extend_paged(tp, tc, *(torch.from_numpy(a) for a in args))
    real = np.arange(14)[None, :] < slens[:, None]
    assert max_err(np.asarray(jl)[real], tl.numpy()[real]) < TOL["float32"]
    jc = jc._replace(lengths=jnp.asarray(slens))
    tc = tc._replace(lengths=torch.from_numpy(slens.copy()))
    jt = np.asarray(jl)[np.arange(s), slens - 1].argmax(-1).astype(np.int32)
    act = np.array([True, True, True, False])
    for _ in range(10):
        jl, jc = jm.decode_paged(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_paged(tp, torch.from_numpy(jt.copy()), tc, torch.from_numpy(act),
                                 engine=engine)
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL["float32"]
        jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(jt[act], tl.argmax(-1).numpy()[act])
    draft = rng.integers(0, 97, (s, 5)).astype(np.int32)
    vargs = (draft, np.array([5, 1, 3, 2], np.int32), np.asarray(jc.lengths), act)
    jl, jc = jm.verify_paged(jp, jc, *(jnp.asarray(a) for a in vargs), engine="xla")
    tl, tc = tm.verify_paged(tp, tc, *(torch.from_numpy(np.array(a)) for a in vargs),
                             engine=engine)
    real = (np.arange(5)[None, :] < vargs[1][:, None]) & act[:, None]
    assert max_err(np.asarray(jl)[real], tl.numpy()[real]) < TOL["float32"]
    assert max_err(np.asarray(jc.k), tc.k.float().numpy()) < 1e-5


@pytest.mark.parametrize("engine", ["fused", "fused-layer"])
def test_head_dim_32_single_sequence_decode_matches_jax(engine):
    """``prefill``, eight ``decode_step``s and ``greedy_decode`` of the
    Dh=32 model: logits within tolerance, tokens bit for bit."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models()
    prompt = np.random.default_rng(7).integers(0, 97, (2, 9)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(prompt))
    tl, tc = tm.prefill(tp, torch.from_numpy(prompt))
    assert max_err(jl, tl.numpy()) < TOL["float32"]
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, tl.argmax(-1).numpy())
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, engine=engine)
        assert max_err(jl, tl.numpy()) < TOL["float32"]
    want = jm.greedy_decode(jp, jnp.asarray(prompt), 24)
    got = tm.greedy_decode(tp, torch.from_numpy(prompt), 24, engine=engine)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("paged,spec", [(False, 0), (True, 0), (True, 4)])
def test_head_dim_32_textserver_greedy_streams_match_jax(paged, spec):
    """TextServer greedy streams of the Dh=32 f32 model (slab; paged with
    the prefix cache, with and without speculation) equal the JAX
    TextServer's token for token."""
    from distributed_tensorflow_tpu.serve import GenerationConfig as JCfg
    from distributed_tensorflow_tpu.serve import TextServer as JServer
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    jm, tm, jp, tp = _models()
    kw = dict(slots=2, chunk=4, buckets=(8, 16), paged=paged,
              **({"block_size": 4, "spec_draft": spec} if paged else {}))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 12, 14, 3)]
    prompts[1] = np.tile(np.array([7, 3, 9, 1], np.int32), 3)  # the drafter matches
    want = JServer(jm, jp, decode_engine="xla", **kw).generate(prompts, JCfg(max_new=16))
    srv = TextServer(tm, tp, device="cpu", **kw)
    got = srv.generate(prompts, GenerationConfig(max_new=16))
    assert [o.tolist() for o in got] == [np.asarray(o).tolist() for o in want]
    if spec:
        assert srv.counters["spec_tokens_accepted"] > 0


def test_head_dim_32_lm_trainer_matches_jax():
    """One epoch of ``LMTrainer`` at D=32 with ``attention_impl="flash"``
    (8 steps of the copy task) against the JAX trainer from the same params
    (its flash through the Pallas kernels in interpret mode): the loss and
    gradients at the start, every step's printed cost, the epoch's
    perplexity and the final parameters."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data.tokens import copy_corpus as jcopy
    from distributed_tensorflow_tpu.models.gpt import GPTLM as JGPT
    from distributed_tensorflow_tpu.train import LMTrainer as JTrainer
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, lm_value_and_grad
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    kw = dict(vocab_size=61, max_len=16, model_dim=64, num_heads=2, num_layers=2,
              attention_impl="flash", flash_min_len=0)
    corpus = dict(num=768, half_len=8, vocab=61, n_val=128, n_test=128, seed=0)
    cfg = dict(epochs=1, batch_size=64, optimizer="adam", learning_rate=3e-3, log_frequency=1,
               scan_epoch=False)
    jl, tl = [], []
    jtr = JTrainer(JGPT(**kw, compute_dtype=jnp.float32), jcopy(**corpus), JConfig(**cfg),
                   print_fn=jl.append)
    model = GPTLM(**kw, compute_dtype=torch.float32)
    assert model.head_dim == 32
    ttr = LMTrainer(model, copy_corpus(**corpus), TrainConfig(**cfg), device="cpu",
                    print_fn=tl.append)
    ttr.state = ttr._init_state(gpt_params_from_numpy(jtr.state.params, device="cpu"))
    toks = copy_corpus(**corpus).train.tokens[:8]
    jloss, jg = jax.value_and_grad(jtr.model.loss)(jtr.state.params, jnp.asarray(toks))
    tloss, tg = lm_value_and_grad(model, ttr.state.params, torch.from_numpy(toks))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    for a, b in ((jg.blocks.wq, tg.blocks.wq), (jg.blocks.wk, tg.blocks.wk),
                 (jg.embed, tg.embed)):
        assert max_err(a, b.numpy()) <= 1e-4 * max(float(np.abs(np.asarray(a)).max()), 1e-6)
    jtr.run()
    ttr.run()

    def costs(lines):
        return [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in lines
                if "Cost:" in ln]

    jc, tc = costs(jl), costs(tl)
    assert len(jc) == len(tc) > 8
    assert max(abs(a - b) for a, b in zip(jc, tc)) <= 2e-4  # printed to 4 places
    for a, b in zip(jtr.history, ttr.history):
        assert abs(a["perplexity"] - b["perplexity"]) <= 1e-4 * a["perplexity"]
    assert max_err(jtr.state.params.blocks.wq, ttr.state.params.blocks.wq.numpy()) < 1e-4


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


# (dtype, L, query heads, KV heads, window, kv_lens) at D=32: the forward's
# tiles are 128 queries by 64 keys, the backward's 32 x 64 (kv) and 64 x 32
# (dq); the window banded and not.
GPU_FLASH_CASES = (
    ("float32", 512, 8, 8, None, None),
    ("bfloat16", 130, 4, 2, None, "ragged"),
    ("float32", 1023, 8, 8, None, "ragged"),
    ("float32", 2048, 8, 8, 512, None),
    ("bfloat16", 300, 8, 2, 65, "ragged"),
    ("float32", 77, 4, 1, 100, None),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,hq,hkv,w,lens_mode", GPU_FLASH_CASES)
def test_flash_head_dim_32_kernels_match_plain_on_gpu(dtype, l, hq, hkv, w, lens_mode):
    """B3 at D=32 against the plain forward (out and lse), then B4a (fused)
    and B4b + B4c (the pair) against the plain backward, at
    test_torch_flash_bwd.py's tolerances."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(l + hq)
    dt = getattr(torch, dtype)
    b = 2
    q, do = (torch.randn(b, l, hq, 32, device=dev, generator=g).to(dt) for _ in range(2))
    k, v = (torch.randn(b, l, hkv, 32, device=dev, generator=g).to(dt) for _ in range(2))
    lens = (torch.randint(1, l + 1, (b,), device=dev, generator=g, dtype=torch.int32)
            if lens_mode else None)
    kw = dict(causal=True, window=w, kv_lens=lens)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * scale
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() < 1e-4 * max(1.0, ref_lse.abs().max().item())
    delta = (do.float() * out.float()).sum(-1)
    plain = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, lens, True, w)
    fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    split = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == "float32" else 1e-2
    for got in (fused, split):
        for a, r, name in zip(got, plain, ("dq", "dk", "dv")):
            bound = rel * max(1.0, r.float().abs().max().item())
            assert (a.float() - r.float()).abs().max().item() <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,kv_dtype,rope", [(8, "bf16", False), (2, "bf16", True),
                                               (8, "int8", False)])
def test_decode_head_dim_32_kernels_match_plain_on_gpu(hkv, kv_dtype, rope):
    """B5, B6 (slab and paged) and B7 at gpt-s widths (d=256, 8 heads of 32,
    2 layers) against their plain versions at the decode tolerance; paged
    equal to slab bit for bit, B5 layer by layer with the commits equal to
    B6."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.ops.quantized import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(11)
    n, s, c, hq, dh, bs = 2, 8, 256, 8, 32, 16
    d, f = hq * dh, 4 * hq * dh

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, device="cuda", generator=g) * scale).to(dt)

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, f, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, (k, m) in dict(wq=(d, d), wk=(d, hkv * dh), wv=(d, hkv * dh), wo=(d, d),
                           w_up=(d, f), w_down=(f, d)).items():
        w[nm] = r(n, k, m, scale=k ** -0.5, dt=torch.bfloat16)
    raw = [r(n, s, c, hkv, dh) for _ in range(2)]
    if kv_dtype == "bf16":
        cache = [raw[0].bfloat16(), raw[1].bfloat16(), None, None]
    else:
        (a, sa), (b_, sb) = quantize_kv(raw[0], kv_dtype), quantize_kv(raw[1], kv_dtype)
        cache = [a, b_, sa, sb]
    lengths = torch.tensor([0, 1, 17, 96, 128, 200, 254, 255], device="cuda")
    act = torch.ones(s, dtype=torch.bool, device="cuda")
    act[2] = False
    x = r(s, d)
    kw = dict(num_heads=hq, rope=rope, compute_dtype=torch.bfloat16)
    quant = cache[2] is not None

    def close(a, b):
        return (a.float() - b.float()).abs().max().item() <= 2e-2 * max(
            1.0, b.float().abs().max().item())

    def sc(ts, i=None):
        if not quant:
            return {}
        return dict(k_scale=ts[2] if i is None else ts[2][i],
                    v_scale=ts[3] if i is None else ts[3][i])

    def clone(ts):
        return [None if t is None else t.clone() for t in ts]

    w0 = {k: t[0] for k, t in w.items()}
    got = fd.decode_block_slab(x, w0, cache[0][0], cache[1][0], lengths, **kw, **sc(cache, 0))
    ref = fd.decode_block_slab_plain(x, w0, cache[0][0], cache[1][0], lengths, **kw,
                                     **sc(cache, 0))
    assert close(got[0], ref[0])
    k1, k2 = clone(cache), clone(cache)
    o1 = fd.decode_token_slab(x, w, k1[0], k1[1], lengths, act, **kw, **sc(k1))[0]
    o2 = fd.decode_token_slab_plain(x, w, k2[0], k2[1], lengths, act, **kw, **sc(k2))[0]
    torch.cuda.synchronize()
    assert close(o1, o2)
    k3 = clone(cache)
    h = x
    for i in range(n):
        wi = {k: t[i] for k, t in w.items()}
        h, kq, vq, kqs, vqs = fd.decode_block_slab(h, wi, k3[0][i], k3[1][i], lengths, **kw,
                                                   **sc(k3, i))
        ks_i, vs_i = (k3[2][i], k3[3][i]) if quant else (None, None)
        fd.commit_slot_rows(k3[0][i], k3[1][i], kq, vq, lengths, act, ks_i, vs_i, kqs, vqs)
    torch.cuda.synchronize()
    assert torch.equal(h, o1)  # B5 layer by layer == B6
    for a, b in zip(k3, k1):
        assert a is None or torch.equal(a, b)
    mb = c // bs
    tables = torch.randperm(s * mb, device="cuda", generator=g).reshape(s, mb).int()
    pools = []
    for t in cache:
        if t is None:
            pools.append(None)
            continue
        p = torch.empty((n, s * mb, bs) + tuple(t.shape[3:]), dtype=t.dtype, device="cuda")
        for i in range(s):
            p[:, tables[i].long()] = t[:, i].reshape((n, mb, bs) + tuple(t.shape[3:]))
        pools.append(p)
    p1 = clone(pools)
    o3 = fd.decode_token_paged(x, w, p1[0], p1[1], tables, lengths, act, **kw, **sc(p1))[0]
    torch.cuda.synchronize()
    assert torch.equal(o3, o1)  # paged == slab
    plens = torch.tensor([13, 0, 41, 70, 100, 3, 200, 250], device="cuda")
    slens = torch.tensor([5, 3, 1, 4, 5, 5, 2, 5], device="cuda")
    hv = r(s, 5, d)
    p4, p5 = clone(pools), clone(pools)
    o5 = fd.verify_tokens_paged(hv, w, p4[0], p4[1], tables, plens, slens, act, **kw, **sc(p4))
    o6 = fd.verify_tokens_paged_plain(hv, w, p5[0], p5[1], tables, plens, slens, act, **kw,
                                      **sc(p5))
    torch.cuda.synchronize()
    assert close(o5, o6)
