"""PyTorch port: sliding-window models (``window=W``) against the JAX
package — dense attention and the flash forward and backward with the
band (the JAX Pallas kernels in CPU interpret mode), the banded backward
choice, the rolling slab's prefill, the slot, paged and single-sequence
decodes (the JAX XLA engine is the oracle of the decode kernels), the
servers' greedy streams and a training step; on a GPU each kernel's
window variant against its plain version, at lengths that wrap a
rolling slab."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import (
    SMALL,
    jax_model,
    jax_params,
    max_err,
    numpy_params,
    torch_model,
    torch_params,
)

WIN = 8  # the small model's window: its slab holds 8 of max_len 64 rows
TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # as test_torch_decode.py's


def _inputs(b, l, hq, hkv, d, ragged, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    lens = rng.integers(1, l + 1, b).astype(np.int32) if ragged else None
    return q, k, v, lens


# (window, L, query heads, KV heads, ragged kv_lens): W=1 is self only,
# W=L equals causal; 4W <= L is the JAX package's banded regime.
ATTN_CASES = (
    (1, 32, 4, 4, False),
    (5, 32, 4, 2, True),
    (16, 64, 4, 4, True),
    (16, 32, 4, 1, False),
    (16, 32, 4, 2, True),
    (32, 32, 4, 4, True),
)


@pytest.mark.parametrize("w,l,hq,hkv,ragged", ATTN_CASES)
def test_window_attention_matches_jax_flash_and_dense(w, l, hq, hkv, ragged):
    """The port's dense attention and plain flash forward with a window
    against JAX ``dense_attention(window=)`` and the Pallas
    ``flash_attention_with_lse(window=, interpret=True)``. A row that sees
    no key (a padded row past kv_lens + W - 1) gives 0 in both flash
    versions and the mean of the values in both dense ones."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu.ops.ring_attention import dense_attention as jdense
    from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    q, k, v, lens = _inputs(2, l, hq, hkv, 16, ragged, seed=w * 100 + l + hkv)
    if ragged:
        lens[0] = 3  # rows 3 + W - 1 on see no key
    jl = None if lens is None else jnp.asarray(lens)
    ja = [jnp.asarray(a) for a in (q, k, v)]
    jo, jlse = jflash(*ja, causal=True, window=w, kv_lens=jl, interpret=True)
    jd = jdense(*ja, causal=True, window=w, kv_lens=jl)
    tl = None if lens is None else torch.from_numpy(lens)
    ta = [torch.from_numpy(a) for a in (q, k, v)]
    to, tlse = flash_attention_with_lse(*ta, causal=True, window=w, kv_lens=tl)
    td = dense_attention(*ta, causal=True, window=w, kv_lens=tl)
    # f32 throughout; the sums run in another order (1e-5 of O(1) values).
    assert max_err(jo, to.numpy()) < 1e-5
    assert max_err(jlse, tlse.numpy()) < 1e-5
    assert max_err(jd, td.numpy()) < 1e-5
    live = np.ones((2, l), bool)
    if ragged:
        live = np.arange(l)[None, :] < lens[:, None] + w - 1
    assert max_err(to.numpy()[live], td.numpy()[live]) < 1e-5
    if w >= l and not ragged:  # the band covers every key: causal attention
        tc = dense_attention(*ta, causal=True)
        assert max_err(td.numpy(), tc.numpy()) == 0.0


# (window, L, query heads, KV heads, kv_lens, lse cotangent)
BWD_CASES = (
    (4, 32, 4, 4, None, True),
    (16, 32, 4, 2, None, False),
    (8, 64, 4, 2, (13, 50), True),
    (1, 32, 2, 1, (9, 32), True),
)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_window_backward_matches_jax_vjp(case, fused):
    """dq, dk, dv of the port's flash (its plain backward on the CPU)
    against the JAX VJP through its fused or split Pallas kernels with the
    same window."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    w, l, hq, hkv, lens, with_dlse = case
    rng = np.random.default_rng(w + l)
    q = rng.standard_normal((2, l, hq, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, l, hkv, 8)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((2, l, hq, 8)).astype(np.float32)
    dlse = rng.standard_normal((2, l, hq)).astype(np.float32) if with_dlse else None
    lens = None if lens is None else np.asarray(lens, np.int32)
    jl = None if lens is None else jnp.asarray(lens)

    def f(q, k, v):
        return jflash(q, k, v, causal=True, window=w, kv_lens=jl, interpret=True, fused=fused)

    (_, jlse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ct = jnp.zeros_like(jlse) if dlse is None else jnp.asarray(dlse)
    jg = [np.asarray(g) for g in vjp((jnp.asarray(do), ct))]
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = flash_attention_with_lse(*args, causal=True, window=w,
                                        kv_lens=None if lens is None else torch.from_numpy(lens),
                                        fused=fused)
    obj = (out * torch.from_numpy(do)).sum()
    if dlse is not None:
        obj = obj + (lse * torch.from_numpy(dlse)).sum()
    tg = torch.autograd.grad(obj, args)
    for j, t, name in zip(jg, tg, "qkv"):  # as test_torch_flash_bwd.py's
        np.testing.assert_allclose(t.numpy(), j, atol=2e-5, rtol=1e-4, err_msg=f"d{name}")


def test_resolve_fused_takes_the_split_pair_when_banded_as_jax():
    """The backward choice with a window, on a grid of (W, L), equals JAX
    ``_resolve_fused`` at the port's key tile: banded (4W <= L) takes the
    dq + dk/dv pair, an explicit bool wins."""
    from distributed_tensorflow_tpu.ops.pallas_attention import _resolve_fused
    from distributed_tensorflow_tpu_torch.ops.flash_attention import BLOCK_K, resolve_fused

    for w in (None, 1, 16, 64, 128, 256, 512, 1024, 2048):
        for l in (64, 256, 512, 1024, 2048):
            for fused in (None, True, False):
                want = _resolve_fused(fused, 128, l, 64, BLOCK_K, w)
                assert resolve_fused(fused, 128, l, 64, w) is want, (w, l, fused)
    assert resolve_fused(None, 128, 1024, 64, 256) is False  # gpt-m-L1024-W256
    assert resolve_fused(None, 128, 1024, 64, 512) is True  # 4W > L: the fused kernel


def test_window_refusals_match_jax():
    """The JAX package's refusals: a window below 1, and a window without
    ``causal``, in dense attention, flash and the model."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.ring_attention import dense_attention as jdense
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 8, 2, 16)
    jq = jnp.zeros((1, 8, 2, 16))
    for kw, msg in (({"causal": False, "window": 4}, "window requires causal=True"),
                    ({"causal": True, "window": 0}, "window must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            jdense(jq, jq, jq, **kw)
        for fn in (dense_attention, flash_attention):
            with pytest.raises(ValueError, match=msg):
                fn(q, q, q, **kw)
    with pytest.raises(ValueError, match="window must be >= 1"):
        GPTLM(window=0)
    m = GPTLM(max_len=64, window=16)
    assert m.window == 16 and m.cache_len == 16
    assert GPTLM(max_len=64, window=100).cache_len == 64


# -- the model -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(dtype="float32", pos="learned", impl="xla"):
    kw = dict(window=WIN, pos_embedding=pos)
    if impl == "flash":
        kw.update(attention_impl="flash", flash_min_len=0)
    jm, tm = jax_model(dtype, **kw), torch_model(dtype, **kw)
    tree = numpy_params(jm, seed=21)
    return jm, tm, jax_params(tree), torch_params(tree)


def _prefill_both(jm, tm, jp, tp, kv_dtype="bf16", seed=3):
    """A ragged prompt block with rows shorter and longer than the cache
    (C = WIN), into fresh slot caches on both sides."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    s, l = 4, 20
    toks = rng.integers(0, 97, (s, l)).astype(np.int32)
    lens = np.array([5, 20, 8, 13], np.int32)
    admit = np.ones(s, bool)
    jl, jc = jm.prefill_slots(jp, jm.empty_slot_cache(s, kv_dtype=kv_dtype), jnp.asarray(toks),
                              jnp.asarray(lens), jnp.asarray(admit))
    tl, tc = tm.prefill_slots(tp, tm.empty_slot_cache(s, kv_dtype, device="cpu"),
                              torch.from_numpy(toks), torch.from_numpy(lens),
                              torch.from_numpy(admit))
    return jl, jc, tl, tc


def _codes(x):
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 and x.dtype != np.int8 else x


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_rolling_prefill_slots_matches_jax(kv_dtype, impl):
    """Rows shorter than the cache pad, longer ones keep their last C
    positions at slot ``p % C``: the cache layout (codes and scales for an
    int8 cache), lengths and last logits equal JAX's."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(impl=impl)
    jl, jc, tl, tc = _prefill_both(jm, tm, jp, tp, kv_dtype)
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (2, 4, WIN, 4, 8)
    assert max_err(jl, tl.numpy()) < TOL["float32"]
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    if kv_dtype == "bf16":
        for a, b in ((jc.k, tc.k), (jc.v, tc.v)):
            assert max_err(np.asarray(a.astype(jnp.float32)), b.float().numpy()) < TOL["float32"]
    else:
        for a, b in ((jc.k, tc.k), (jc.v, tc.v)):  # codes at most one step apart
            assert np.abs(_codes(a).astype(np.int32) - b.numpy().astype(np.int32)).max() <= 1
        for a, b in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
            assert max_err(a, b.numpy()) < 1e-5 * float(np.abs(np.asarray(a)).max())


@pytest.mark.parametrize("dtype,engine,kv_dtype,pos", [
    ("float32", "fused", "bf16", "learned"),
    ("float32", "fused-layer", "bf16", "learned"),
    ("float32", "fused", "bf16", "rope"),
    ("bfloat16", "fused", "bf16", "learned"),
    ("float32", "fused", "int8", "learned"),
])
def test_windowed_decode_slots_matches_jax_xla(dtype, engine, kv_dtype, pos):
    """Twenty steps from lengths 5..20, well past the rolling slab's wrap at
    C = 8: logits within the decode tolerance, greedy tokens bit for bit
    (f32), caches and lengths as JAX's XLA engine leaves them; one row
    rides along inactive."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(dtype, pos)
    jl, jc, tl, tc = _prefill_both(jm, tm, jp, tp, kv_dtype, seed=4)
    act = np.array([True, True, False, True])
    jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    tt = tl.argmax(-1).to(torch.int32)
    for _ in range(20):
        jl, jc = jm.decode_slots(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_slots(tp, tt, tc, torch.from_numpy(act), engine=engine)
        scale = max(1.0, float(np.abs(np.asarray(jl)[act]).max()))
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL[dtype] * scale
        jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        if dtype == "float32":  # greedy streams equal
            np.testing.assert_array_equal(jt[act], tl.argmax(-1).numpy()[act])
        tt = torch.from_numpy(jt.copy())  # both continue from the reference stream
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    if kv_dtype == "bf16":
        assert max_err(np.asarray(jc.k.astype(jnp.float32)), tc.k.float().numpy()) < TOL[dtype]


def _paged_pair(dtype="float32", kv_dtype="bf16"):
    """Windowed JAX and port models and empty pools (blocks of 4) with the
    same scrambled tables."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(dtype)
    s, bs, nb = 4, 4, 72
    tables = np.random.default_rng(5).permutation(nb)[: s * 16].reshape(s, 16).astype(np.int32)
    jc = jm.empty_paged_cache(s, nb, bs, kv_dtype=kv_dtype)
    jc = jc._replace(block_tables=jnp.asarray(tables))
    tc = tm.empty_paged_cache(s, nb, bs, kv_dtype, device="cpu")
    tc = tc._replace(block_tables=torch.from_numpy(tables))
    return jm, tm, jp, tp, jc, tc


@pytest.mark.parametrize("engine", ["fused", "fused-layer"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_windowed_paged_extend_decode_verify_match_jax(kv_dtype, engine):
    """The paged pool keeps full history and masks the band: a ragged
    extend, twelve decode steps (lengths past W), then a verify at
    prefixes that are not block-aligned, each against the JAX XLA engine:
    logits within tolerance, greedy tokens bit for bit."""
    import jax.numpy as jnp

    jm, tm, jp, tp, jc, tc = _paged_pair(kv_dtype=kv_dtype)
    rng = np.random.default_rng(6)
    s = 4
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
    for _ in range(12):
        jl, jc = jm.decode_paged(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_paged(tp, torch.from_numpy(jt.copy()), tc, torch.from_numpy(act),
                                 engine=engine)
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL["float32"]
        jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(jt[act], tl.argmax(-1).numpy()[act])
    plens = np.asarray(jc.lengths)
    draft = rng.integers(0, 97, (s, 4)).astype(np.int32)
    vlens = np.array([4, 1, 3, 2], np.int32)
    vargs = (draft, vlens, plens, act)
    jl, jc = jm.verify_paged(jp, jc, *(jnp.asarray(a) for a in vargs), engine="xla")
    tl, tc = tm.verify_paged(tp, tc, *(torch.from_numpy(np.array(a)) for a in vargs),
                             engine=engine)
    real = (np.arange(4)[None, :] < vlens[:, None]) & act[:, None]
    assert max_err(np.asarray(jl)[real], tl.numpy()[real]) < TOL["float32"]
    if kv_dtype == "bf16":
        assert max_err(np.asarray(jc.k.astype(jnp.float32)), tc.k.float().numpy()) < 1e-5


@pytest.mark.parametrize("engine", ["fused", "fused-layer"])
def test_windowed_single_sequence_decode_matches_jax(engine):
    """``prefill`` of a prompt longer than the cache (the rolling layout),
    ``decode_step`` past the wrap and ``greedy_decode``: logits within
    tolerance, tokens bit for bit against the JAX package."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models()
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 97, (2, 11)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(prompt))
    tl, tc = tm.prefill(tp, torch.from_numpy(prompt))
    assert max_err(jl, tl.numpy()) < TOL["float32"]
    assert max_err(np.asarray(jc.k), tc.k.numpy()) < TOL["float32"]
    for _ in range(9):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, tl.argmax(-1).numpy())
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, engine=engine)
        assert max_err(jl, tl.numpy()) < TOL["float32"]
    want = jm.greedy_decode(jp, jnp.asarray(prompt), 30)
    got = tm.greedy_decode(tp, torch.from_numpy(prompt), 30, engine=engine)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("paged,spec,kv_dtype", [(False, 0, "bf16"), (True, 0, "bf16"),
                                                 (True, 3, "bf16"), (True, 3, "int8")])
def test_windowed_textserver_greedy_streams_match_jax(paged, spec, kv_dtype):
    """TextServer greedy streams of the windowed f32 model (slab: the
    rolling buffer; paged with the prefix cache, with and without
    speculation) equal the JAX TextServer's token for token, past the
    wrap; the slab's K/V bytes are the rolling buffer's."""
    from distributed_tensorflow_tpu.serve import GenerationConfig as JCfg
    from distributed_tensorflow_tpu.serve import TextServer as JServer
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    jm, tm, jp, tp = _models()
    kw = dict(slots=2, chunk=4, buckets=(8, 16), paged=paged, kv_dtype=kv_dtype,
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
    if not paged:
        assert srv.kv_slot_bytes == WIN * srv.kv_position_bytes
        assert tuple(srv._cache.k.shape[2:3]) == (WIN,)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_windowed_train_step_matches_jax(impl):
    """Loss and every gradient of a windowed model (dense attention, or
    flash: the band through the autograd Function) against
    ``jax.value_and_grad`` (its flash path through the Pallas kernels in
    interpret mode), then one ``make_lm_train_step`` step against JAX's."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.gpt import make_lm_train_step as jstep_of
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad, make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim

    kw = dict(window=WIN, **({"attention_impl": "flash", "flash_min_len": 0}
                             if impl == "flash" else {}))
    jm, tm = jax_model(**kw), torch_model(**kw)
    tree = numpy_params(jm, seed=9)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, SMALL["vocab_size"], (3, 32)).astype(np.int32)
    jl, jg = jax.value_and_grad(jm.loss)(jax_params(tree), jnp.asarray(toks))
    tl, tg = lm_value_and_grad(tm, torch_params(tree), torch.from_numpy(toks))
    assert abs(float(tl) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    jd, td = jg._asdict(), tg._asdict()
    pairs = [(jd[k], td[k]) for k in ("embed", "pos", "lnf_scale", "lnf_bias")]
    pairs += [(a, td["blocks"]._asdict()[k]) for k, a in jd["blocks"]._asdict().items()]
    for a, b in pairs:  # as test_torch_lm.py's f32 tolerance
        assert max_err(a, b.numpy()) <= 1e-4 * max(float(np.abs(np.asarray(a)).max()), 1e-6)
    jp, tp = jax_params(tree), torch_params(tree)
    jopt, topt = joptim.make("adam", 3e-3), optim.make("adam", 3e-3)
    jp, _, jloss = jstep_of(jm, jopt)(jp, jopt.init(jp), jnp.asarray(toks))
    tp, _, tloss = make_lm_train_step(tm, topt)(tp, topt.init(tp), torch.from_numpy(toks))
    assert abs(float(tloss) - float(jloss)) < 1e-5
    assert max_err(jp.blocks.wq, tp.blocks.wq.numpy()) < 5e-5


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


# (dtype, D, L, query heads, KV heads, window, kv_lens): the forward's
# tiles are 128 queries by 64 keys, the backward's 32 x 64 (kv) and
# 64/128 x 32 (dq); windows inside a tile, across tiles, at L and past it.
GPU_FLASH_CASES = (
    ("float32", 64, 77, 4, 2, 1, None),
    ("bfloat16", 64, 130, 4, 2, 16, "ragged"),
    ("float32", 64, 1023, 8, 8, 256, "ragged"),
    ("bfloat16", 64, 1024, 8, 2, 100, None),
    ("float32", 128, 200, 4, 1, 65, "short"),
    ("bfloat16", 128, 130, 8, 2, 130, "ragged"),
    ("float32", 64, 300, 4, 4, 500, None),
    ("float32", 64, 1024, 8, 8, 512, None),
)


def _gpu_flash_inputs(dtype, d, l, hq, hkv, lens_mode, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    b = 3
    q, do = (torch.randn(b, l, hq, d, device=dev, generator=g).to(dt) for _ in range(2))
    k, v = (torch.randn(b, l, hkv, d, device=dev, generator=g).to(dt) for _ in range(2))
    lens = None
    if lens_mode == "ragged":
        lens = torch.randint(1, l + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    elif lens_mode == "short":  # rows past kv_lens + W - 1 see no key
        lens = torch.tensor([1, 17, 63], device=dev, dtype=torch.int32)
    return q, k, v, do, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,l,hq,hkv,w,lens_mode", GPU_FLASH_CASES)
def test_flash_window_kernels_match_plain_on_gpu(dtype, d, l, hq, hkv, w, lens_mode):
    """B3's band against the plain forward (out and lse, rows that see no
    key included), then B4a (fused), B4b (dq) and B4c (dk/dv) with the
    window against the plain backward, at test_torch_flash_bwd.py's
    tolerances."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lens = _gpu_flash_inputs(dtype, d, l, hq, hkv, lens_mode, seed=w + l)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, window=w, kv_lens=lens)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True, window=w, kv_lens=lens)
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * scale
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() < 1e-4 * max(1.0, ref_lse.abs().max().item())
    delta = (do.float() * out.float()).sum(-1)
    kw = dict(causal=True, window=w, kv_lens=lens)
    plain = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, lens, True, w)
    fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    split = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == "float32" else 1e-2
    for got in (fused, split):
        for a, r, name in zip(got, plain, ("dq", "dk", "dv")):
            assert a.dtype == r.dtype and a.shape == r.shape
            bound = rel * max(1.0, r.float().abs().max().item())
            assert (a.float() - r.float()).abs().max().item() <= bound, name


@pytest.mark.cuda
def test_banded_forward_skips_tiles_on_gpu():
    """At S=8, L=1023 (the serving path's shapes) a band of 256 takes less
    time than causal attention: the kernel visits only the band's tiles."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(8, 1023, 8, 64, device="cuda", generator=g) for _ in range(3))

    def ms(**kw):
        for _ in range(3):
            flash_attention(q, k, v, causal=True, **kw)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            flash_attention(q, k, v, causal=True, **kw)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    assert ms(window=256) < ms()


def _gpu_decode_case(g, n, s, c, hq, hkv, dh, kv_dtype):
    """Random bf16 weights for n layers and a full-history cache [n, s, c]
    (bf16, or int8 codes and scales)."""
    from distributed_tensorflow_tpu_torch.ops.quantized import quantize_kv

    d, f = hq * dh, 4 * hq * dh

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, device="cuda", generator=g) * scale).to(dt)

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, f, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, shape in (("wq", (n, d, d)), ("wk", (n, d, hkv * dh)),
                      ("wv", (n, d, hkv * dh)), ("wo", (n, d, d)),
                      ("w_up", (n, d, f)), ("w_down", (n, f, d))):
        w[nm] = r(*shape, scale=shape[1] ** -0.5, dt=torch.bfloat16)
    kv = [r(n, s, c, hkv, dh) for _ in range(2)]
    if kv_dtype == "bf16":
        return w, r, [kv[0].bfloat16(), kv[1].bfloat16(), None, None]
    (ck, ks), (cv, vs) = quantize_kv(kv[0], kv_dtype), quantize_kv(kv[1], kv_dtype)
    return w, r, [ck, cv, ks, vs]


def _rolling(full, lengths, c):
    """A full-history slab tensor [n, S, E, ...] as a rolling slab [n, S, c,
    ...]: position p of slot s at slot p % c for the last c positions
    below lengths[s]; slots not written hold garbage (ones)."""
    out = torch.ones(full.shape[:2] + (c,) + full.shape[3:], dtype=full.dtype,
                     device=full.device)
    for s, ln in enumerate(lengths.tolist()):
        for p in range(max(0, ln - c), ln):
            out[:, s, p % c] = full[:, s, p]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,rope", [("bf16", False), ("bf16", True), ("int8", True)])
def test_decode_window_kernels_match_plain_on_gpu(kv_dtype, rope):
    """The window variants of B5, B6 (rolling slab of C = W = 16 at lengths
    that wrap it, and the windowed pool at the same absolute lengths) and
    B7 against their plain versions at the decode tolerance; the rolling
    slab's step equal to the paged one bit for bit (h and the committed
    rows), and B5 layer by layer with the commits equal to B6."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(43)
    n, s, e, hq, hkv, dh, w_, bs = 2, 4, 128, 4, 2, 64, 16, 8
    w, r, full = _gpu_decode_case(g, n, s, e, hq, hkv, dh, kv_dtype)
    lengths = torch.tensor([5, 16, 37, 100], device="cuda")
    act = torch.tensor([True, True, False, True], device="cuda")
    x = r(s, hq * dh)
    kw = dict(num_heads=hq, rope=rope, compute_dtype=torch.bfloat16, window=w_)
    roll = [None if t is None else _rolling(t, lengths, w_) for t in full]
    quant = roll[2] is not None
    tol = 2e-2

    def close(a, b):
        return (a.float() - b.float()).abs().max().item() <= tol * max(
            1.0, b.float().abs().max().item())

    def sc(ts, i=None):
        if not quant:
            return {}
        return dict(k_scale=ts[2] if i is None else ts[2][i],
                    v_scale=ts[3] if i is None else ts[3][i])

    def clone(ts):
        return [None if t is None else t.clone() for t in ts]

    # B5 slab (rolling) and B6 slab against their plain versions.
    got = fd.decode_block_slab(x, {k: t[0] for k, t in w.items()}, roll[0][0], roll[1][0],
                               lengths, **kw, **sc(roll, 0))
    ref = fd.decode_block_slab_plain(x, {k: t[0] for k, t in w.items()}, roll[0][0],
                                     roll[1][0], lengths, **kw, **sc(roll, 0))
    assert close(got[0], ref[0])
    k1, k2 = clone(roll), clone(roll)
    o1 = fd.decode_token_slab(x, w, k1[0], k1[1], lengths, act, **kw, **sc(k1))[0]
    o2 = fd.decode_token_slab_plain(x, w, k2[0], k2[1], lengths, act, **kw, **sc(k2))[0]
    torch.cuda.synchronize()
    assert close(o1, o2)
    if not quant:
        assert close(k1[0], k2[0]) and close(k1[1], k2[1])
    # B5 layer by layer with the rolling commit == B6, bit for bit.
    k3 = clone(roll)
    h = x
    for i in range(n):
        wi = {k: t[i] for k, t in w.items()}
        h, kq, vq, kqs, vqs = fd.decode_block_slab(h, wi, k3[0][i], k3[1][i], lengths, **kw,
                                                   **sc(k3, i))
        ks_i, vs_i = (k3[2][i], k3[3][i]) if quant else (None, None)
        fd.commit_slot_rows(k3[0][i], k3[1][i], kq, vq, lengths, act, ks_i, vs_i, kqs, vqs,
                            window=w_)
    torch.cuda.synchronize()
    assert torch.equal(h, o1)
    for a, b in zip(k3, k1):
        assert a is None or torch.equal(a, b)

    # The windowed pool at the same absolute lengths: B6 paged == the
    # rolling slab's B6 bit for bit, committed rows included.
    mb = e // bs
    nb = s * mb + 3
    tables = torch.randperm(nb, device="cuda", generator=g)[: s * mb].reshape(s, mb).int()
    pools = []
    for t in full:
        if t is None:
            pools.append(None)
            continue
        p = torch.zeros((n, nb, bs) + tuple(t.shape[3:]), dtype=t.dtype, device="cuda")
        for i in range(s):
            p[:, tables[i].long()] = t[:, i].reshape((n, mb, bs) + tuple(t.shape[3:]))
        pools.append(p)
    p1 = clone(pools)
    o3 = fd.decode_token_paged(x, w, p1[0], p1[1], tables, lengths, act, **kw, **sc(p1))[0]
    torch.cuda.synchronize()
    assert torch.equal(o3, o1)
    for i in range(s):
        if act[i]:
            ln = int(lengths[i])
            blk = tables[i, ln // bs].long()
            assert torch.equal(p1[0][:, blk, ln % bs], k1[0][:, i, ln % w_])
    p2 = clone(pools)
    o4 = fd.decode_token_paged_plain(x, w, p2[0], p2[1], tables, lengths, act, **kw,
                                     **sc(p2))[0]
    torch.cuda.synchronize()
    assert close(o3, o4)
    got = fd.decode_block_paged(x, {k: t[0] for k, t in w.items()}, pools[0][0], pools[1][0],
                                tables, lengths, **kw, **sc(pools, 0))
    want = fd.decode_block_slab(x, {k: t[0] for k, t in w.items()}, roll[0][0], roll[1][0],
                                lengths, **kw, **sc(roll, 0))
    assert torch.equal(got[0], want[0])

    # B7 with the band over the suffix and the cache.
    plens = torch.tensor([13, 0, 41, 70], device="cuda")
    slens = torch.tensor([5, 3, 1, 4], device="cuda")
    hv = r(s, 5, hq * dh)
    p4, p5 = clone(pools), clone(pools)
    o5 = fd.verify_tokens_paged(hv, w, p4[0], p4[1], tables, plens, slens, act, **kw, **sc(p4))
    o6 = fd.verify_tokens_paged_plain(hv, w, p5[0], p5[1], tables, plens, slens, act, **kw,
                                      **sc(p5))
    torch.cuda.synchronize()
    assert close(o5, o6)
    # A window of 1 sees only the row itself: the band, not the prefix, decides.
    o7 = fd.verify_tokens_paged(hv, w, clone(pools)[0], clone(pools)[1], tables, plens, slens,
                                act, **{**kw, "window": 1}, **sc(pools))
    o8 = fd.verify_tokens_paged_plain(hv, w, clone(pools)[0], clone(pools)[1], tables, plens,
                                      slens, act, **{**kw, "window": 1}, **sc(pools))
    torch.cuda.synchronize()
    assert close(o7, o8)
