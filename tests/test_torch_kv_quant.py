"""PyTorch port: int8/fp8 KV caches (``ops/quantized.py`` and the quantized
slab cache and pool through ``models/gpt.py`` and ``TextServer``) against
the JAX package's XLA engine on seeded numpy inputs, at small widths.

Quantization is compared code for code: int8 payloads and scales bitwise;
fp8 payloads differ from XLA's at a few midpoints, because XLA's f32 ->
e4m3 cast rounds twice (through an intermediate type, see the JAX
package's ``train/local_sgd.py:776``) where torch rounds once; such codes
are counted and bounded. Through the model, the port's products sum in
another order than XLA's, so an f32 value can land on the other side of
a quantization step: logits are held within ``TOL`` and payloads within
one code.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params

# f32 models: the products' order differs from XLA's; a value within one
# code of a step can quantize to the neighbouring code, which moves the
# logits by about one code's share of a row (1/127 of its amax for int8,
# 2^-3 relative for e4m3).
TOL = {"int8": 2e-2, "fp8": 6e-2}
# Share of fp8 codes that may differ from XLA's double-rounded cast.
FP8_CAST_SHARE = 0.01


def _bits(a):
    """Integer view of a payload (numpy, or torch) for code comparisons:
    int8 as is, e4m3 as its byte (sign-magnitude: a code step of one is one
    ulp)."""
    a = a.view(torch.uint8).numpy() if isinstance(a, torch.Tensor) and \
        a.dtype == torch.float8_e4m3fn else np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        a = a.view(np.uint8)
    if a.dtype == np.uint8:  # e4m3 byte -> signed ordinal
        mag = (a & 0x7F).astype(np.int64)
        return np.where(a & 0x80, -mag, mag)
    return a.astype(np.int64)


def _code_diff(jax_codes, torch_codes):
    """(largest code distance, share of codes that differ)."""
    d = np.abs(_bits(jax_codes) - _bits(torch_codes))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape,scale", [((3, 5, 2, 64), 1.0), ((4, 7, 16), 40.0),
                                         ((2, 3, 32), 1e-3)])
def test_quantize_kv_matches_jax(dtype, shape, scale):
    """``quantize_kv`` / ``dequantize_kv``: int8 codes and scales bitwise
    against the JAX package; fp8 scales bitwise and codes bitwise but for
    XLA's double-rounded midpoints (counted, at most one code apart, under
    ``FP8_CAST_SHARE``); an all-zero row gives zero codes."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import quantized as jq
    from distributed_tensorflow_tpu_torch.ops import quantized as tq

    rng = np.random.default_rng(sum(shape))
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    x[..., 0, :] = 0.0  # an all-zero row
    jcode, jscale = jq.quantize_kv(jnp.asarray(x), dtype)
    tcode, tscale = tq.quantize_kv(torch.from_numpy(x), dtype)
    np.testing.assert_array_equal(np.asarray(jscale), tscale.numpy())
    worst, share = _code_diff(jcode, tcode)
    if dtype == "int8":
        assert worst == 0
    else:
        assert worst <= 1 and share <= FP8_CAST_SHARE, (worst, share)
    assert (_bits(tcode)[..., 0, :] == 0).all()
    for out in (jnp.float32, jnp.bfloat16):
        ref = np.asarray(jq.dequantize_kv(jcode, jscale, out).astype(jnp.float32))
        got = tq.dequantize_kv(tcode, tscale, getattr(torch, out.dtype.name)).float().numpy()
        if dtype == "int8":
            np.testing.assert_array_equal(ref, got)
        else:  # the differing codes' values only
            same = _bits(jcode) == _bits(tcode)
            np.testing.assert_array_equal(ref[same], got[same])


def test_quantized_storage_and_bytes():
    from distributed_tensorflow_tpu.ops import quantized as jq
    from distributed_tensorflow_tpu_torch.ops import quantized as tq

    import jax.numpy as jnp

    assert tq.KV_DTYPES == jq.KV_DTYPES
    for kd in tq.KV_DTYPES:
        for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            assert tq.kv_elem_bytes(kd, td) == jq.kv_elem_bytes(kd, jd)
    assert tq.kv_storage_dtype("fp8", torch.bfloat16) == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="unknown kv dtype"):
        tq.kv_storage_dtype("int4", torch.bfloat16)
    with pytest.raises(ValueError, match="quantized dtype"):
        tq.quantize_kv(torch.zeros(2, 4), "bf16")


# -- the model's quantized caches against the JAX XLA engine -------------------

CASES = [(kd, pe) for kd in ("int8", "fp8") for pe in ("learned", "rope")]


@functools.lru_cache(maxsize=None)
def _models(pos_embedding):
    kw = dict(num_kv_heads=2, pos_embedding=pos_embedding)
    jm, tm = jax_model(**kw), torch_model(**kw)
    tree = numpy_params(jm, seed=31)
    return jm, tm, jax_params(tree), torch_params(tree)


def _check_cache(jc, tc, kv_dtype):
    """Codes within one step of XLA's, scales within a code's share."""
    for name in ("k", "v"):
        worst, _ = _code_diff(getattr(jc, name), getattr(tc, name))
        assert worst <= 1, (name, worst)
        js = np.asarray(getattr(jc, f"{name}_scale"))
        ts = getattr(tc, f"{name}_scale").numpy()
        assert np.allclose(js, ts, rtol=1e-4, atol=0), name
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())


@pytest.mark.parametrize("engine", ["fused", "fused-layer", "xla"])
@pytest.mark.parametrize("kv_dtype,pos", CASES)
def test_decode_slots_quantized_matches_jax_xla(kv_dtype, pos, engine):
    """prefill_slots then 4 decode_slots steps on an int8/fp8 slab cache,
    one row inactive: logits within TOL of the JAX XLA engine's, codes
    within one step, scales close; each engine's plain version on the
    CPU."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(pos)
    rng = np.random.default_rng(5)
    s, l = 4, 16
    toks = rng.integers(0, 97, (s, l)).astype(np.int32)
    lens = np.array([5, 16, 3, 9], np.int32)
    admit = np.ones(s, bool)
    jl, jc = jm.prefill_slots(jp, jm.empty_slot_cache(s, kv_dtype), jnp.asarray(toks),
                              jnp.asarray(lens), jnp.asarray(admit))
    tl, tc = tm.prefill_slots(tp, tm.empty_slot_cache(s, kv_dtype, device="cpu"),
                              torch.from_numpy(toks), torch.from_numpy(lens),
                              torch.from_numpy(admit))
    assert max_err(jl, tl.numpy()) < TOL[kv_dtype]
    _check_cache(jc, tc, kv_dtype)
    act = np.array([True, False, True, True])
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jm.decode_slots(jp, jnp.asarray(tok), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_slots(tp, torch.from_numpy(tok), tc, torch.from_numpy(act),
                                 engine=engine)
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL[kv_dtype]
        _check_cache(jc, tc, kv_dtype)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)  # both from JAX's pick


def _tables(s, mb, nb, seed):
    rng = np.random.default_rng(seed)
    return rng.permutation(nb)[: s * mb].reshape(s, mb).astype(np.int32)


@pytest.mark.parametrize("kv_dtype,pos", CASES)
def test_paged_quantized_matches_jax_xla(kv_dtype, pos):
    """On an int8/fp8 pool under scrambled tables: extend_paged (a
    prefill, then an extend at block-aligned and ragged prefixes),
    decode_paged on each engine and verify_paged on the verify kernel's
    plain version, against the JAX XLA engine: logits within TOL, codes
    within one step, scales close."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(pos)
    s, bs = 3, 4
    mb = tm.paged_blocks_per_slot(bs)
    nb = s * mb + 2
    tables = _tables(s, mb, nb, 9)
    jc = jm.empty_paged_cache(s, nb, bs, kv_dtype)._replace(block_tables=jnp.asarray(tables))
    tc = tm.empty_paged_cache(s, nb, bs, kv_dtype, device="cpu")._replace(
        block_tables=torch.from_numpy(tables))
    rng = np.random.default_rng(4)

    def both_extend(toks, slens, plens, admit, verify=False):
        nonlocal jc, tc
        a = [np.asarray(x) for x in (toks, slens, plens, admit)]
        jl, jc = (jm.verify_paged if verify else jm.extend_paged)(
            jp, jc, *map(jnp.asarray, a), **({"engine": "xla"} if verify else {}))
        args = [torch.from_numpy(x) for x in a]
        tl, tc = (tm.verify_paged(tp, tc, *args, engine="fused") if verify
                  else tm.extend_paged(tp, tc, *args))
        valid = np.arange(a[0].shape[1])[None, :] < a[1][:, None]
        assert max_err(np.asarray(jl)[valid], tl.numpy()[valid]) < TOL[kv_dtype]
        _check_cache(jc, tc, kv_dtype)

    slens = np.array([9, 4, 12], np.int32)
    both_extend(rng.integers(0, 97, (s, 12)).astype(np.int32), slens,
                np.zeros(s, np.int32), np.ones(s, bool))
    plens = np.array([8, 6, 12], np.int32)  # block-aligned, ragged
    sl2 = np.array([5, 3, 2], np.int32)
    both_extend(rng.integers(0, 97, (s, 5)).astype(np.int32), sl2, plens,
                np.array([True, True, False]))
    lengths = np.where([True, True, False], plens + sl2, slens).astype(np.int32)
    jc = jc._replace(lengths=jnp.asarray(lengths))
    tc = tc._replace(lengths=torch.from_numpy(lengths))
    act = np.array([True, True, True])
    for eng in ("fused", "fused-layer", "xla"):
        tok = rng.integers(0, 97, s).astype(np.int32)
        jl, jc2 = jm.decode_paged(jp, jnp.asarray(tok), jc, jnp.asarray(act), engine="xla")
        tc2 = tc._replace(**{f: getattr(tc, f).clone() for f in ("k", "v", "k_scale",
                                                                    "v_scale")})
        tl, tc2 = tm.decode_paged(tp, torch.from_numpy(tok), tc2, torch.from_numpy(act),
                                  engine=eng)
        assert max_err(jl, tl.numpy()) < TOL[kv_dtype]
        _check_cache(jc2, tc2, kv_dtype)
    # The speculation verify (the kernel's plain version) at the lengths.
    both_extend(rng.integers(0, 97, (s, 4)).astype(np.int32), np.array([4, 1, 3], np.int32),
                lengths, np.array([True, True, False]), verify=True)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_paged_equals_quantized_slab(kv_dtype):
    """A prefilled int8/fp8 slab cache copied into a scrambled pool: one
    decode step on each engine gives the same logits and stored rows bit
    for bit on both layouts (the layouts' arithmetic is the same)."""
    _, tm, _, tp = _models("rope")
    s, bs, l = 3, 4, 12
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 97, (s, l)).astype(np.int32))
    lens = torch.tensor([12, 7, 3], dtype=torch.int32)
    admit = torch.ones(s, dtype=torch.bool)
    _, slab = tm.prefill_slots(tp, tm.empty_slot_cache(s, kv_dtype, device="cpu"), toks, lens,
                               admit)
    mb = tm.paged_blocks_per_slot(bs)
    nb = s * mb + 1
    tables = torch.from_numpy(_tables(s, mb, nb, 3))
    pool = tm.empty_paged_cache(s, nb, bs, kv_dtype, device="cpu")
    pool = pool._replace(block_tables=tables, lengths=lens.clone(),
                         **{f: _pool(getattr(slab, f), tables, nb, bs)
                            for f in ("k", "v", "k_scale", "v_scale")})
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    for eng in ("fused", "fused-layer", "xla"):
        a = tm.decode_slots(tp, tok, slab._replace(k=slab.k.clone(), v=slab.v.clone(),
                                                   k_scale=slab.k_scale.clone(),
                                                   v_scale=slab.v_scale.clone()),
                            engine=eng)
        b = tm.decode_paged(tp, tok, pool._replace(k=pool.k.clone(), v=pool.v.clone(),
                                                   k_scale=pool.k_scale.clone(),
                                                   v_scale=pool.v_scale.clone()),
                            engine=eng)
        assert torch.equal(a[0], b[0]), eng
        from distributed_tensorflow_tpu_torch.ops.paged_attention import gather_block_view
        for name in ("k", "k_scale"):
            view = torch.stack([gather_block_view(t, tables) for t in getattr(b[1], name)])
            assert torch.equal(_u8(view), _u8(getattr(a[1], name))), (eng, name)


# -- serving ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _serve_models(pos):
    kw = dict(pos_embedding=pos)
    jm, tm = jax_model(**kw), torch_model(**kw)
    tree = numpy_params(jm, seed=17)
    return jm, tm, jax_params(tree), torch_params(tree)


def _requests():
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 9, 13, 4)]
    prompts[0] = np.tile(np.array([7, 3, 9, 1], np.int32), 3)  # the drafter matches
    return prompts


@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("kv_dtype,paged,spec", [("int8", False, 0), ("int8", True, 3),
                                                  ("fp8", True, 0), ("fp8", True, 3)])
def test_textserver_quantized_greedy_streams_match_jax(kv_dtype, paged, spec, pos):
    """TextServer(kv_dtype=...) greedy streams (slab; paged with the prefix
    cache, with and without speculation) equal the JAX TextServer's at the
    same kv_dtype, token for token, for an f32 tiny model."""
    from distributed_tensorflow_tpu.serve import GenerationConfig as JCfg
    from distributed_tensorflow_tpu.serve import TextServer as JServer
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    jm, tm, jp, tp = _serve_models(pos)
    kw = dict(slots=2, chunk=4, buckets=(8, 16), paged=paged, kv_dtype=kv_dtype,
              **({"block_size": 4, "spec_draft": spec} if paged else {}))
    prompts = _requests()
    want = JServer(jm, jp, decode_engine="xla", **kw).generate(prompts, JCfg(max_new=8))
    srv = TextServer(tm, tp, device="cpu", **kw)
    got = srv.generate(prompts, GenerationConfig(max_new=8))
    assert [o.tolist() for o in got] == [np.asarray(o).tolist() for o in want]
    assert srv._cache.k.dtype == (torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn)
    if spec:
        assert srv.counters["spec_tokens_accepted"] > 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_hbm_bytes_pool_sizing_matches_jax(kv_dtype, dtype):
    """``kv_hbm_bytes`` derives the same block count and byte accounting as
    the JAX TextServer (scales charged), and the serve_pool helpers agree."""
    from distributed_tensorflow_tpu import serve_pool as jpool
    from distributed_tensorflow_tpu.serve import TextServer as JServer
    from distributed_tensorflow_tpu_torch import serve_pool as tpool
    from distributed_tensorflow_tpu_torch.serve import TextServer

    jm, tm = jax_model(dtype, num_kv_heads=2), torch_model(dtype, num_kv_heads=2)
    budget = 3 << 16
    js = JServer(jm, None, slots=2, paged=True, block_size=4, kv_hbm_bytes=budget,
                 kv_dtype=kv_dtype)
    ts = TextServer(tm, tm.init(seed=0, device="cpu"), slots=2, paged=True, block_size=4,
                    kv_hbm_bytes=budget, kv_dtype=kv_dtype, device="cpu")
    assert (ts.kv_blocks, ts.kv_position_bytes, ts.kv_block_bytes) == (
        js.kv_blocks, js.kv_position_bytes, js.kv_block_bytes)
    geo = dict(num_layers=2, kv_heads=2, head_dim=8, elem_bytes=1, scale_bytes=4)
    assert tpool.kv_position_bytes(**geo) == jpool.kv_position_bytes(**geo)
    assert tpool.kv_block_bytes(16, **geo) == jpool.kv_block_bytes(16, **geo)
    assert tpool.blocks_for_hbm_bytes(10000, 16, **geo) == jpool.blocks_for_hbm_bytes(
        10000, 16, **geo)


def test_textserver_kv_knob_validation():
    """The JAX TextServer's refusals: an unknown kv_dtype, kv_hbm_bytes
    without paged, kv_hbm_bytes with kv_blocks, a budget under one block."""
    from distributed_tensorflow_tpu_torch.serve import TextServer

    tm = torch_model()
    tp = tm.init(seed=0, device="cpu")
    for kw, msg in (({"kv_dtype": "int4"}, "unknown kv_dtype"),
                    ({"kv_hbm_bytes": 1 << 20}, "paged=True"),
                    ({"paged": True, "kv_hbm_bytes": 1 << 20, "kv_blocks": 4}, "not both"),
                    ({"paged": True, "kv_hbm_bytes": 8}, "holds no")):
        with pytest.raises(ValueError, match=msg):
            TextServer(tm, tp, device="cpu", **kw)


# -- engine resolution ---------------------------------------------------------


def test_engine_resolution():
    """"xla" is accepted (knob, per call, server); an unknown name raises;
    "auto" resolves to the megakernel, never to "xla", for every model the
    port builds (f32 and bf16, learned and RoPE)."""
    from distributed_tensorflow_tpu_torch.models.gpt import DECODE_ENGINES, GPTLM
    from distributed_tensorflow_tpu_torch.serve import TextServer

    assert DECODE_ENGINES == ("auto", "fused", "fused-layer", "xla")
    for dt in (torch.float32, torch.bfloat16):
        for pe in ("learned", "rope"):
            m = GPTLM(compute_dtype=dt, pos_embedding=pe)
            assert m._resolve_decode_engine(None) == "fused"
            assert m._resolve_decode_engine("auto") == "fused"
            assert m._resolve_decode_engine("xla") == "xla"
    assert GPTLM(decode_engine="xla")._resolve_decode_engine(None) == "xla"
    with pytest.raises(ValueError, match="unknown decode engine"):
        GPTLM()._resolve_decode_engine("pallas-layer")
    tm = torch_model()
    TextServer(tm, tm.init(seed=0, device="cpu"), decode_engine="xla", device="cpu")


# -- the kernels on the card ---------------------------------------------------


def _gpu_case(g, n, s, c, hq, hkv, dh, kv_dtype):
    """Seeded weights and a cache of codes and scales (a quantized random
    bf16 cache), on the card."""
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
        return w, r, kv[0].bfloat16(), kv[1].bfloat16(), None, None
    (ck, ks), (cv, vs) = quantize_kv(kv[0], kv_dtype), quantize_kv(kv[1], kv_dtype)
    return w, r, ck, cv, ks, vs


# Kernel vs plain on the card: bf16 intermediates may round to neighbouring
# values (test_torch_decode.py's 2e-2); with an e4m3 cache a fresh code may
# also land one step (2^-3 relative) from the plain one, which moves a
# short-context attention row by up to that share of a value.
GPU_TOL = {"bf16": 2e-2, "int8": 2e-2, "fp8": 6e-2}


def _close(a, b, tol=2e-2):
    err = (a.float() - b.float()).abs().max().item()
    bound = tol * max(1.0, b.float().abs().max().item())
    assert err <= bound, f"error {err} > {bound}"
    return True


def _scales_close(a, b, tol=2e-2):
    """Row scales within ``tol`` of the plain ones, relative to the largest."""
    err = (a - b).abs().max().item()
    assert err <= tol * b.abs().max().item(), f"scale error {err}"
    return True


def _codes_close(a, b):
    """1-byte codes at most one step apart (bf16: within the tolerance)."""
    if a.dtype == torch.bfloat16:
        return _close(a, b)
    worst = int(np.abs(_bits(a.cpu()) - _bits(b.cpu())).max())
    assert worst <= 1, f"codes {worst} steps apart"
    return True


def _step(codes, scale):
    """The value spacing at each code (x its row's scale): int8 1, e4m3
    2^(e - 10) for exponent field e >= 1 (2^-9 below)."""
    if codes.dtype == torch.int8:
        step = torch.ones_like(codes, dtype=torch.float32)
    else:
        e = ((codes.view(torch.uint8).int() >> 3) & 15).clamp(min=1)
        step = torch.exp2((e - 10).float())
    return step * scale[..., None]


def _cache_close(a, b, sa, sb, tol):
    """A cache of several layers: the first layer's codes (written from the
    same residual rows) at most one step apart; every layer's values
    (codes x scales) within ``tol`` of the largest plus one code step at
    the value. Past the first layer the rows come from residual streams
    that differ by the sums' order: a value near a midpoint moves a step
    (up to 1/8 of an e4m3 value), and where a value is small against that
    difference an e4m3 code may move by more than a step."""
    from distributed_tensorflow_tpu_torch.ops.quantized import dequantize_kv

    if sa is None:
        return _close(a, b, tol)
    over = ((dequantize_kv(a, sa) - dequantize_kv(b, sb)).abs()
            - _step(a, sa).maximum(_step(b, sb))).max().item()
    bound = tol * max(1.0, dequantize_kv(b, sb).abs().max().item())
    assert over <= bound, f"values {over} beyond a code step apart"
    return _codes_close(a[0], b[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,rope", [("bf16", True), ("int8", True), ("fp8", True),
                                           ("int8", False), ("fp8", False)])
@pytest.mark.parametrize("hq,hkv,dh", [(4, 2, 64), (2, 1, 128)])
def test_kernel_variants_match_plain_on_gpu(kv_dtype, rope, hq, hkv, dh):
    """B5 (slab, paged), B6 (slab, paged) and B7 on RoPE and int8/fp8
    caches against their plain versions: h within the decode tolerance,
    B5's codes and the first layer's committed codes within one step, every
    layer's committed values within the tolerance, scales within 2e-2; B5
    layer by layer with the commits equal to B6 bit for bit; paged equal to
    slab bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(41)
    n, s, c, bs = 2, 3, 64, 8
    w, r, ck, cv, ks, vs = _gpu_case(g, n, s, c, hq, hkv, dh, kv_dtype)
    lengths = torch.tensor([5, 63, 20], device="cuda")
    act = torch.tensor([True, True, False], device="cuda")
    x = r(s, hq * dh)
    kw = dict(num_heads=hq, rope=rope, compute_dtype=torch.bfloat16)
    sc = lambda a, b: dict(k_scale=a, v_scale=b)  # noqa: E731
    clone = lambda *ts: [None if t is None else t.clone() for t in ts]  # noqa: E731

    tol = GPU_TOL[kv_dtype]
    w0 = {k: t[0] for k, t in w.items()}
    got = fd.decode_block_slab(x, w0, ck[0], cv[0], lengths, **kw, **sc(*_first(ks, vs)))
    ref = fd.decode_block_slab_plain(x, w0, ck[0], cv[0], lengths, **kw,
                                     **sc(*_first(ks, vs)))
    assert _close(got[0], ref[0], tol) and _codes_close(got[1], ref[1])
    assert _codes_close(got[2], ref[2])
    if ks is not None:
        assert _scales_close(got[3], ref[3]) and _scales_close(got[4], ref[4])

    k1, v1, ks1, vs1 = clone(ck, cv, ks, vs)
    o1 = fd.decode_token_slab(x, w, k1, v1, lengths, act, **kw, **sc(ks1, vs1))[0]
    k2, v2, ks2, vs2 = clone(ck, cv, ks, vs)
    o2 = fd.decode_token_slab_plain(x, w, k2, v2, lengths, act, **kw, **sc(ks2, vs2))[0]
    torch.cuda.synchronize()
    assert _close(o1, o2, tol) and _cache_close(k1, k2, ks1, ks2, tol)
    assert _cache_close(v1, v2, vs1, vs2, tol)
    if ks is not None:
        assert _scales_close(ks1, ks2) and _scales_close(vs1, vs2)

    # B5 layer by layer with the commits == B6, bit for bit.
    k3, v3, ks3, vs3 = clone(ck, cv, ks, vs)
    h = x
    for i in range(n):
        wi = {k: t[i] for k, t in w.items()}
        lk, lv = (None, None) if ks is None else (ks3[i], vs3[i])
        h, kq, vq, kqs, vqs = fd.decode_block_slab(h, wi, k3[i], v3[i], lengths, **kw,
                                                   **sc(lk, lv))
        fd.commit_slot_rows(k3[i], v3[i], kq, vq, lengths, act, lk, lv, kqs, vqs)
    torch.cuda.synchronize()
    assert torch.equal(h, o1)
    for a, b in zip((k3, v3, ks3, vs3), (k1, v1, ks1, vs1)):
        assert a is None or torch.equal(_u8(a), _u8(b))

    # Paged: B6 paged == B6 slab bitwise; B5 paged == B5 slab; B7 vs plain.
    mb = c // bs
    nb = s * mb + 3
    tables = torch.randperm(nb, device="cuda")[: s * mb].reshape(s, mb).int()
    pools = [None if t is None else _pool(t, tables, nb, bs) for t in (ck, cv, ks, vs)]
    p1 = clone(*pools)
    o3 = fd.decode_token_paged(x, w, p1[0], p1[1], tables, lengths, act, **kw,
                               **sc(p1[2], p1[3]))[0]
    torch.cuda.synchronize()
    assert torch.equal(o3, o1)
    got = fd.decode_block_paged(x, w0, pools[0][0], pools[1][0], tables, lengths, **kw,
                                **sc(*_first(pools[2], pools[3])))
    want = fd.decode_block_slab(x, w0, ck[0], cv[0], lengths, **kw, **sc(*_first(ks, vs)))
    assert torch.equal(got[0], want[0])
    plens = torch.tensor([13, 0, 41], device="cuda")
    slens = torch.tensor([5, 3, 1], device="cuda")
    hv = r(s, 5, hq * dh)
    p2, p3 = clone(*pools), clone(*pools)
    o4 = fd.verify_tokens_paged(hv, w, p2[0], p2[1], tables, plens, slens, act, **kw,
                                **sc(p2[2], p2[3]))
    o5 = fd.verify_tokens_paged_plain(hv, w, p3[0], p3[1], tables, plens, slens, act, **kw,
                                      **sc(p3[2], p3[3]))
    torch.cuda.synchronize()
    assert _close(o4, o5, tol) and _cache_close(p2[0], p3[0], p2[2], p3[2], tol)
    assert _cache_close(p2[1], p3[1], p2[3], p3[3], tol)
    if ks is not None:
        assert _scales_close(p2[2], p3[2]) and _scales_close(p2[3], p3[3])


def _first(a, b):
    return (None, None) if a is None else (a[0], b[0])


def _u8(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _pool(slab, tables, nb, bs):
    """A slab tensor [n, S, C, ...] copied into a pool [n, nb, bs, ...]
    through ``tables``; blocks outside them hold zeros."""
    from distributed_tensorflow_tpu_torch.ops.quantized import movable

    n, s, c = slab.shape[:3]
    src = movable(slab)
    pool = torch.zeros((n, nb, bs) + tuple(slab.shape[3:]), dtype=src.dtype,
                       device=slab.device)
    for i in range(s):
        pool[:, tables[i].long()] = src[:, i].reshape((n, c // bs, bs) + tuple(slab.shape[3:]))
    return pool.view(slab.dtype)
