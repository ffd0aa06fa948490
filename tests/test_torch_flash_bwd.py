"""PyTorch port: the flash-attention backward against the JAX package's
``flash_attention_with_lse`` VJP (its Pallas kernels in CPU interpret mode,
fused and split), the plain backward's formula, the backward choice and
the no-grad path; on a GPU each backward kernel against the plain
version, and the gradient that reaches wq/wk/wv through the kernels."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import max_err

# (name, causal, kv_lens, query heads, KV heads, L, D, JAX blocks, lse cotangent)
# mirroring tests/test_pallas_attention.py's feature matrix (no window or
# offset: those wait for ROADMAP A3/A7).
CASES = (
    ("causal", True, None, 4, 4, 32, 16, None, True),
    ("noncausal", False, None, 4, 4, 32, 16, None, True),
    ("mixed-blocks", True, None, 2, 2, 64, 16, (16, 32), False),
    ("gqa", True, None, 4, 2, 32, 8, (8, 16), True),
    ("kv-lens", True, (13, 29), 4, 4, 32, 8, None, True),
    ("kv-lens-gqa", True, (13, 29), 4, 2, 32, 8, (8, 16), False),
    ("kv-lens-noncausal", False, (5, 32), 4, 1, 32, 8, None, True),
)
IDS = [c[0] for c in CASES]

# f32 throughout on both sides; the sums run in another order (a few f32
# ulps of O(1) gradients).
ATOL, RTOL = 2e-5, 1e-4


def _inputs(case, seed=0):
    _, causal, lens, hq, hkv, l, d, _, with_dlse = case
    rng = np.random.default_rng(seed)
    b = 2
    q = rng.standard_normal((b, l, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, l, hq, d)).astype(np.float32)
    dlse = rng.standard_normal((b, l, hq)).astype(np.float32) if with_dlse else None
    lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, do, dlse, lens


def _jax_grads(case, q, k, v, do, dlse, lens, fused):
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import flash_attention_with_lse

    _, causal, _, _, _, _, _, blocks, _ = case
    bq, bk = blocks if blocks else (None, None)
    jl = None if lens is None else jnp.asarray(lens)

    def f(q, k, v):
        return flash_attention_with_lse(q, k, v, causal=causal, kv_lens=jl, block_q=bq,
                                        block_k=bk, interpret=True, fused=fused)

    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ct_lse = jnp.zeros_like(lse) if dlse is None else jnp.asarray(dlse)
    return [np.asarray(g) for g in vjp((jnp.asarray(do), ct_lse))]


def _torch_grads(case, q, k, v, do, dlse, lens, fused):
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    causal = case[1]
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tl = None if lens is None else torch.from_numpy(lens)
    out, lse = flash_attention_with_lse(*args, causal=causal, kv_lens=tl, fused=fused)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    obj = (out * torch.from_numpy(do)).sum()
    if dlse is not None:
        obj = obj + (lse * torch.from_numpy(dlse)).sum()
    return [g.numpy() for g in torch.autograd.grad(obj, args)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_backward_matches_jax_vjp(case, fused):
    """The autograd Function's backward (the plain backward on the CPU)
    against the JAX VJP through its fused or split Pallas kernels."""
    ins = _inputs(case, seed=len(case[0]))
    jg = _jax_grads(case, *ins, fused=fused)
    tg = _torch_grads(case, *ins, fused=fused)
    for j, t, name in zip(jg, tg, "qkv"):
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL, err_msg=f"d{name} ({case[0]})")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    """``flash_bwd_plain`` called directly on the forward's residuals and
    ``delta = rowsum(do·o) − dlse`` equals the JAX VJP."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_bwd_plain,
    )

    q, k, v, do, dlse, lens = _inputs(case, seed=7)
    jg = _jax_grads(case, q, k, v, do, dlse, lens, fused=None)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tl = None if lens is None else torch.from_numpy(lens)
    o, lse = flash_attention_plain(tq, tk, tv, causal=case[1], kv_lens=tl)
    delta = (tdo * o).sum(-1) - (0 if dlse is None else torch.from_numpy(dlse))
    tg = flash_bwd_plain(tq, tk, tv, o, lse, tdo, delta, tl, case[1])
    assert [t.shape for t in tg] == [a.shape for a in (q, k, v)]
    for j, t, name in zip(jg, tg, "qkv"):
        np.testing.assert_allclose(t.numpy(), j, atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal,ragged,hkv", [(True, False, 4), (True, True, 2), (False, True, 1)])
def test_function_gradients_match_dense_attention(causal, ragged, hkv):
    """The Function's gradients equal autograd through the port's dense
    attention (same math, other order), GQA and kv_lens included."""
    from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((3, 20, 4, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 20, hkv, 8)).astype(np.float32))
            for _ in range(2))
    lens = torch.tensor([3, 20, 11]) if ragged else None
    ct = torch.from_numpy(rng.standard_normal((3, 20, 4, 8)).astype(np.float32))
    grads = []
    for fn in (flash_attention, dense_attention):
        args = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*args, causal=causal, kv_lens=lens)
        grads.append(torch.autograd.grad((out * ct).sum(), args))
    for a, b, name in zip(*grads, "qkv"):
        assert max_err(a, b) < 2e-5, f"d{name}"


def test_kv_lens_pad_gradients_stay_zero():
    """Padded keys and values get exactly zero gradient (p masked
    explicitly), as tests/test_pallas_attention.py pins for the TPU."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(46)
    args = [torch.from_numpy(rng.standard_normal((2, 32, 4, 8)).astype(np.float32))
            .requires_grad_(True) for _ in range(3)]
    lens = torch.tensor([13, 29])
    out = flash_attention(*args, causal=True, kv_lens=lens, fused=True)
    ct = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    _, dk, dv = torch.autograd.grad((out * ct).sum(), args)
    for g in (dk, dv):
        for b, n in enumerate(lens.tolist()):
            assert torch.all(g[b, n:] == 0)


def test_resolve_fused_decisions():
    """The copy of the JAX ``_resolve_fused``: fused under the 1 GiB cap on
    the port's own partial buffer (ceil(L/64) f32 copies of dq), the split
    pair past it, an explicit bool always wins; the gpt-m training shape
    (B·H = 128, L = 1024, D = 64: 512 MiB of partials) fuses."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        BLOCK_K,
        FUSED_DQ_CAP_BYTES,
        resolve_fused,
    )

    assert FUSED_DQ_CAP_BYTES == 1 << 30 and BLOCK_K == 64
    assert resolve_fused(None, bh=128, l=1024, d=64) is True
    assert resolve_fused(None, bh=4, l=64, d=16) is True
    bh, l, d = 256, 16384, 128
    assert -(-l // BLOCK_K) * bh * l * d * 4 > FUSED_DQ_CAP_BYTES
    assert resolve_fused(None, bh=bh, l=l, d=d) is False
    assert resolve_fused(True, bh=bh, l=l, d=d) is True
    assert resolve_fused(False, bh=4, l=64, d=16) is False
    # A ragged L counts its partial last tile: 1025 keys take 17 tiles.
    assert resolve_fused(None, bh=64, l=1025, d=128) is (17 * 64 * 1025 * 128 * 4 <= 1 << 30)


def test_no_residuals_without_grad():
    """Serving (no_grad, or inputs without requires_grad) runs the forward
    alone: the same outputs, no graph, no saved residuals."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_attention_with_lse,
    )

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    ref = flash_attention_plain(q, k, v, causal=True)
    out = flash_attention_with_lse(q, k, v, causal=True)
    assert all(t.grad_fn is None for t in out)
    with torch.no_grad():
        ng = flash_attention_with_lse(*(t.requires_grad_(True) for t in (q, k, v)), causal=True)
    assert all(t.grad_fn is None for t in ng)
    g = flash_attention_with_lse(q, k, v, causal=True)
    assert g[0].grad_fn is not None
    for a, b, c in zip(out, ng, ref):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert torch.equal(g[0].detach(), ref[0])


def test_backward_wrappers_refuse_bad_inputs():
    """The kernel wrappers check dtype and head dim before any build."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_bwd_fused

    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_bwd_fused(q, q, q, q, torch.zeros(1, 8, 2), torch.zeros(1, 8, 2))
    for d in (20, 136):
        q = torch.zeros(1, 8, 2, d)
        with pytest.raises(ValueError, match="multiple of 8 from 8 to 128"):
            flash_bwd_fused(q, q, q, q, torch.zeros(1, 8, 2), torch.zeros(1, 8, 2))


# -- on the card ---------------------------------------------------------------

# (dtype, D, causal, kv_lens, query heads, KV heads, L, lse cotangent).
# The kv kernels take 64-key tiles and 32-query tiles, so L=1, 63, 65 and
# 1024 sit at their edges; "short" kv_lens
# (1, 17, 63) end inside the first key tile.
GPU_CASES = (
    ("float32", 64, True, None, 8, 8, 256, False),
    ("float32", 64, True, "ragged", 8, 2, 77, True),
    ("float32", 128, False, "ragged", 4, 4, 130, True),
    ("bfloat16", 64, True, "ragged", 8, 2, 130, False),
    ("bfloat16", 128, True, None, 4, 1, 64, True),
    ("float32", 64, True, None, 4, 4, 1, True),
    ("bfloat16", 64, True, None, 4, 4, 1, False),
    ("float32", 64, True, "ragged", 4, 2, 63, True),
    ("bfloat16", 64, False, None, 4, 4, 65, True),
    ("float32", 64, True, None, 8, 8, 1024, False),
    ("float32", 64, True, "short", 4, 2, 200, True),
    ("bfloat16", 64, True, "short", 4, 4, 130, True),
    ("float32", 128, True, "ragged", 8, 2, 130, True),
    ("bfloat16", 128, True, "short", 8, 2, 100, False),
    ("float32", 128, True, None, 4, 2, 65, False),
)


def _gpu_bwd_inputs(dtype, d, causal, lens_mode, hq, hkv, l, with_dlse, seed):
    """Seeded q/k/v/dO on the card, the forward kernel's out and lse,
    delta and kv_lens."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    b = 3
    q, do = (torch.randn(b, l, hq, d, device=dev, generator=g).to(dt) for _ in range(2))
    k, v = (torch.randn(b, l, hkv, d, device=dev, generator=g).to(dt) for _ in range(2))
    lens = None
    if lens_mode == "ragged":
        lens = torch.randint(1, l + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    elif lens_mode == "short":
        lens = torch.tensor([1, 17, 63], device=dev, dtype=torch.int32)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, kv_lens=lens)
    delta = (do.float() * o.float()).sum(-1)
    if with_dlse:
        delta = delta - torch.randn(b, l, hq, device=dev, generator=g)
    return q, k, v, do, o, lse, delta, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,lens_mode,hq,hkv,l,with_dlse", GPU_CASES)
def test_bwd_kernels_match_plain_on_gpu(dtype, d, causal, lens_mode, hq, hkv, l, with_dlse):
    """B4a (fused), B4b (dq) and B4c (dk/dv) against the plain backward on
    the same inputs, and B4a against B4b + B4c."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, o, lse, delta, lens = _gpu_bwd_inputs(
        dtype, d, causal, lens_mode, hq, hkv, l, with_dlse, seed=d + l)
    kw = dict(causal=causal, kv_lens=lens)
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, lens, causal)
    fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    split = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    # f32: split-TF32 products, sums in another order. bf16: outputs round
    # to bf16 (2^-8 relative) and p / ds may round to the neighbouring bf16
    # value.
    rel = 1e-5 if dtype == "float32" else 1e-2
    for got in (fused, split):
        for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
            assert a.dtype == r.dtype and a.shape == r.shape
            tol = rel * max(1.0, r.float().abs().max().item())
            assert (a.float() - r.float()).abs().max().item() <= tol, name
    for a, s in zip(fused, split):
        tol = rel * max(1.0, s.float().abs().max().item())
        assert (a.float() - s.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lens_mode", [("float32", None), ("bfloat16", "ragged")])
def test_fused_bwd_is_deterministic_on_gpu(dtype, lens_mode):
    """Two runs of the fused backward on the same inputs are bitwise equal:
    dq is summed from per-k-tile partials in a fixed order, with no float
    atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, _, lse, delta, lens = _gpu_bwd_inputs(
        dtype, 64, True, lens_mode, 8, 8, 1024, True, seed=5)
    runs = [fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True, kv_lens=lens)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, name in zip(*runs, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_attention_gradient_reaches_wq_wk_wv_on_gpu(monkeypatch):
    """The fault this Function closes: the forward kernel writes its output
    through ctypes into a tensor with no ``grad_fn``, so a model that
    called it directly trained wq/wk/wv by nothing through attention. With
    the kernel called that way the attention path gives those weights no
    gradient; through ``FlashAttention`` they get nonzero gradients equal
    to dense attention's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_unflatten

    kw = dict(vocab_size=97, max_len=64, model_dim=128, num_heads=2, num_layers=2)
    flash = gpt.GPTLM(**kw, compute_dtype=torch.float32, attention_impl="flash",
                      flash_min_len=0)
    dense = gpt.GPTLM(**kw, compute_dtype=torch.float32)
    params = flash.init(seed=3, device="cuda")
    g = torch.Generator().manual_seed(4)
    params = params._replace(blocks=params.blocks._replace(
        wo=torch.randn(params.blocks.wo.shape, generator=g).cuda() * 0.1))
    toks = torch.randint(0, 97, (4, 48), generator=g).cuda()

    def grads_of(model):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss = model.loss(tree_unflatten(params, leaves), toks)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return tree_unflatten(params, list(gs)).blocks

    _build.reset_launches()
    got = grads_of(flash)
    assert _build.LAUNCHES["flash_bwd_fused"] == 2  # one per layer
    ref = grads_of(dense)
    for name in ("wq", "wk", "wv"):
        a, r = getattr(got, name), getattr(ref, name)
        assert a.abs().max().item() > 0, name
        assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), name

    # The fault, reproduced: the kernel's output used directly.
    monkeypatch.setattr(
        gpt, "flash_attention",
        lambda q, k, v, causal, window, kv_lens, fused: fa._flash_cuda(
            q, k, v, causal, kv_lens, window)[0],
    )
    broken = grads_of(flash)
    for name in ("wq", "wk", "wv"):
        t = getattr(broken, name)
        assert t is None or t.abs().max().item() == 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dq_kernel_d128_gqa_ragged_on_gpu(dtype):
    """B4b at head_dim 128 with GQA and kv_lens against the plain backward
    (f32 within 1e-5, bf16 within 1e-2 of max(1, |ref|)); two launches
    bitwise equal (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, o, lse, delta, lens = _gpu_bwd_inputs(
        dtype, 128, True, "ragged", 8, 2, 333, True, seed=31)
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, lens, True)[0]
    runs = [fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, kv_lens=lens)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    rel = 1e-5 if dtype == "float32" else 1e-2
    assert runs[0].dtype == ref.dtype
    err = (runs[0].float() - ref.float()).abs().max().item()
    assert err <= rel * max(1.0, ref.float().abs().max().item()), err
