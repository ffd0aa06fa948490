"""PyTorch port: head_dim 8 on the flash kernels, and the head dims between
the built ones (any multiple of 8 up to 128), which run zero-padded on the
next built kernel with the scale of their own D.

The plain flash forward and backward at D=8 and at D=24, 48 and 80 against
the JAX Pallas kernels in CPU interpret mode (causal, the window, GQA,
kv_lens; the JAX kernels take any D and ``scale`` = 1/√D); the padded route
(q, k, v and dO zero-padded along D, the true D's scale, the outputs sliced
back) against the unpadded plain result; a GPT at head dims 8 and 24 with
flash attention against JAX's; the refusals. On a GPU B3, B4a, B4b and B4c
at D=8 and at padded dims against their plain versions.

Tolerances: the plain attention within 1e-5 of the Pallas kernels (f32,
sums in another order), gradients within atol 2e-5, rtol 1e-4
(test_torch_head_dim16.py's); the padded route within 1e-6 of the unpadded
plain result (the scale is a product instead of a quotient, and the zero
columns add exact zeros); the GPT's loss within 1e-5 and its gradients
within 1e-4 of each leaf's largest (test_torch_head_dim32.py's). On the card
test_torch_flash_bwd.py's tolerances: 1e-5 in f32, and in bf16 2^-7 of the
largest output and 1e-2 of the largest gradient.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params


def _qkv(b, l, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, l, hkv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, rng


# (D, causal, window, L, query heads, KV heads, kv_lens): D=8 (the built
# kernels' narrowest) and D=24, 48, 80 (padded to 32, 64, 128 on the card),
# with the causal mask, the window banded and not, GQA and ragged lengths.
FLASH_CASES = (
    (8, True, None, 64, 4, 4, None),
    (8, False, None, 28, 4, 2, (5, 28)),
    (8, True, 16, 96, 2, 1, (40, 96)),
    (24, True, None, 48, 2, 2, (17, 48)),
    (48, True, 8, 64, 4, 2, None),
    (80, False, None, 40, 2, 1, (1, 40)),
)


@pytest.mark.parametrize("d,causal,w,l,hq,hkv,lens", FLASH_CASES)
def test_flash_forward_matches_jax(d, causal, w, l, hq, hkv, lens):
    """out and lse of the port's flash forward (its plain version on the
    CPU) against the JAX Pallas kernel in interpret mode."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    q, k, v, _ = _qkv(2, l, hq, hkv, d, seed=l + hq + d + (w or 0))
    lens = None if lens is None else np.asarray(lens, np.int32)
    jo, jlse = jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=w,
                      kv_lens=None if lens is None else jnp.asarray(lens), interpret=True)
    to, tlse = flash_attention_with_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                        causal=causal, window=w,
                                        kv_lens=None if lens is None else torch.from_numpy(lens))
    assert max_err(jo, to.numpy()) < 1e-5
    assert max_err(jlse, tlse.numpy()) < 1e-5


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", FLASH_CASES[::2], ids=["d8", "d8-window", "d48-window"])
def test_flash_backward_matches_jax_vjp(case, fused):
    """dq, dk, dv through ``FlashAttention`` (the plain backward on the
    CPU) against the JAX VJP through its fused or split Pallas kernels,
    with an lse cotangent."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    d, causal, w, l, hq, hkv, lens = case
    q, k, v, rng = _qkv(2, l, hq, hkv, d, seed=3 * l + hkv + d)
    do = rng.standard_normal((2, l, hq, d)).astype(np.float32)
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


@pytest.mark.parametrize("d,want", [(8, 8), (16, 16), (24, 32), (40, 64), (48, 64), (56, 64),
                                    (72, 128), (80, 128), (120, 128), (128, 128)])
def test_kernel_head_dim(d, want):
    """Each multiple of 8 up to 128 runs on the next built head dim."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import HEAD_DIMS, kernel_head_dim

    assert kernel_head_dim(d) == want and want in HEAD_DIMS


@pytest.mark.parametrize("d", [4, 12, 20, 136, 256])
def test_head_dims_the_kernels_refuse(d):
    """A head dim that is not a multiple of 8, or past 128, is refused by
    the kernel wrappers with the reason, before any build."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 8, 2, d)
    lse = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 128"):
        fa.kernel_head_dim(d)
    for call in (lambda: fa.flash_bwd_fused(q, q, q, q, lse, lse),
                 lambda: fa.flash_bwd_dq(q, q, q, q, lse, lse),
                 lambda: fa.flash_bwd_dkv(q, q, q, q, lse, lse)):
        with pytest.raises(ValueError, match="multiple of 8 from 8 to 128"):
            call()


@pytest.mark.parametrize("d,causal,w,lens", [(24, True, None, (9, 40)), (48, True, 12, None),
                                             (80, False, None, (3, 40)), (40, True, None, None)])
def test_padded_route_gives_the_unpadded_result(d, causal, w, lens):
    """The route the kernels take at a head dim they are not built for:
    q, k, v and dO zero-padded along D to ``kernel_head_dim(d)``, the
    scale 1/√d, the outputs sliced back. Through the plain versions it
    gives the unpadded forward (out, lse) and backward (dq, dk, dv)."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, rng = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in _qkv(2, 40, 4, 2, d, seed=d))
    do = torch.from_numpy(rng.standard_normal((2, 40, 4, d)).astype(np.float32))
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    kw = dict(causal=causal, window=w, kv_lens=kv_lens)
    dp = fa.kernel_head_dim(d)
    assert dp > d
    pq, pk, pv, pdo = (fa.pad_head_dim(t, dp) for t in (q, k, v, do))
    assert pq.shape[-1] == dp and torch.equal(pq[..., :d], q) and not pq[..., d:].any()
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_attention_plain(q, k, v, **kw)
    pout, plse = fa.flash_attention_plain(pq, pk, pv, **kw, scale=scale)
    assert not pout[..., d:].any()
    assert max_err(out.numpy(), pout[..., :d].numpy()) < 1e-6
    assert max_err(lse.numpy(), plse.numpy()) < 1e-6 * max(1.0, float(lse.abs().max()))
    delta = (do * out).sum(-1)
    want = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, kv_lens, causal, w)
    got = fa.flash_bwd_plain(pq, pk, pv, pout, plse, pdo, delta, kv_lens, causal, w,
                             scale=scale)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert not a[..., d:].any(), name
        assert max_err(a[..., :d].numpy(), b.numpy()) < 1e-6 * max(1.0, float(b.abs().max())), name


@pytest.mark.parametrize("model_dim,num_heads", [(32, 4), (48, 2)], ids=["dh8", "dh24"])
def test_gpt_with_flash_at_head_dims_8_and_24_matches_jax(model_dim, num_heads):
    """A GPT whose flash attention runs at head dim 8 (the JAX engine's
    test model: d=32, 4 heads) and 24 (padded to 32 on the card): the
    loss and the gradients against the JAX model's, whose flash runs
    through the Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad

    kw = dict(model_dim=model_dim, num_heads=num_heads, attention_impl="flash", flash_min_len=0)
    jm, tm = jax_model(**kw), torch_model(**kw)
    assert tm.head_dim == model_dim // num_heads
    tree = numpy_params(jm, seed=8)
    jp, tp = jax_params(tree), torch_params(tree)
    toks = np.random.default_rng(9).integers(0, 97, (3, 24)).astype(np.int32)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks))
    tloss, tg = lm_value_and_grad(tm, tp, torch.from_numpy(toks))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    for a, b in ((jg.blocks.wq, tg.blocks.wq), (jg.blocks.wk, tg.blocks.wk),
                 (jg.blocks.wv, tg.blocks.wv), (jg.embed, tg.embed)):
        assert max_err(a, b.numpy()) <= 1e-4 * max(float(np.abs(np.asarray(a)).max()), 1e-6)


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


# (dtype, D, B, L, query heads, KV heads, causal, window, kv_lens): D=8 at
# the JAX engine's test widths and past one tile of every kernel; padded
# dims (24, 48, 80, 120) on the 32, 64 and 128 kernels.
GPU_FLASH_CASES = (
    ("float32", 8, 2, 300, 4, 4, True, None, "ragged"),
    ("bfloat16", 8, 3, 129, 4, 2, False, None, None),
    ("float32", 8, 2, 512, 4, 1, True, 64, None),
    ("float32", 24, 2, 200, 4, 2, True, None, "ragged"),
    ("bfloat16", 48, 2, 257, 4, 4, True, 100, None),
    ("float32", 48, 2, 130, 2, 1, False, None, "ragged"),
    ("float32", 80, 1, 190, 2, 2, True, None, None),
    ("bfloat16", 120, 1, 65, 2, 1, True, None, "ragged"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,b,l,hq,hkv,causal,w,lens_mode", GPU_FLASH_CASES)
def test_flash_kernels_match_plain_on_gpu(dtype, d, b, l, hq, hkv, causal, w, lens_mode):
    """B3 against the plain forward (out and lse), then B4a (fused) and
    B4b + B4c (the pair) against the plain backward, at D=8 and at padded
    dims; each kernel launched once a call."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(l + hq + d)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(b, l, hq, d, device=dev, generator=g).to(dt) for _ in range(2))
    k, v = (torch.randn(b, l, hkv, d, device=dev, generator=g).to(dt) for _ in range(2))
    lens = (torch.randint(1, l + 1, (b,), device=dev, generator=g, dtype=torch.int32)
            if lens_mode else None)
    kw = dict(causal=causal, window=w, kv_lens=lens)
    _build.reset_launches()
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * scale
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() < 1e-4 * max(1.0, ref_lse.abs().max().item())
    delta = (do.float() * out.float()).sum(-1)
    plain = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, lens, causal, w)
    fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    split = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[n] == 1 for n in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                                                 "flash_bwd_dkv"))
    rel = 1e-5 if dtype == "float32" else 1e-2
    for got in (fused, split):
        for a, r, name in zip(got, plain, ("dq", "dk", "dv")):
            assert a.shape == r.shape, name
            bound = rel * max(1.0, r.float().abs().max().item())
            assert (a.float() - r.float()).abs().max().item() <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 48])
def test_flash_op_gradients_match_plain_on_gpu(d):
    """``flash_attention_with_lse`` with gradients (the operator's kernel
    forward and backward) at D=8 and at a padded D, against autograd
    through the plain forward."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(2, 150, 4, d, device="cuda", generator=g) for _ in range(4))
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*args, causal=True)
    got = torch.autograd.grad((out * do).sum(), args)
    ref_args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.flash_attention_plain(*ref_args, causal=True)[0]
    want = torch.autograd.grad((ref * do).sum(), ref_args)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
