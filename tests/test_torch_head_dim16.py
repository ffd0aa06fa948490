"""PyTorch port: head_dim 16, the head dim of the transformer classifier at
the registry's default widths (``model_dim=64``, 4 heads, 28 rows), whose
flash path (``attention_impl="flash"``) runs B3 and B4 there. The plain
flash forward and backward at D=16 against the JAX Pallas kernels in CPU
interpret mode, at L=28 (shorter than one tile of every kernel) and at a
longer L; the flash classifier against JAX's; on a GPU each D=16 kernel
(B3, B4a, B4b, B4c) against its plain version.

Tolerances: the plain attention within 1e-5 of the Pallas kernels (f32,
sums in another order), gradients within atol 2e-5, rtol 1e-4
(test_torch_head_dim32.py's); the classifier's probabilities within 1e-5
(f32) and 1e-3 (bf16, as test_torch_classifiers.py), its gradients within
1e-5 of each leaf's largest magnitude in f32. On the card the kernels hold
test_torch_flash_bwd.py's tolerances: 1e-5 in f32, and in bf16 2^-7 of the
largest output and 1e-2 of the largest gradient.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import (
    classifier_models,
    classifier_numpy_params,
    jax_classifier_params,
    max_err,
    torch_classifier_params,
)

D = 16


def _qkv(b, l, hq, hkv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, l, hkv, D)).astype(np.float32) for _ in range(2))
    return q, k, v, rng


# (causal, window, L, query heads, KV heads, kv_lens): the classifier's
# non-causal L=28, and longer rows with a mask, GQA and ragged lengths.
FLASH_CASES = (
    (False, None, 28, 4, 4, None),
    (True, None, 28, 4, 2, (5, 28)),
    (False, None, 96, 2, 1, (40, 96)),
    (True, 16, 96, 2, 2, None),
)


@pytest.mark.parametrize("causal,w,l,hq,hkv,lens", FLASH_CASES)
def test_flash_forward_at_head_dim_16_matches_jax(causal, w, l, hq, hkv, lens):
    """out and lse of the port's flash forward (its plain version on the
    CPU) against the JAX Pallas kernel in interpret mode, at D=16."""
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
    assert max_err(jo, to.numpy()) < 1e-5
    assert max_err(jlse, tlse.numpy()) < 1e-5


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2]], ids=["L28", "L96"])
def test_flash_backward_at_head_dim_16_matches_jax_vjp(case, fused):
    """dq, dk, dv through ``FlashAttention`` (the plain backward on the
    CPU) against the JAX VJP through its fused or split Pallas kernels, at
    D=16, with an lse cotangent."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    causal, w, l, hq, hkv, lens = case
    q, k, v, rng = _qkv(2, l, hq, hkv, seed=3 * l + hkv)
    do = rng.standard_normal((2, l, hq, D)).astype(np.float32)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_transformer_classifier_matches_jax(dtype):
    """The registry's default ``TransformerClassifier`` (4 heads of 16 over
    28 rows) with ``attention_impl="flash", flash_min_len=0`` against
    JAX's (test_pallas_attention.py:263 holds JAX's against its dense
    path): probabilities, and in f32 the gradients of the naive
    cross-entropy."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import cross_entropy as jce
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy

    jm, tm = classifier_models("transformer", dtype, model_dim=64, num_heads=4,
                               attention_impl="flash", flash_min_len=0)
    assert tm.head_dim == D
    tree = classifier_numpy_params(jm, seed=13)
    jp, tp = jax_classifier_params(jm, tree), torch_classifier_params(tm, tree)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((4, 28 * 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    assert max_err(want, tm.apply(tp, torch.from_numpy(x)).numpy()) < (
        1e-5 if dtype == "float32" else 1e-3)
    if dtype != "float32":
        return
    jg = jax.grad(lambda p: jce(jm.apply(p, jnp.asarray(x)), jnp.asarray(y)))(jp)
    leaves = [t.clone().requires_grad_(True) for t in tp]
    cost = cross_entropy(tm.apply(type(tp)(*leaves), torch.from_numpy(x)), torch.from_numpy(y))
    for name, g in zip(tp._fields, torch.autograd.grad(cost, leaves)):
        ref = np.asarray(getattr(jg, name))
        assert max_err(ref, g.numpy()) <= 1e-5 * np.abs(ref).max(), name


def test_flash_classifier_takes_the_kernels_only_past_flash_min_len(monkeypatch):
    """``flash_min_len`` goes through ``models/base.resolve_flash_min_len``
    (None → 1024): at 28 rows the default takes dense attention, 0 takes
    the flash path; GPT reads the same resolver."""
    from distributed_tensorflow_tpu_torch.models import base, build_model
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    assert base.resolve_flash_min_len(None) == fa.FLASH_MIN_LEN == 1024
    assert base.resolve_flash_min_len(0) == 0
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.rand(2, 784)
    for min_len, n in ((None, 0), (29, 0), (28, 1), (0, 2)):
        m = build_model("transformer", attention_impl="flash", flash_min_len=min_len)
        m.apply(m.init(1, device="cpu"), x)
        assert len(calls) == n, min_len


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


# (dtype, B, L, query heads, KV heads, causal, kv_lens) at D=16: the
# classifier's shape (B=100, L=28, 4 heads, non-causal) in f32 and bf16,
# and longer rows past one tile of every kernel.
GPU_FLASH_CASES = (
    ("float32", 100, 28, 4, 4, False, None),
    ("bfloat16", 100, 28, 4, 4, False, None),
    ("float32", 2, 300, 4, 2, True, "ragged"),
    ("bfloat16", 3, 129, 2, 1, False, "ragged"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,l,hq,hkv,causal,lens_mode", GPU_FLASH_CASES)
def test_flash_head_dim_16_kernels_match_plain_on_gpu(dtype, b, l, hq, hkv, causal, lens_mode):
    """B3 at D=16 against the plain forward (out and lse), then B4a (fused)
    and B4b + B4c (the pair) against the plain backward."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(l + hq)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(b, l, hq, D, device=dev, generator=g).to(dt) for _ in range(2))
    k, v = (torch.randn(b, l, hkv, D, device=dev, generator=g).to(dt) for _ in range(2))
    lens = (torch.randint(1, l + 1, (b,), device=dev, generator=g, dtype=torch.int32)
            if lens_mode else None)
    kw = dict(causal=causal, kv_lens=lens)
    _build.reset_launches()
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * scale
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() < 1e-4 * max(1.0, ref_lse.abs().max().item())
    delta = (do.float() * out.float()).sum(-1)
    plain = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, lens, causal)
    fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    split = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[n] == 1 for n in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                                                 "flash_bwd_dkv"))
    rel = 1e-5 if dtype == "float32" else 1e-2
    for got in (fused, split):
        for a, r, name in zip(got, plain, ("dq", "dk", "dv")):
            bound = rel * max(1.0, r.float().abs().max().item())
            assert (a.float() - r.float()).abs().max().item() <= bound, name
