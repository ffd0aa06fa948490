"""PyTorch port: dense attention and the flash forward against the JAX
package (``dense_attention`` and the Pallas ``flash_attention`` in its CPU
interpret mode), and the flash kernel against its plain version on a GPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import max_err

# (causal, ragged kv_lens, query heads, KV heads, length)
CASES = (
    (True, False, 4, 4, 32),
    (True, True, 4, 4, 32),
    (False, True, 4, 2, 32),
    (True, True, 4, 1, 24),
)


def _inputs(b, l, hq, hkv, d, ragged, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    lens = rng.integers(1, l + 1, b).astype(np.int32) if ragged else None
    return q, k, v, lens


@pytest.mark.parametrize("causal,ragged,hq,hkv,l", CASES)
def test_flash_plain_matches_jax_flash_and_dense(causal, ragged, hq, hkv, l):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu.ops.ring_attention import (
        dense_attention as jdense,
    )
    from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse,
    )

    q, k, v, lens = _inputs(2, l, hq, hkv, 16, ragged, seed=l + hkv)
    jl = None if lens is None else jnp.asarray(lens)
    jo, jlse = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, kv_lens=jl, interpret=True)
    jd = jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, kv_lens=jl)
    tl = None if lens is None else torch.from_numpy(lens)
    to, tlse = flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_lens=tl,
    )
    td = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal, kv_lens=tl)
    # f32 throughout; the sums run in another order (1e-5 of O(1) values).
    assert max_err(jo, to.numpy()) < 1e-5
    assert max_err(jlse, tlse.numpy()) < 1e-5
    assert max_err(jd, td.numpy()) < 1e-5
    assert max_err(to.numpy(), td.numpy()) < 1e-5


def test_flash_plain_handles_the_last_default_bucket():
    """L=1023 (the largest default bucket at max_len 1024): the JAX block
    picker refuses it; the port's flash version takes any length and
    agrees with dense attention."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import flash_attention as jflash
    from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, lens = _inputs(1, 1023, 2, 1, 8, True, seed=7)
    with pytest.raises(ValueError, match="no power-of-two block divisor"):
        jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    out = flash_attention(*args, causal=True, kv_lens=torch.from_numpy(lens))
    ref = dense_attention(*args, causal=True, kv_lens=torch.from_numpy(lens))
    assert max_err(out.numpy(), ref.numpy()) < 1e-5


def test_group_query_heads_matches_reference():
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.ring_attention import group_query_heads as jg
    from distributed_tensorflow_tpu_torch.ops.attention import group_query_heads

    x = np.arange(2 * 8 * 4, dtype=np.float32).reshape(2, 8, 4)
    np.testing.assert_array_equal(
        np.asarray(jg(jnp.asarray(x), 2)), group_query_heads(torch.from_numpy(x), 2).numpy()
    )
    with pytest.raises(ValueError):
        group_query_heads(torch.from_numpy(x), 3)


def test_flash_refuses_window_and_bad_shapes():
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 8, 4, 16)
    # The window is ported; the JAX package's refusals of it remain.
    with pytest.raises(ValueError, match="window must be >= 1"):
        flash_attention(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="window requires causal=True"):
        flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="incompatible"):
        flash_attention(q, q[:, :, :3], q[:, :, :3], causal=True)


# (dtype, causal, D, L, query heads, KV heads, kv_lens): the kernel's tiles
# are 128 queries by 64 keys, so L=1, 63, 65 and 1024 sit at its edges;
# "short" kv_lens (1, 17, 63) end inside the first key tile.
GPU_CASES = (
    ("float32", True, 64, 77, 4, 2, "ragged"),
    ("bfloat16", True, 64, 77, 4, 2, "ragged"),
    ("float32", False, 128, 77, 4, 2, "ragged"),
    ("bfloat16", True, 128, 77, 4, 2, "ragged"),
    ("float32", True, 64, 1, 4, 4, None),
    ("bfloat16", True, 64, 63, 4, 4, None),
    ("float32", False, 64, 65, 4, 1, "ragged"),
    ("float32", True, 64, 1024, 4, 4, None),
    ("bfloat16", True, 64, 1024, 8, 2, "ragged"),
    ("float32", True, 64, 200, 4, 2, "short"),
    ("bfloat16", False, 64, 130, 4, 4, "short"),
    ("float32", True, 128, 130, 8, 2, "ragged"),
    ("bfloat16", True, 128, 65, 8, 2, None),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,d,l,hq,hkv,lens_mode", GPU_CASES)
def test_flash_kernel_matches_plain_on_gpu(dtype, causal, d, l, hq, hkv, lens_mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_attention_with_lse,
    )

    q, k, v, lens = _inputs(3, l, hq, hkv, d, lens_mode == "ragged", seed=1)
    if lens_mode == "short":
        lens = np.array([1, 17, 63], np.int32)
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).cuda().to(dt) for a in (q, k, v)]
    lens = None if lens is None else torch.from_numpy(lens).cuda()
    out, lse = flash_attention_with_lse(*args, causal=causal, kv_lens=lens)
    ref, ref_lse = flash_attention_plain(*args, causal=causal, kv_lens=lens)
    # f32: split-TF32 products, sums in another order. bf16: p rounds to
    # bf16 before P V (2^-9 relative of each weight) and both outputs round
    # the f32 result, at most one ulp (2^-8 relative) apart.
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * scale
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() < 1e-4
