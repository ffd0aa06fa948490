"""PyTorch port, the ring offset on the flash kernels: the plain flash
forward and backward with ``offset=F`` (query i at position i + F, as a
ring-flash hop's past block sees it) against the JAX Pallas kernels in
CPU interpret mode (``flash_attention_with_lse(..., offset=)``), with the
offset below the window, past it (rows that see no key: out 0, lse -1e30,
zero gradients), without a window, under GQA and ``kv_lens``; and on a GPU
each kernel's offset variant (B3, B4a, B4b, B4c) against its plain
version.

Tolerances: f32 throughout on the CPU, the sums in another order than
the interpreter's: out and lse within 1e-5, gradients within atol 2e-5,
rtol 1e-4 (test_torch_window.py's). On the card, test_torch_window.py's
GPU tolerances: 1e-5 of the plain version's scale in f32, 1e-2 (backward)
and 2^-7 (forward) in bf16.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import max_err

# (window, offset, L, query heads, KV heads, kv_lens): offsets below the
# window, at and past it (empty rows), without a window (a past block
# seen causally), under GQA and with kv_lens (one row's block empty).
CASES = (
    (12, 5, 32, 4, 4, None),
    (12, 32, 32, 4, 2, None),
    (24, 32, 32, 4, 4, None),  # JAX's "offset-empty-band": rows 23.. see no key
    (8, 40, 32, 2, 1, (0, 29)),
    (20, 16, 32, 4, 2, (13, 32)),
    (None, 8, 32, 4, 4, (5, 30)),
    (None, 40, 32, 4, 2, None),  # past the block: every key seen
)
IDS = [f"w{w}-off{f}-{hq}x{hkv}-{'lens' if n else 'full'}" for w, f, _, hq, hkv, n in CASES]


def _inputs(w, f, l, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, l, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, l, hkv, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((2, l, hq, d)).astype(np.float32)
    dlse = rng.standard_normal((2, l, hq)).astype(np.float32)
    return q, k, v, do, dlse


def _empty_rows(w, f, l, lens):
    """[2, L] bool: rows that see no key."""
    i = np.arange(l)[None, :]
    lo = np.full((2, 1), -1) if w is None else i + f - w  # keys > lo
    hi = np.minimum(i + f, np.asarray(lens if lens is not None else (l, l))[:, None] - 1)
    return np.broadcast_to(hi <= lo, (2, l))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_offset_forward_matches_jax(case):
    """out and lse of the port's flash with an offset (its plain forward on
    the CPU) against the JAX kernel's, every row; rows that see no key are
    0 and -1e30 in both; the dense path's masked softmax agrees on the
    live rows."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    w, f, l, hq, hkv, lens = case
    q, k, v, _, _ = _inputs(w, f, l, hq, hkv, 8, seed=l + f)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    jo, jlse = jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=w,
                      offset=f, kv_lens=jl, interpret=True)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    ta = [torch.from_numpy(a) for a in (q, k, v)]
    to, tlse = flash_attention_with_lse(*ta, causal=True, window=w, offset=f, kv_lens=tl)
    assert max_err(jo, to.numpy()) < 1e-5
    empty = _empty_rows(w, f, l, lens)
    live = ~empty
    if live.any():
        assert max_err(np.asarray(jlse)[live], tlse.numpy()[live]) < 1e-5
        td = dense_attention(*ta, causal=True, window=w, offset=f, kv_lens=tl)
        assert max_err(td.numpy()[live], to.numpy()[live]) < 1e-5
    if empty.any():
        assert float(to.abs().numpy()[empty].max()) == 0.0
        assert float(tlse.numpy()[empty].max()) <= -1e29
        assert float(np.asarray(jlse)[empty].max()) <= -1e29


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_offset_backward_matches_jax_vjp(case, fused):
    """dq, dk, dv through the port's flash with an offset (the plain
    backward on the CPU) against the JAX VJP through its fused or split
    Pallas kernels, with an lse cotangent; rows that see no key take
    exactly zero dq."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    w, f, l, hq, hkv, lens = case
    q, k, v, do, dlse = _inputs(w, f, l, hq, hkv, 8, seed=2 * l + f)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def fn(q, k, v):
        return jflash(q, k, v, causal=True, window=w, offset=f, kv_lens=jl, interpret=True,
                      fused=fused)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    jg = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = flash_attention_with_lse(
        *args, causal=True, window=w, offset=f, fused=fused,
        kv_lens=None if lens is None else torch.tensor(lens, dtype=torch.int32))
    obj = (out * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dlse)).sum()
    tg = torch.autograd.grad(obj, args)
    for j, t, name in zip(jg, tg, "qkv"):
        np.testing.assert_allclose(t.numpy(), j, atol=2e-5, rtol=1e-4, err_msg=f"d{name}")
    empty = _empty_rows(w, f, l, lens)
    if empty.any():
        assert float(tg[0].abs().numpy()[empty].max()) == 0.0


def test_offset_zero_is_the_causal_kernel():
    """offset=0 is the causal (windowed) flash bit for bit, and the plain
    backward's mask at offset F equals the forward's."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_attention_with_lse,
    )

    q, k, v, _, _ = _inputs(8, 0, 32, 4, 2, 16, seed=7)
    ta = [torch.from_numpy(a) for a in (q, k, v)]
    for w in (None, 8):
        a = flash_attention_with_lse(*ta, causal=True, window=w, offset=0)
        b = flash_attention_with_lse(*ta, causal=True, window=w)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # Past the block without a window: every key is seen, as non-causal.
    a = flash_attention_plain(*ta, causal=True, offset=32)
    b = flash_attention_plain(*ta, causal=False)
    assert max_err(a[0].numpy(), b[0].numpy()) < 1e-6


def test_offset_refusals_match_jax():
    """An offset needs causal=True and must be >= 0, in JAX's words."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import (
        flash_attention_with_lse as jflash,
    )
    from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    q, jq = torch.zeros(1, 8, 2, 8), jnp.zeros((1, 8, 2, 8))
    for kw, msg in (({"causal": False, "offset": 4}, "offset requires causal=True"),
                    ({"causal": True, "offset": -1}, "offset must be >= 0")):
        with pytest.raises(ValueError, match=msg):
            jflash(jq, jq, jq, interpret=True, **kw)
        for fn in (flash_attention_with_lse, dense_attention):
            with pytest.raises(ValueError, match=msg):
                fn(q, q, q, **kw)


# (dtype, head dim, L, query heads, KV heads, window, offset, kv_lens): the
# two-rank hop (L_loc 1024, W 512, offset 1024: rows 511.. see no key), its
# GQA-2 form, the four-rank hop (L_loc 512, offset 512: every row but the
# last sees keys), and ragged shapes off the tiles.
GPU_CASES = (
    ("bfloat16", 32, 1024, 8, 8, 512, 1024, False),
    ("float32", 32, 1024, 8, 8, 512, 1024, False),
    ("bfloat16", 32, 1024, 8, 2, 512, 1024, False),
    ("bfloat16", 32, 512, 8, 8, 512, 512, False),
    ("float32", 64, 200, 4, 2, 100, 37, True),
    ("float32", 16, 130, 2, 1, 60, 61, True),
    ("bfloat16", 128, 300, 4, 1, 77, 300, True),
    ("float32", 32, 256, 4, 4, None, 300, False),
    ("float32", 8, 1000, 2, 2, 513, 1000, True),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,l,hq,hkv,w,f,ragged", GPU_CASES)
def test_offset_kernels_match_plain_on_gpu(dtype, d, l, hq, hkv, w, f, ragged):
    """B3 with an offset against the plain forward (out and lse; rows that
    see no key exactly 0 and -1e30), then B4a, B4b and B4c against the
    plain backward (rows that see no key exactly zero dq)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(l + f)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(2, l, hq, d, device="cuda", generator=g).to(dt) for _ in range(2))
    k, v = (torch.randn(2, l, hkv, d, device="cuda", generator=g).to(dt) for _ in range(2))
    lens = None
    if ragged:
        lens = torch.tensor([0, l - 3], dtype=torch.int32, device="cuda")
    kw = dict(causal=True, window=w, kv_lens=lens, offset=f)
    _build.reset_launches()
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    plain = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, lens, True, w, offset=f)
    fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    split = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == 1 and _build.LAUNCHES[f"{name}[offset]"] == 1, name
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * scale
    assert (out.float() - ref.float()).abs().max().item() <= tol
    empty = ref_lse <= -1e29  # [B, L, H]: (row, head) pairs that see no key
    live = ~empty
    assert (lse[live] - ref_lse[live]).abs().max().item() < 1e-4 * max(
        1.0, ref_lse[live].abs().max().item())
    if empty.any():
        assert torch.equal(lse <= -1e29, empty) and out[empty].abs().max().item() == 0
    rel = 1e-5 if dtype == "float32" else 1e-2
    for got in (fused, split):
        for a, r, name in zip(got, plain, ("dq", "dk", "dv")):
            bound = rel * max(1.0, r.float().abs().max().item())
            assert (a.float() - r.float()).abs().max().item() <= bound, name
        if empty.any():
            assert got[0][empty].abs().max().item() == 0
