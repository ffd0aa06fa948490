"""PyTorch port: the cooperative decode kernels (B5, B6, B7) over any slot
count, draft length and cache extent. The slot-group planner and the
score tiles at an H100's figures (132 SMs, 232,448 bytes of shared memory
a block), the grouped run of the plain versions against the whole run bit
for bit (the slicing of slab, tables, lengths and active that the kernels'
launches share), and the model's refusal reasons, on the CPU; on a GPU the
grouped launches against the plain versions and the ungrouped launch, a
cache streamed in several score tiles against the plain versions, and a
server refused at construction."""

from __future__ import annotations

import pytest
import torch

import _torch_parity  # noqa: F401  (sets torch's thread count for xdist workers)
from test_torch_decode import H100_SMEM, _check_plan, _plan

GPT_M = dict(d=512, hq=8, hkv=8, dh=64, f=2048)


def _fd():
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    return fd


# (slots, rows a slot, query heads, KV heads, cache extent, blocks a slot,
# the group): gpt-m B6 at 100 slots, B7 at spec_draft=4 over 16 slots of
# gpt-m GQA-2 at max_len 2048, and B7 at spec_draft=8 and 15.
GROUP_CASES = (
    (100, 1, 8, 8, 1024, 0, 64),
    (16, 5, 8, 2, 2048, 128, 12),
    (8, 9, 8, 8, 1024, 64, 7),
    (8, 16, 8, 8, 1024, 64, 4),
)


@pytest.mark.parametrize("s,r,hq,hkv,c,mb,want", GROUP_CASES)
def test_slot_group_at_the_h100(s, r, hq, hkv, c, mb, want):
    """The planner's group is the most slots of r rows within 64 rows a
    launch; every group's plan, the last one's too, is one the kernel takes,
    with the first group's k-groups."""
    fd = _fd()
    dims = dict(GPT_M, hq=hq, hkv=hkv)
    got = fd.slot_group(s, r, *dims.values(), c, mb, 132, H100_SMEM)
    assert got == want
    for g in {got, s % got or got}:
        plan = fd.coop_plan(g, r, 8, *dims.values(), c, mb, 132, 1, H100_SMEM, got * r)
        assert plan.cs == (4 if got * r > 32 else -(-got * r // 16))
        if g == got:
            _check_plan(plan, g, r, c, mb, n_layers=8, nsm=132, occupancy=1, **dims)


def test_gqa2_verify_at_max_len_2048_streams_the_cache_in_blocks():
    """gpt-m GQA-2, spec_draft=4: the 20 score rows over 2,053 keys do not
    fit beside the ring and the x slots, so the score tile is narrower than
    the extent (whole chunks of keys) and leaves four weight slots."""
    fd = _fd()
    plan = _plan(12, 5, 2048, 128, hkv=2)
    assert plan.kb < 2048 and plan.kb % fd.KB_STEP == 0
    assert plan.layout["wslots"] >= fd.WSLOTS_WANTED
    _check_plan(plan, 12, 5, 2048, 128, n_layers=8, d=512, hq=8, hkv=2, dh=64, f=2048,
                nsm=132, occupancy=1)


@pytest.mark.parametrize("hkv,r,extents", [(8, 1, (65536, 262144)), (2, 5, (16384, 65536)),
                                            (1, 1, (16384, 65536))])
def test_plan_shared_memory_stops_growing_with_the_extent(hkv, r, extents):
    """Past one score tile the plan's shared memory does not depend on the
    slab's extent: the same tile, layout and bytes at both extents (MHA
    took at most ~40k positions before, 8:1 heads ~4,944). (A pool's table
    row, 4 bytes a block, still grows with it.)"""
    plans = [_plan(8 // r or 1, r, c, hkv=hkv) for c in extents]
    assert plans[0].kb == plans[1].kb < extents[0]
    assert plans[0].smem == plans[1].smem <= H100_SMEM
    assert plans[0].layout == plans[1].layout
    small = _plan(8 // r or 1, r, 512, hkv=hkv)
    assert small.kb == 512  # one block: the layout of a shape that fit before


def _weights(n, d, hq, hkv, dh, seed=0):
    g = torch.Generator().manual_seed(seed)
    f = 4 * d

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, f, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, (k, m) in dict(wq=(d, hq * dh), wk=(d, hkv * dh), wv=(d, hkv * dh), wo=(hq * dh, d),
                           w_up=(d, f), w_down=(f, d)).items():
        w[nm] = r(n, k, m, scale=k ** -0.5)
    return w, r


@pytest.mark.parametrize("kernel", ["decode_token_slab", "decode_token_paged",
                                    "verify_tokens_paged", "decode_block_slab",
                                    "decode_block_paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_grouped_plain_run_equals_the_whole_run(kernel, kv):
    """On the CPU ``MAX_GROUP`` splits a wrapper's slots into groups as the
    card's launches do (views of the slab, the tables, lengths, active and
    the verify's lengths; the pool shared): eight slots in groups of three
    (the last of two) give the whole run's outputs and committed caches bit
    for bit. (A group of one slot would take the CPU's matrix-vector
    product, whose sums run in another order.)"""
    fd = _fd()
    from distributed_tensorflow_tpu_torch.ops.quantized import quantize_kv

    n, s, c, hq, hkv, dh, bs = 2, 8, 32, 2, 1, 32, 8
    w, r = _weights(n, hq * dh, hq, hkv, dh)
    kw = dict(num_heads=hq, compute_dtype=torch.float32)
    mb = c // bs
    tables = torch.randperm(s * mb + 2, generator=torch.Generator().manual_seed(1))
    tables = tables[: s * mb].reshape(s, mb).int()
    lengths = torch.tensor([0, 5, 31, 12, 1, 20, 9, 17], dtype=torch.int32)
    active = torch.tensor([True, True, True, False, True, True, True, True])
    paged = "paged" in kernel
    shape = (n, s * mb + 2, bs, hkv, dh) if paged else (n, s, c, hkv, dh)
    raw = [r(*shape), r(*shape)]
    if kv == "bf16":
        caches = [raw[0].bfloat16(), raw[1].bfloat16(), None, None]
    else:
        (a, sa), (b, sb) = quantize_kv(raw[0], "int8"), quantize_kv(raw[1], "int8")
        caches = [a, b, sa, sb]
    h = r(s, 5, hq * dh) if kernel == "verify_tokens_paged" else r(s, hq * dh)

    def run(group):
        cs = [None if t is None else t.clone() for t in caches]
        sc = dict(k_scale=cs[2], v_scale=cs[3])
        fd.MAX_GROUP = group
        try:
            if kernel == "decode_token_slab":
                out = fd.decode_token_slab(h, w, cs[0], cs[1], lengths, active, **kw, **sc)[0]
            elif kernel == "decode_token_paged":
                out = fd.decode_token_paged(h, w, cs[0], cs[1], tables, lengths, active, **kw,
                                            **sc)[0]
            elif kernel == "verify_tokens_paged":
                slens = torch.tensor([5, 1, 3, 5, 2, 4, 5, 3], dtype=torch.int32)
                out = fd.verify_tokens_paged(h, w, cs[0], cs[1], tables, lengths, slens,
                                             active, **kw, **sc)
            else:
                w0 = {k: t[0] for k, t in w.items()}
                sc0 = {k: None if t is None else t[0] for k, t in sc.items()}
                if kernel == "decode_block_slab":
                    out = fd.decode_block_slab(h, w0, cs[0][0], cs[1][0], lengths, **kw, **sc0)
                else:
                    out = fd.decode_block_paged(h, w0, cs[0][0], cs[1][0], tables, lengths,
                                                **kw, **sc0)
        finally:
            fd.MAX_GROUP = None
        return (out if isinstance(out, tuple) else (out,)), cs

    (whole, wc), (grouped, gc) = run(None), run(3)
    for a, b in zip(whole + tuple(wc), grouped + tuple(gc)):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a,
                               b.view(torch.uint8) if b.dtype == torch.float8_e4m3fn else b)


def _gpt(**kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    cfg = dict(vocab_size=8192, max_len=1024, model_dim=512, num_heads=8, num_layers=8,
               compute_dtype=torch.bfloat16)
    return GPTLM(**{**cfg, **kw})


# (model knobs, slots, rows a slot, block size or None for the slab, the
# reason's words or None for a supported shape)
REASON_CASES = (
    (dict(), 8, 1, None, None),
    (dict(num_kv_heads=2, max_len=2048), 16, 5, 16, None),
    (dict(), 100, 1, None, None),
    (dict(compute_dtype=torch.float32), 8, 1, None, None),
    (dict(model_dim=512, num_heads=2), 8, 1, None, r"head_dim 4, 8, 16, 32, 64 or 128 \(got 256\)"),
    (dict(), 4, 65, 16, "65 rows a slot exceed the 64 rows"),
    (dict(model_dim=2048, num_heads=16, num_layers=4), 8, 17, 16,
     "17 rows a slot exceed the 16 rows"),
)


@pytest.mark.parametrize("knobs,slots,rows,bs,reason", REASON_CASES)
def test_decode_unsupported_reason_at_the_h100(knobs, slots, rows, bs, reason):
    """The port's ``GPTLM._decode_unsupported_reason``: None where the
    kernels serve the shape (any slot count, a GQA-2 verify at max_len
    2048, an f32 model), else why (a head dim the kernels are not built
    for, a verify of more rows a slot than a launch takes at the model's
    width)."""
    import re

    got = _gpt(**knobs)._decode_unsupported_reason(slots=slots, rows=rows, block_size=bs,
                                                   nsm=132, smem_limit=H100_SMEM)
    if reason is None:
        assert got is None
    else:
        assert got is not None and re.search(reason, got), got


def test_textserver_on_the_cpu_refuses_nothing():
    """On the CPU every engine runs the plain versions, so a server of an
    f32 model with the default engine is made and serves."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    model = GPTLM(vocab_size=97, max_len=32, model_dim=32, num_heads=2, num_layers=1,
                  compute_dtype=torch.float32)
    srv = TextServer(model, model.init(seed=1, device="cpu"), slots=2, chunk=4, paged=True,
                     block_size=4, spec_draft=3, device="cpu")
    out = srv.generate([torch.arange(5).numpy()], GenerationConfig(max_new=4))
    assert len(out[0]) == 4


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")


def _gpu_case(n, s, c, hq, hkv, dh, seed, paged_bs=0):
    """bf16 weights of n layers, a slab [n, s, c] or its pool under
    scrambled tables (blocks of paged_bs), and residual rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, f = hq * dh, 4 * hq * dh

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, device="cuda", generator=g) * scale).to(dt)

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, f, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, (k, m) in dict(wq=(d, d), wk=(d, hkv * dh), wv=(d, hkv * dh), wo=(d, d),
                           w_up=(d, f), w_down=(f, d)).items():
        w[nm] = r(n, k, m, scale=k ** -0.5, dt=torch.bfloat16)
    ck, cv = (r(n, s, c, hkv, dh, dt=torch.bfloat16) for _ in range(2))
    if not paged_bs:
        return w, r, ck, cv, None
    mb = c // paged_bs
    tables = torch.randperm(s * mb, device="cuda", generator=g).reshape(s, mb).int()
    pools = []
    for t in (ck, cv):
        p = torch.empty((n, s * mb, paged_bs, hkv, dh), dtype=t.dtype, device="cuda")
        for i in range(s):
            p[:, tables[i].long()] = t[:, i].reshape(n, mb, paged_bs, hkv, dh)
        pools.append(p)
    return w, r, pools[0], pools[1], tables


def _close(a, b, tol=2e-2):
    return (a.float() - b.float()).abs().max().item() <= tol * max(1.0, b.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_token_slab", "decode_token_paged",
                                    "verify_tokens_paged"])
def test_grouped_launches_match_plain_and_the_whole_launch_on_gpu(kernel):
    """Sixteen slots (B7: 5 rows each) launched in groups of 5 against the
    plain version, and bit for bit against the one launch of all of them
    (the groups' k-groups are the whole step's); then 100 slots of B6 (two
    groups: 64 and 36) against the plain version."""
    _cuda_or_skip()
    fd = _fd()
    n, s, c, hq, hkv, dh, bs = 2, 16 if kernel != "verify_tokens_paged" else 12, 256, 4, 2, 64, 16
    paged = kernel != "decode_token_slab"
    w, r, ck, cv, tables = _gpu_case(n, s, c, hq, hkv, dh, 3, bs if paged else 0)
    g = torch.Generator(device="cuda").manual_seed(4)
    lengths = torch.randint(0, c - 8, (s,), device="cuda", generator=g, dtype=torch.int32)
    active = torch.ones(s, dtype=torch.bool, device="cuda")
    active[3] = False
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    slens = torch.randint(1, 6, (s,), device="cuda", generator=g, dtype=torch.int32)
    h = r(s, 5, hq * dh) if kernel == "verify_tokens_paged" else r(s, hq * dh)

    def run(fn, group=None):
        k, v = ck.clone(), cv.clone()
        fd.MAX_GROUP = group
        try:
            if kernel == "decode_token_slab":
                out = fn(h, w, k, v, lengths, active, **kw)[0]
            elif kernel == "decode_token_paged":
                out = fn(h, w, k, v, tables, lengths, active, **kw)[0]
            else:
                out = fn(h, w, k, v, tables, lengths, slens, active, **kw)
        finally:
            fd.MAX_GROUP = None
        torch.cuda.synchronize()
        return out, k, v

    whole = run(getattr(fd, kernel))
    grouped = run(getattr(fd, kernel), 5)
    plain = run(getattr(fd, kernel + "_plain"))
    for a, b, p in zip(whole, grouped, plain):
        assert torch.equal(a, b)
        assert _close(b, p)


@pytest.mark.cuda
def test_b6_over_100_slots_matches_plain_on_gpu():
    """B6 at 100 slots of gpt-m width (2 layers): 64 + 36 slots, against the
    plain version; the launch count is the groups'."""
    _cuda_or_skip()
    fd = _fd()
    from distributed_tensorflow_tpu_torch.ops import _build

    n, s, c = 2, 100, 128
    w, r, ck, cv, _ = _gpu_case(n, s, c, 8, 8, 64, 5)
    g = torch.Generator(device="cuda").manual_seed(6)
    lengths = torch.randint(0, c - 1, (s,), device="cuda", generator=g, dtype=torch.int32)
    active = torch.ones(s, dtype=torch.bool, device="cuda")
    h = r(s, 512)
    kw = dict(num_heads=8, compute_dtype=torch.bfloat16)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    before = _build.LAUNCHES["decode_token_slab"]
    o1 = fd.decode_token_slab(h, w, k1, v1, lengths, active, **kw)[0]
    assert _build.LAUNCHES["decode_token_slab"] - before == 2
    o2 = fd.decode_token_slab_plain(h, w, k2, v2, lengths, active, **kw)[0]
    torch.cuda.synchronize()
    assert _close(o1, o2) and _close(k1, k2) and _close(v1, v2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,hkv,c,lo,hi", [
    ("decode_token_slab", 1, 8192, 6000, 8000),
    ("decode_block_paged", 1, 8192, 5000, 8100),
    ("verify_tokens_paged", 2, 2048, 1500, 2040),
])
def test_attention_in_several_score_tiles_matches_plain_on_gpu(kernel, hkv, c, lo, hi):
    """Caches past one score tile (8:1 heads at 6,000-8,000 positions; GQA-2
    verify rows at max_len 2048): the kernel streams them in blocks, K
    twice, and lands within the decode tolerance of the plain version."""
    _cuda_or_skip()
    fd = _fd()
    n, s, hq, dh, bs = 2, 4, 8, 64, 16
    paged = kernel != "decode_token_slab"
    w, r, ck, cv, tables = _gpu_case(n, s, c, hq, hkv, dh, 7, bs if paged else 0)
    plan = fd.launch_plan(kernel, s, 5 if kernel.startswith("verify") else 1,
                          1 if kernel == "decode_block_paged" else n, hq * dh, hq, hkv, dh,
                          4 * hq * dh, c, c // bs if paged else 0, "cuda")
    assert plan.kb < c
    g = torch.Generator(device="cuda").manual_seed(8)
    lengths = torch.randint(lo, hi, (s,), device="cuda", generator=g, dtype=torch.int32)
    active = torch.ones(s, dtype=torch.bool, device="cuda")
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    h = r(s, hq * dh)
    if kernel == "decode_token_slab":
        k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        got = fd.decode_token_slab(h, w, k1, v1, lengths, active, **kw)[0]
        want = fd.decode_token_slab_plain(h, w, k2, v2, lengths, active, **kw)[0]
    elif kernel == "decode_block_paged":
        w0 = {k: t[0] for k, t in w.items()}
        got = fd.decode_block_paged(h, w0, ck[0], cv[0], tables, lengths, **kw)[0]
        want = fd.decode_block_paged_plain(h, w0, ck[0], cv[0], tables, lengths, **kw)[0]
    else:
        hv = r(s, 5, hq * dh)
        slens = torch.tensor([5, 3, 1, 4], device="cuda", dtype=torch.int32)
        got = fd.verify_tokens_paged(hv, w, ck.clone(), cv.clone(), tables, lengths, slens,
                                     active, **kw)
        want = fd.verify_tokens_paged_plain(hv, w, ck.clone(), cv.clone(), tables, lengths,
                                            slens, active, **kw)
    torch.cuda.synchronize()
    assert _close(got, want)


@pytest.mark.cuda
def test_textserver_refuses_at_construction_on_gpu():
    """On the card a model of a head dim the kernels are not built for, and
    a verify of more rows a slot than a launch takes, are refused when the
    server is made, before any request is admitted; "xla" serves the first;
    an f32 model is served on the kernels."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.serve import TextServer

    wide = GPTLM(vocab_size=97, max_len=64, model_dim=512, num_heads=2, num_layers=1)
    params = wide.init(seed=1, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        TextServer(wide, params, slots=2)
    TextServer(wide, params, slots=2, decode_engine="xla")
    f32 = GPTLM(vocab_size=97, max_len=64, model_dim=64, num_heads=2, num_layers=1,
                compute_dtype=torch.float32)
    TextServer(f32, f32.init(seed=1, device="cuda"), slots=2)
    bf = GPTLM(vocab_size=97, max_len=128, model_dim=64, num_heads=2, num_layers=1)
    with pytest.raises(ValueError, match="rows a slot exceed"):
        TextServer(bf, bf.init(seed=1, device="cuda"), slots=2, paged=True, spec_draft=64)
