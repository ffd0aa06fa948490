#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
non-zero):

1. the device, and ``nvidia-smi``'s name and power limit;
2. build every CUDA kernel from ``distributed_tensorflow_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, started together);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and time kernel, plain version and
   (flash only) ``scaled_dot_product_attention`` as a yardstick, beside the
   bound the card's peak rates set;
4. serve the gpt-m-L1024-flash configuration (d=512, 8 layers, 8 heads,
   max_len 1024, vocab 8192, bf16, seeded random weights) through
   ``TextServer.generate``: 8 slots, chunk 32, 12 requests greedy and
   sampled across seven prompt buckets, the last (L=1023) over 512; the
   launch counts are zeroed before and read after, and the flash and
   megakernel counts must be above zero;
5. serve the greedy requests again on the per-layer kernel
   (``decode_engine="fused-layer"``), compare the streams, and compare
   logits over an 8-step greedy decode: megakernel vs per-layer kernel vs
   the plain version on the card;
6. a small model on the card against the same model's plain version on
   the CPU, logits within tolerance;
7. the MLP kernels against their plain versions at the reference
   workload's shapes (784->100->10, batch 100, synthetic MNIST): the step
   kernel over three steps, the epoch kernel over one 550-step epoch in
   bf16 and in f32 staging, and the epoch kernel against 550 launches of
   the step kernel; each timed beside its plain version and its bound;
8. train the reference workload through ``launch.build_trainer``:
   100 epochs with ``compiled_run=True, engine="pallas"`` must print the
   reference's lines, launch the epoch kernel once per epoch with finite
   costs and reach the 0.72 test-accuracy oracle; then 2 epochs on the
   default plain path;
9. the port's bench (``distributed_tensorflow_tpu_torch.bench``) for the
   impls pallas-epoch, pallas (its step-kernel launches must equal its
   step count) and xla, each printing its JSON line.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 CUDA-core FLOP/s.
HBM_BPS = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

SERVE_CFG = dict(
    vocab_size=8192, model_dim=512, num_layers=8, num_heads=8, max_len=1024,
    attention_impl="flash", flash_min_len=0,
)
PROMPT_LENS = (12, 30, 60, 100, 200, 300, 450, 600, 800, 900, 25, 700)
MAX_NEW = 96

# Tolerances of kernel vs plain version, as multiples of the reference's
# largest magnitude. flash: f32 in, f32 math, sums in another order.
# decode: bf16 weights and caches, f32 accumulation in another order; an
# intermediate rounded to bf16 (layernormed rows, attention output,
# gelu(up), softmax weights, the fresh K/V rows) can land one bf16 ulp
# (2^-8 relative) apart, which then propagates through later products.
# fused MLP costs: f32 throughout, sums in another order (logits shares
# summed per CTA, products per warp): a few steps agree to ~1e-6, and 550
# steps accumulate that rounding.
REL_TOL = {"flash_fwd": 1e-5, "decode_block_slab": 2e-2, "decode_token_slab": 2e-2,
           "fused_mlp_step": 1e-5, "fused_mlp_epoch": 1e-3}
# fused MLP parameters are held by their UPDATE (state - start), since
# lr=0.001 moves N(0,1) weights by ~1e-4 in 3 steps and ~1e-2 in an epoch.
# Per tensor: error <= share * max|update| + ulps * ulp(max|parameter|).
# The ulp term is the f32 rounding of w - lr*dw, which may land one ulp
# apart at each step; the share term is the update's own rounding (sums in
# another order agree to ~1e-6 of it). On an H100 the kernels land within
# 1 ulp and 6e-5 of the update; a step update off by 1% (one example of
# 100 dropped, a wrong lr scaling) misses these limits.
UPDATE_TOL = {"fused_mlp_step": (1e-3, 6), "fused_mlp_epoch": (2e-3, 32)}

SOURCES = {
    "flash_fwd": ("distributed_tensorflow_tpu_torch/ops/csrc/flash_fwd.cu",
                  "distributed_tensorflow_tpu/ops/pallas_attention.py:208"),
    "decode_block_slab": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_decode.cu",
                          "distributed_tensorflow_tpu/ops/pallas_decode.py:181"),
    "decode_token_slab": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_decode.cu",
                          "distributed_tensorflow_tpu/ops/pallas_decode.py:618"),
    "fused_mlp_step": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_mlp.cu",
                       "distributed_tensorflow_tpu/ops/pallas_mlp.py:69"),
    "fused_mlp_epoch": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_mlp.cu",
                        "distributed_tensorflow_tpu/ops/pallas_mlp.py:181"),
}
PATHS = {"decode_block_slab": "fused-layer", "fused_mlp_step": "mlp-step",
         "fused_mlp_epoch": "mlp-train"}
MLP_LR = 0.001
MLP_EPOCHS = 100
ACCURACY_ORACLE = 0.72


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events around the run, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def perturbed_params(model, seed, device):
    """``model.init(seed)`` with the zero-initialized residual projections,
    biases and layernorm parameters filled with seeded random values (at
    init every block is the identity)."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import map_params

    p = model.init(seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    b = p.blocks
    n, d, _ = b.wo.shape
    f = b.w_up.shape[-1]

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    blocks = b._replace(
        wo=rn(n, d, d, scale=d ** -0.5),
        w_down=rn(n, f, d, scale=f ** -0.5),
        b_up=rn(n, f, scale=0.05), b_down=rn(n, d, scale=0.05),
        ln1_bias=rn(n, d, scale=0.05), ln2_bias=rn(n, d, scale=0.05),
        ln1_scale=1 + rn(n, d, scale=0.1), ln2_scale=1 + rn(n, d, scale=0.1),
    )
    p = p._replace(blocks=blocks, lnf_scale=1 + rn(d, scale=0.1),
                   lnf_bias=rn(d, scale=0.05))
    return map_params(p, lambda t: t.to(device))


def check_error(name, err, ref_scale):
    tol = REL_TOL[name] * max(1.0, ref_scale)
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")


def phase_kernels(records):
    """Kernel vs plain version on the card at the serving path's shapes."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_attention_with_lse,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    S, H, Dh, d, n, C, Fw = 8, 8, 64, 512, 8, 1024, 2048

    # K3 at the largest bucket (L=1023, the ragged length) with f32 q/k/v,
    # as the prefill hands them over, all slots admitted.
    L = 1023
    q, k, v = (torch.randn(S, L, H, Dh, device=dev, generator=g) for _ in range(3))
    lens = torch.randint(513, L + 1, (S,), device=dev, generator=g, dtype=torch.int32)
    out, lse = flash_attention_with_lse(q, k, v, causal=True, kv_lens=lens)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True, kv_lens=lens)
    torch.cuda.synchronize()
    err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
    check_error("flash_fwd", err, ref.abs().max().item())
    pos = torch.arange(L, device=dev)
    allowed = (pos[None, :, None] >= pos[None, None, :]) & (
        pos[None, None, :] < lens[:, None, None]
    )
    pairs = int(allowed.sum().item())
    flops = 4 * Dh * H * pairs
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + lse.numel()) + 4 * S
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = allowed[:, None]
    records["flash_fwd"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: flash_attention_with_lse(q, k, v, causal=True, kv_lens=lens)),
        plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True, kv_lens=lens), 5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
        **bound(nbytes, flops, PEAK_F32),
    )

    # K7 / K8 at gpt-m widths: 8 slots, cache lengths around 512.
    def rw(*shape, scale):
        return (torch.randn(shape, device=dev, generator=g) * scale)

    w = {
        "ln1_scale": 1 + rw(n, d, scale=0.1), "ln1_bias": rw(n, d, scale=0.05),
        "wq": rw(n, d, d, scale=d ** -0.5).bfloat16(),
        "wk": rw(n, d, d, scale=d ** -0.5).bfloat16(),
        "wv": rw(n, d, d, scale=d ** -0.5).bfloat16(),
        "wo": rw(n, d, d, scale=d ** -0.5).bfloat16(),
        "ln2_scale": 1 + rw(n, d, scale=0.1), "ln2_bias": rw(n, d, scale=0.05),
        "w_up": rw(n, d, Fw, scale=d ** -0.5).bfloat16(), "b_up": rw(n, Fw, scale=0.05),
        "w_down": rw(n, Fw, d, scale=Fw ** -0.5).bfloat16(), "b_down": rw(n, d, scale=0.05),
    }
    ck = rw(n, S, C, H, Dh, scale=1.0).bfloat16()
    cv = rw(n, S, C, H, Dh, scale=1.0).bfloat16()
    lengths = torch.randint(256, 769, (S,), device=dev, generator=g, dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    active[S - 1] = False  # one inactive row: it must not be committed
    h = rw(S, d, scale=1.0)
    kw = dict(num_heads=H, compute_dtype=torch.bfloat16)
    w0 = {k_: t[0] for k_, t in w.items()}
    wbytes_layer = sum(t[0].numel() * t.element_size() for t in w.values())
    kv_elems = int(lengths.sum().item()) * H * Dh  # per layer, K or V
    attn_flops_layer = 4 * (int(lengths.sum().item()) + S) * H * Dh
    mat_flops_layer = 2 * S * sum(w[nm][0].numel() for nm in fd.PROJ_NAMES)

    o7, k7, v7 = fd.decode_block_slab(h, w0, ck[0], cv[0], lengths, **kw)
    r7, rk7, rv7 = fd.decode_block_slab_plain(h, w0, ck[0], cv[0], lengths, **kw)
    torch.cuda.synchronize()
    err = max((o7 - r7).abs().max().item(), (k7.float() - rk7.float()).abs().max().item(),
              (v7.float() - rv7.float()).abs().max().item())
    check_error("decode_block_slab", err, r7.abs().max().item())
    records["decode_block_slab"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fd.decode_block_slab(h, w0, ck[0], cv[0], lengths, **kw)),
        plain_ms=cuda_ms(lambda: fd.decode_block_slab_plain(h, w0, ck[0], cv[0], lengths, **kw)),
        library_ms=None,
        **bound(wbytes_layer + 2 * kv_elems * 2 + 2 * S * d * 4 + 2 * S * H * Dh * 2,
                mat_flops_layer + attn_flops_layer, PEAK_BF16),
    )

    ck8, cv8 = ck.clone(), cv.clone()
    o8, _, _ = fd.decode_token_slab(h, w, ck8, cv8, lengths, active, **kw)
    ckp, cvp = ck.clone(), cv.clone()
    r8, _, _ = fd.decode_token_slab_plain(h, w, ckp, cvp, lengths, active, **kw)
    torch.cuda.synchronize()
    err = max((o8 - r8).abs().max().item(), (ck8.float() - ckp.float()).abs().max().item(),
              (cv8.float() - cvp.float()).abs().max().item())
    check_error("decode_token_slab", err, r8.abs().max().item())
    rows = torch.arange(S, device=dev)
    if not torch.equal(ck8[:, S - 1], ck[:, S - 1]) or torch.equal(
        ck8[:, rows[:-1], lengths[:-1].long()], ck[:, rows[:-1], lengths[:-1].long()]
    ):
        raise AssertionError("megakernel commit: inactive row written or active row not")
    del ckp, cvp
    records["decode_token_slab"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fd.decode_token_slab(h, w, ck8, cv8, lengths, active, **kw)),
        plain_ms=cuda_ms(lambda: fd.decode_token_slab_plain(h, w, ck8, cv8, lengths, active, **kw), 5),
        library_ms=None,
        **bound(n * (wbytes_layer + 2 * kv_elems * 2 + 2 * S * H * Dh * 2) + 2 * S * d * 4,
                n * (mat_flops_layer + attn_flops_layer), PEAK_BF16),
    )
    for name, r in records.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def bound(nbytes, flops, peak):
    tb, tf = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return dict(bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf else "operations")


def serve_requests(vocab, seed):
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]
    configs = [
        GenerationConfig(max_new=MAX_NEW) if i % 2 == 0 else
        GenerationConfig(max_new=MAX_NEW, greedy=False, temperature=0.9,
                         top_p=0.95, seed=i)
        for i in range(len(prompts))
    ]
    return prompts, configs


def phase_serve(records):
    """The main path: TextServer over the megakernel and the flash prefill."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import TextServer

    model = GPTLM(**SERVE_CFG, compute_dtype=torch.bfloat16)
    params = perturbed_params(model, 0, "cuda")
    prompts, configs = serve_requests(model.vocab_size, 0)
    buckets = sorted({TextServer(model, params, slots=1).bucket_for(len(p)) for p in prompts})
    print(f"  {len(prompts)} requests, buckets {buckets}, max_new {MAX_NEW}")
    srv = TextServer(model, params, slots=8, chunk=32)
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, configs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"  launches on the main path: {launches}")
    for name in ("flash_fwd", "decode_token_slab"):
        if launches[name] < 1:
            raise AssertionError(f"the serving path never launched {name}")
        records[name]["launches"] = launches[name]
    ntok = sum(len(o) for o in outs)
    for o, c, p in zip(outs, configs, prompts):
        if len(o) != c.max_new or o.min() < 0 or o.max() >= model.vocab_size:
            raise AssertionError(f"bad stream for a {len(p)}-token prompt: {o}")
    if len({int(t) for o in outs for t in o}) < 8:
        raise AssertionError("degenerate streams: fewer than 8 distinct tokens")
    ttft = [srv.stats[i]["ttft_s"] for i in sorted(srv.stats)]
    tm = srv.timing
    print(f"  served {ntok} tokens in {wall:.3f} s: {ntok / wall:.1f} tokens/s; "
          f"TTFT mean {1e3 * np.mean(ttft):.1f} ms max {1e3 * max(ttft):.1f} ms; "
          f"decode {1e3 * tm['decode_s'] / tm['decode_steps']:.3f} ms per step "
          f"({tm['decode_steps']} steps, {tm['decode_tokens']} tokens); "
          f"prefill total {1e3 * tm['prefill_s']:.1f} ms")
    return model, params, prompts, configs, outs


def phase_fused_layer(records, model, params, prompts, configs, outs):
    """The per-layer kernel path, and an 8-step greedy logits comparison."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.serve import TextServer

    greedy = [i for i, c in enumerate(configs) if c.greedy]
    srv = TextServer(model, params, slots=8, chunk=32, decode_engine="fused-layer")
    _build.reset_launches()
    outs2 = srv.generate([prompts[i] for i in greedy], [configs[i] for i in greedy])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches on the fused-layer path: {launches}")
    if launches["decode_block_slab"] < 1:
        raise AssertionError("the fused-layer path never launched decode_block_slab")
    records["decode_block_slab"]["launches"] = launches["decode_block_slab"]
    tm = srv.timing
    print(f"  decode {1e3 * tm['decode_s'] / tm['decode_steps']:.3f} ms per step "
          f"({tm['decode_steps']} steps, {tm['decode_tokens']} tokens)")
    same =sum(int((a == b).sum()) for a, b in zip(outs2, (outs[i] for i in greedy)))
    total = sum(len(a) for a in outs2)
    print(f"  greedy streams, megakernel vs per-layer kernel: {same}/{total} tokens agree")

    # 8-step greedy decode from one prefilled cache: megakernel, per-layer
    # kernel and the plain version on the card, each fed its own argmax.
    sp = srv.params
    S = 8
    toks = np.zeros((S, 128), np.int32)
    lens = np.array([min(len(prompts[i]), 128) for i in range(S)], np.int32)
    for i in range(S):
        toks[i, : lens[i]] = prompts[i][: lens[i]]
    cache0 = model.empty_slot_cache(S, device="cuda")
    dev = torch.device("cuda")
    logits0, cache0 = model.prefill_slots(
        sp, cache0, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
        torch.ones(S, dtype=torch.bool, device=dev))
    weights = {nm: getattr(sp.blocks, nm) for nm in fd.WEIGHT_NAMES}

    def plain_step(tok, cache, act):
        h = model._embed_tokens(sp, tok[:, None], cache.lengths[:, None])[:, 0]
        h, _, _ = fd.decode_token_slab_plain(
            h, weights, cache.k, cache.v, cache.lengths, act, num_heads=model.num_heads,
            compute_dtype=model.compute_dtype)
        return model._logits(sp, h), cache._replace(lengths=cache.lengths + act.int())

    runs = {}
    for eng in ("fused", "fused-layer", "plain"):
        cache = cache0._replace(k=cache0.k.clone(), v=cache0.v.clone(),
                                lengths=cache0.lengths.clone())
        tok = logits0.argmax(-1).int()
        act = torch.ones(S, dtype=torch.bool, device=dev)
        lg, tk = [], []
        for _ in range(8):
            if eng == "plain":
                logits, cache = plain_step(tok, cache, act)
            else:
                logits, cache = model.decode_slots(sp, tok, cache, act, engine=eng)
            tok = logits.argmax(-1).int()
            lg.append(logits)
            tk.append(tok)
        runs[eng] = (torch.stack(lg), torch.stack(tk))
    ref_l, ref_t = runs["fused"]
    for eng in ("fused-layer", "plain"):
        lgs, tks = runs[eng]
        err = (lgs - ref_l).abs().max().item()
        agree = (tks == ref_t).float().mean().item()
        print(f"  decode-mega-vs-{eng}: max logit err {err:.3e}, "
              f"token agreement {agree:.4f} over 8 greedy steps x {S} slots")
        if err > 0.25 * max(1.0, ref_l.abs().max().item()):
            raise AssertionError(f"megakernel logits disagree with {eng}: {err}")


def phase_small_reference():
    """A small model on the card against its plain version on the CPU."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, map_params

    model = GPTLM(vocab_size=97, max_len=64, model_dim=128, num_heads=2, num_layers=2,
                  compute_dtype=torch.bfloat16, attention_impl="flash", flash_min_len=0)
    p_cpu = model.serving_params(perturbed_params(model, 3, "cpu"))
    p_gpu = map_params(p_cpu, lambda t: t.to("cuda"))
    rng = np.random.default_rng(3)
    S, L = 4, 16
    toks = rng.integers(0, 97, (S, L)).astype(np.int32)
    lens = np.array([16, 5, 9, 1], np.int32)
    steps = rng.integers(0, 97, (6, S)).astype(np.int32)
    res = {}
    for dev in ("cuda", "cpu"):
        p = p_gpu if dev == "cuda" else p_cpu
        cache = model.empty_slot_cache(S, device=dev)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        lg, cache = model.prefill_slots(p, cache, t(toks), t(lens),
                                        torch.ones(S, dtype=torch.bool, device=dev))
        out = [lg.float().cpu()]
        for row in steps:
            lg, cache = model.decode_slots(p, t(row), cache)
            out.append(lg.float().cpu())
        res[dev] = torch.stack(out)
    err = (res["cuda"] - res["cpu"]).abs().max().item()
    scale = res["cpu"].abs().max().item()
    print(f"  small model, card (kernels) vs CPU (plain): max logit err {err:.3e} "
          f"(tolerance {0.05 * max(1.0, scale):.3e})")
    if not (torch.isfinite(res["cuda"]).all() and err <= 0.05 * max(1.0, scale)):
        raise AssertionError("kernels on the card disagree with the CPU reference")


def ulp32(x: float) -> float:
    """The f32 spacing at magnitude ``x``."""
    return float(np.spacing(np.float32(x)))


def check_mlp(name, costs, got, ref, base):
    """Kernel vs plain run of the MLP from the same start ``base``: the
    costs within REL_TOL of max(1, |cost|), each parameter's update within
    UPDATE_TOL. Returns the largest absolute error."""
    kc, pc = costs
    worst = (kc - pc).abs().max().item()
    tol = REL_TOL[name] * max(1.0, pc.abs().max().item())
    print(f"  {name} costs: max_abs_err {worst:.3e} (tolerance {tol:.3e})")
    if not worst <= tol:
        raise AssertionError(f"{name} costs disagree with the plain version: {worst} > {tol}")
    share, ulps = UPDATE_TOL[name]
    bad = []
    for pname, g, r, b in zip(("w1", "b1", "w2", "b2"), got, ref, base):
        err = (g - r).abs().max().item()
        upd = (r - b).abs().max().item()
        ulp = ulp32(max(r.abs().max().item(), b.abs().max().item()))
        tol = share * upd + ulps * ulp
        print(f"  {name} {pname}: max_abs_err {err:.3e} = {err / upd:.2e} of max|update| "
              f"{upd:.3e} = {err / ulp:.2f} ulp (tolerance {tol:.3e})")
        if not err <= tol:
            bad.append(f"{pname} {err} > {tol}")
        worst = max(worst, err)
    if bad:
        raise AssertionError(f"{name} updates disagree with the plain version: {bad}")
    return worst


def phase_mlp_kernels(records, ds):
    """B1 and B2 against their plain versions at the reference shapes."""
    import torch
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    dev = torch.device("cuda")
    B, IN, H, OUT = 100, 784, 100, 10
    steps = ds.train.num_examples // B
    base = fm.to_fused(MLP().init(seed=1, device=dev))
    perm = np.random.default_rng(7).permutation(ds.train.num_examples)[: steps * B]
    perm = torch.from_numpy(perm).to(dev)
    xs32 = torch.from_numpy(ds.train.images).to(dev).index_select(0, perm).reshape(steps, B, IN)
    ys32 = torch.from_numpy(ds.train.labels).to(dev).index_select(0, perm).reshape(steps, B, OUT)
    xs16, ys16 = xs32.bfloat16(), ys32.bfloat16()

    def fresh():
        return fm.FusedState(*(t.clone() for t in base))

    # B1: three steps from one state, kernel vs plain, costs and parameters.
    k, p = fresh(), fresh()
    kcs, pcs = [], []
    for i in range(3):
        kcs.append(fm.fused_train_step(k, xs32[i], ys32[i], learning_rate=MLP_LR)[1].clone())
        pcs.append(fm.fused_train_step_plain(p, xs32[i], ys32[i], learning_rate=MLP_LR)[1])
    torch.cuda.synchronize()
    err1 = check_mlp("fused_mlp_step", (torch.stack(kcs), torch.stack(pcs)), k, p, base)

    # B2: one epoch in bf16 and in f32 staging vs the plain loop, and the
    # bf16 epoch vs 550 launches of B1 over the same (upcast) batches. The
    # two kernels share their device step function, so the last check
    # holds the epoch loop (resident parameters, double-buffered shares),
    # not the step arithmetic, which the plain loop holds.
    errs = []
    for xs, ys in ((xs16, ys16), (xs32, ys32)):
        k, kc = fm.fused_epoch(fresh(), xs, ys, learning_rate=MLP_LR)
        p, pc = fm.fused_epoch_plain(fresh(), xs, ys, learning_rate=MLP_LR)
        torch.cuda.synchronize()
        if not torch.isfinite(kc).all():
            raise AssertionError("fused_mlp_epoch: non-finite costs")
        errs.append(check_mlp("fused_mlp_epoch", (kc, pc), k, p, base))
    k, kc = fm.fused_epoch(fresh(), xs16, ys16, learning_rate=MLP_LR)
    s = fresh()
    sc = torch.stack([fm.fused_train_step(s, xs16[i].float(), ys16[i].float(),
                                          learning_rate=MLP_LR)[1] for i in range(steps)])
    torch.cuda.synchronize()
    err_vs_b1 = check_mlp("fused_mlp_epoch", (kc, sc), k, s, base)
    print(f"  epoch kernel vs {steps} step-kernel launches: max_abs_err {err_vs_b1:.3e}")

    # Times at the main path's shapes, and the bounds: operations over the
    # f32 peak (the update math is f32), bytes each input read and each
    # output written once.
    flops = 2 * B * (IN * H * 2 + H * OUT * 3)
    pbytes = 4 * (IN * H + H + H * OUT + OUT)
    t1, t2, t3, t4 = fresh(), fresh(), fresh(), fresh()
    records["fused_mlp_step"] = dict(
        max_abs_err=err1,
        ms=cuda_ms(lambda: fm.fused_train_step(t1, xs32[0], ys32[0], learning_rate=MLP_LR), 200),
        plain_ms=cuda_ms(
            lambda: fm.fused_train_step_plain(t2, xs32[0], ys32[0], learning_rate=MLP_LR), 50),
        library_ms=None,
        **bound(4 * B * (IN + OUT) + 2 * pbytes + 4, flops, PEAK_F32),
    )
    records["fused_mlp_epoch"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: fm.fused_epoch(t3, xs16, ys16, learning_rate=MLP_LR), 5, 1),
        plain_ms=cuda_ms(lambda: fm.fused_epoch_plain(t4, xs16, ys16, learning_rate=MLP_LR), 2, 1),
        library_ms=None,
        **bound(2 * steps * B * (IN + OUT) + 2 * pbytes + 4 * steps, steps * flops, PEAK_F32),
    )
    for name in ("fused_mlp_step", "fused_mlp_epoch"):
        r = records[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"  epoch kernel: {1e3 * records['fused_mlp_epoch']['ms'] / steps:.3f} us per step "
          f"against {1e3 * records['fused_mlp_epoch']['bound_ms'] / steps:.3f} us bound")

    # What a step costs with almost no arithmetic: the same grid (25 CTAs)
    # at B=1, in=32, so the grid barrier and the share reduction remain.
    tiny = fm.FusedState(torch.zeros(32, H, device=dev), torch.zeros(1, H, device=dev),
                         torch.zeros(H, OUT, device=dev), torch.zeros(1, OUT, device=dev))
    tx = torch.rand(steps, 1, 32, device=dev)
    ty = torch.zeros(steps, 1, OUT, device=dev)
    ty[..., 0] = 1
    tiny_ms = cuda_ms(lambda: fm.fused_epoch(tiny, tx, ty, learning_rate=MLP_LR), 5, 1)
    print(f"  epoch kernel at B=1, 32->100->10 ({steps} steps): {tiny_ms:.4f} ms, "
          f"{1e3 * tiny_ms / steps:.3f} us per step (the barrier-bound floor)")


def phase_mlp_train(records, ds):
    """The reference workload through the normal entry point."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.ops import _build

    n = ds.train.num_examples
    lines = []
    tr = build_trainer(
        TrainConfig(epochs=MLP_EPOCHS, compiled_run=True, engine="pallas", log_frequency=10**9),
        datasets=ds, print_fn=lines.append,
    )
    _build.reset_launches()
    t0 = time.perf_counter()
    res = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"  launches on the training path: {launches}")
    if launches["fused_mlp_epoch"] != MLP_EPOCHS:
        raise AssertionError(f"expected {MLP_EPOCHS} epoch-kernel launches: {launches}")
    records["fused_mlp_epoch"]["launches"] = launches["fused_mlp_epoch"]
    for line in lines[:3] + lines[-5:]:
        print(f"  | {line}")
    steps_lines = [ln for ln in lines if ln.startswith("Step:")]
    costs = [float(ln.split("Cost:")[1].split(",")[0]) for ln in steps_lines]
    if (len(steps_lines) != MLP_EPOCHS
            or sum(ln.startswith("Test-Accuracy:") for ln in lines) != MLP_EPOCHS
            or lines[-2:] != [f"Final Cost: {res['final_cost']:.4f}", "Done"]
            or not np.isfinite(costs + [res["final_cost"]]).all()):
        raise AssertionError("the training run did not print the reference's lines "
                             "with finite costs")
    acc = res["accuracy"]
    print(f"  {MLP_EPOCHS} epochs, engine=pallas: test accuracy {acc:.4f} "
          f"(oracle >= {ACCURACY_ORACLE}), final cost {res['final_cost']:.4f}, "
          f"{res['global_step']} steps in {wall:.3f} s: "
          f"{MLP_EPOCHS * n / wall:.1f} examples/s")
    if not acc >= ACCURACY_ORACLE:
        raise AssertionError(f"test accuracy {acc} below the {ACCURACY_ORACLE} oracle")

    lines = []
    tr = build_trainer(TrainConfig(epochs=2, log_frequency=10**9), datasets=ds,
                       print_fn=lines.append)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tr._indexed_fn is None or any(_build.LAUNCHES.values()):
        raise AssertionError("the default path on cuda is the scanned plain path")
    if lines[-1] != "Done" or not np.isfinite(res["final_cost"]):
        raise AssertionError(f"the plain path failed: {lines[-3:]}")
    print(f"  2 epochs, default plain scanned path: test accuracy {res['accuracy']:.4f}, "
          f"final cost {res['final_cost']:.4f}, {2 * n / wall:.1f} examples/s")


def phase_mlp_bench(records, ds):
    """The port's bench for every impl; the step impl's launches must
    equal the steps it ran."""
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.ops import _build

    for argv, kernel in ((["--impl", "pallas-epoch"], "fused_mlp_epoch"),
                         (["--impl", "pallas", "--epochs-per-dispatch", "1"], "fused_mlp_step"),
                         (["--impl", "xla", "--epochs-per-dispatch", "1"], None)):
        _build.reset_launches()
        _, steps = bench.main(argv, datasets=ds)
        launches = dict(_build.LAUNCHES)
        print(f"  {' '.join(argv)}: {steps} steps, launches {launches}")
        if kernel == "fused_mlp_step":
            if launches[kernel] != steps:
                raise AssertionError(f"bench ran {steps} steps but {launches[kernel]} launches")
            records[kernel]["launches"] = launches[kernel]
        elif kernel is not None and launches[kernel] < 1:
            raise AssertionError(f"bench never launched {kernel}")
        elif kernel is None and any(launches.values()):
            raise AssertionError("the xla impl launched a kernel")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tensorflow_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    print("phase 2: build")
    _build.build_all()
    for src, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {src}: {line.strip()}")
    print(f"  built in {time.perf_counter() - t0:.1f} s")

    records: dict[str, dict] = {}
    print("phase 3: kernels vs plain versions")
    phase_kernels(records)
    print("phase 4: serve gpt-m-L1024-flash")
    model, params, prompts, configs, outs = phase_serve(records)
    print("phase 5: per-layer kernel path")
    phase_fused_layer(records, model, params, prompts, configs, outs)
    print("phase 6: small-input reference")
    phase_small_reference()
    print("phase 7: MLP kernels vs plain versions")
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets

    ds = read_data_sets("MNIST_data", one_hot=True)  # synthetic without IDX files
    phase_mlp_kernels(records, ds)
    print(f"phase 8: train the MNIST MLP, {MLP_EPOCHS} epochs")
    phase_mlp_train(records, ds)
    print("phase 9: bench")
    phase_mlp_bench(records, ds)
    print(f"total {time.perf_counter() - t0:.1f} s")

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        r = records[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "path": PATHS.get(kname, "main"),
        })
    print(f"power: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
