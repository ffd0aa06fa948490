#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [--root DIR] [--label NAME]

Phases, each of which must pass (nothing is caught; any failure exits
non-zero):

1. the device, and ``nvidia-smi``'s name and power limit;
2. build every CUDA kernel from ``distributed_tensorflow_tpu_torch/ops/csrc``
   (the cooperative decode kernels twice: bf16 and f32 compute) and the MLP
   and decode kernels' probe builds (one ``nvcc`` each, started together);
   the tensor-core kernels (flash at head dims 8 to 128, the cooperative
   decode step and verify in both compute dtypes) and the MLP kernels must
   build without register spills, the former hold HMMA instructions;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and time kernel, plain version and
   (flash only) ``scaled_dot_product_attention`` as a yardstick, beside the
   bound the card's peak rates set;
4. serve the gpt-m-L1024-flash configuration (d=512, 8 layers, 8 heads,
   max_len 1024, vocab 8192, bf16, seeded random weights) through
   ``TextServer.generate``: 8 slots, chunk 32, 12 requests greedy and
   sampled across seven prompt buckets, the last (L=1023) over 512; the
   launch counts are zeroed before and read after, and the flash and
   megakernel counts must be above zero; then 8 of the requests again,
   their decode timed without the profiler and then traced by
   ``torch.profiler`` (CUDA activity only): the device's time over the
   unprofiled wall time is its busy share a step;
5. serve the greedy requests again on the per-layer kernel
   (``decode_engine="fused-layer"``), compare the streams, split its decode
   step between host and device as phase 4 does, and compare logits over
   an 8-step greedy decode: megakernel vs per-layer kernel vs the plain
   version on the card (where a pick differs from the megakernel's, the
   megakernel's top-2 gap must be a near-tie, and the engine continues
   from the megakernel's token); 5(b) the same 8-step comparison at
   gpt-xl width (d=2048, 16 heads of 128, 4 layers) on the per-layer and
   whole-model kernels against the plain decode;
6. a small model on the card against the same model's plain version on
   the CPU, logits within tolerance;
7. the MLP kernels against their plain versions at the reference
   workload's shapes (784->100->10, batch 100, synthetic MNIST): the step
   kernel over three steps, the epoch kernel over one 550-step epoch in
   bf16 and in f32 staging, and the epoch kernel against 550 launches of
   the step kernel; each timed beside its plain version and its bound;
   then, from the probe builds, the split of an epoch step by phase for
   the PR-2 kernel and the current one, B1's launch overhead beside its
   step, and the barrier options: (a) the cooperative grid, (b) one
   thread-block cluster exchanging through distributed shared memory;
8. train the reference workload through ``launch.build_trainer``:
   100 epochs with ``compiled_run=True, engine="pallas"`` must print the
   reference's lines, launch the epoch kernel once per epoch with finite
   costs and reach the 0.72 test-accuracy oracle; then 2 epochs on the
   default plain path;
9. the port's bench (``distributed_tensorflow_tpu_torch.bench``) for the
   impls pallas-epoch, pallas (its step-kernel launches must equal its
   step count) and xla, each printing its JSON line; the xla impl (the
   plain path, about 1.2-1.6 s an epoch) times regions of 1 and 4
   dispatches (cut from 5 and 20);
10. serve gpt-m-L1024 on the paged pool (``block_size=16``, the default 512
    blocks, prefix caching on) with 16 requests (8 behind a shared
    256-token system prompt, 8 with repeated 8-token patterns, greedy and
    sampled mixed): (a) ``spec_draft=0`` on the paged megakernel, (b)
    ``spec_draft=4`` on the verify kernel, (c) ``spec_draft=0`` on the
    paged per-layer kernel; each must launch its kernel, hit the prefix
    cache and leave only the radix's blocks live, (b) must accept drafts,
    and every stream must equal the slab server's on the same prompts
    unless the pick at the first differing token is a near-tie: its top-2
    gap below the decode tolerance, or (sampled) a flip at the nucleus cut
    that the two servers' own logits at that token show (recorded from
    their samplers: the same draw, each sampler picking its own token on
    its own row, the rows within the decode tolerance, a token inside one
    nucleus and outside the other, and the server's token ranked before
    the reference's or first past its nucleus); after a near-tie both
    servers continue from the reference's tokens, so every token is
    compared;
11. the flash-attention backward kernels (fused ``flash_bwd_fused``, and
    the ``flash_bwd_dq`` + ``flash_bwd_dkv`` pair) against the plain
    backward at gpt-m training shapes (B=16, L=1024, 8 heads of 64, f32,
    causal) and at small shapes covering bf16, D=128, ``kv_lens``, GQA, a
    nonzero lse cotangent and a ragged last tile; the fused kernel against
    the pair; each timed beside its bound, the plain backward and, as a
    yardstick, the backward of ``scaled_dot_product_attention``; then the
    pair at the gpt-xl-L1024 attention shapes (B=16, L=1024, 16 heads of
    128);
12. train gpt-m-L1024-flash (bf16, batch 16, Adam 1e-3) through
    ``LMTrainer.run()``: (a) 3 epochs of 64 steps on a Markov corpus of
    1024-token sequences over 512 tokens, after the same batch's full-model gradients with
    flash attention are held against dense attention; the launches, ms per
    step, tokens/s and the held-out perplexity, which must fall every epoch
    and end below the training split's unigram perplexity; (b) the copy
    task at d=128 (2 heads of 64) through the fused backward and again with
    the dq-partial cap at 0 (the dq + dk/dv pair), each to the oracle of
    ``tests/test_lm_trainer.py``; (c) 12 steps of gpt-xl-L1024-flash-remat
    (batch 16, Adam 1e-3, bf16), whose backward must be the dq + dk/dv pair
    (4 launches each a step, the fused one never), the cost finite and
    falling;
13. serve gpt-m-L1024 with RoPE (``pos_embedding="rope"``, seeded random
    weights; 4 of its 8 layers, ``SERVED_LAYERS``) on bf16, int8 and fp8 KV
    caches, and the phase-4 model (4 layers) on an int8 cache, each through
    five servers: slab (B6), slab per-layer (B5),
    paged with the prefix cache (B6 paged), paged with ``spec_draft=4``
    (B7) and paged per-layer (B5 paged), phase 4's and phase 10's
    requests; each must launch its kernel (the launches of its variant),
    the paged ones hit the prefix cache, speculation accept drafts; every
    stream is held against ``decode_engine="xla"`` (the plain decode) at
    the same cache type under ``compare_streams``' rule; tokens/s and ms a
    step are printed, and the quantized caches' greedy divergence from the
    bf16 cache's streams beside the JAX package's budgets (a reading on
    random weights, not gated);
14. the single-sequence API on the RoPE model: 64 greedy tokens of 8 rows
    through ``prefill`` / ``decode_step`` on "fused" (B6) and
    "fused-layer" (B5) against "xla" under phase 5's rule, then
    ``greedy_decode`` on each engine; an f32 gpt-m model 16 tokens the
    same way (the f32 kernels at gpt-m width), and ``greedy_decode`` on
    "auto" through B6;
15. serve gpt-m-L1024-W256 (gpt-m-L1024 with ``window=256``, 4 of its 8
    layers; its slab is a rolling buffer of 256 rows, a quarter of the full
    slab's K/V bytes) on
    phase 4's traffic on bf16 and int8 caches, and its RoPE form on bf16,
    through phase 13's five servers, each held against
    ``decode_engine="xla"``; tokens/s, ms a step and TTFT printed;
16. train gpt-m-L1024-W256 through ``LMTrainer.run()`` on 12(a)'s corpus
    and batch for one epoch of 64 steps (cut: the step count): the
    launches must be B3, B4b and B4c (banded: 4 W <= L) and no B4a, the
    cost must fall; ms a step printed beside 12(a)'s; then 8 steps at
    W=512 (4 W > L), whose backward is B4a with the window;
17. serve the decode-* models of ``tools/lm_bench.py`` (d=256, 4 layers, 8
    heads of 32: head_dim 32): decode-full on bf16 and int8 caches,
    decode-window256 (the rolling slab of 256 rows) on both, decode-gqa2
    (2 KV heads) and decode-full with RoPE, on their traffic (8 prompts of
    256 tokens; 64 greedy tokens each, cut from 256) through phase 13's five servers,
    each held against ``decode_engine="xla"``; tokens/s, ms a step and
    TTFT printed. Then C1 end to end: ``TextServer`` over gpt-m with 2 KV
    heads at max_len 2048, paged, ``spec_draft=4``, 16 slots (the verify in
    two launches a tick), on prompts of 1,000-1,900 tokens against "xla",
    and a server of a model of head dim 256 refused at construction;
18. train gpt-s-L512-flash (batch 32) and gpt-s-L2048-flash-W512 (batch 8,
    banded) through ``LMTrainer.run()`` for 64 steps each on 12(a)'s
    corpus recipe at their lengths (cut: the steps): the launches must be
    B3 + B4a, then B3 + B4b + B4c, and the cost must fall; ms a step and
    tokens/s printed;
19. the rest of GPT training on one device. (a) gpt-xl-L1024 (``XL_CFG``,
    bf16, batch 16, 12(a)'s corpus at 1024 tokens): one step's gradients
    from one seeded parameter set under ``remat=True`` and
    ``remat="selective"`` must agree bit for bit (or, where B3 itself is
    shown not to repeat bit for bit, within GRAD_TOL); a step must launch
    B3 n times under "selective" and 2n under True, B4b and B4c n times
    and B4a never; each mode's step ms and peak memory printed, and
    ``remat=False``'s where it fits; then 12 steps through ``LMTrainer``
    with ``remat="selective"`` and the composed optimizer
    ``accumulate(clip(adamw(cosine schedule, warmup 2), 1.0), 2)``: the
    loss finite and falling. (b) the text path: a BPE vocabulary trained
    on ``synthetic_documents`` (pure Python), ``text_corpus`` at 512
    tokens, a gpt-m-width model (d=512, 4 layers, flash, bf16) trained 2
    epochs by ``LMTrainer.run()`` and by ``run_compiled()`` from the same
    seed: costs, perplexities and parameters equal bit for bit, the
    perplexity below the vocabulary size, a greedy continuation decoded.
    (c) the MNIST MLP ``Trainer``: one epoch with Adam, one through
    ``build_trainer`` with a cosine schedule, warmup, clipping and
    accumulation, each on ``engine="xla"`` with a falling cost; the fused
    engine (``engine="pallas"``) must refuse both before any launch;
20. the data-parallel modes (``torch.distributed``, ``parallel/``). (a) A
    world of one over NCCL (``parallel.mesh.init_world``): the MLP
    ``Trainer`` 1 epoch (cut from 2) on ``SyncDataParallel`` and on
    ``AsyncDataParallel(avg_every=50, update_scale=1)`` must equal
    ``SingleDevice`` bit for bit; a step's ms and an all-reduce's us
    printed. (c) B2's data-parallel composition
    (``ops.fused_mlp.make_fused_async_epoch_fn``) on 2 ranks of the card,
    started by ``tools/launch_local.launch``: one 550-step epoch at
    ``avg_every=50`` against the plain composition within phase 7's B2
    tolerance, 11 launches a rank an epoch, then 100 epochs at lr 0.002 a
    rank to the 0.72 oracle, an epoch's ms split into kernel and exchange.
    (b) The reference's topologies through the launcher, 2 workers + 1 ps,
    gloo over CUDA tensors, 784->100->10 at batch 100 a worker: sync with
    ``per_worker_epoch=True``, 14 epochs (cut from 100), its test accuracy
    at every epoch within 0.02 of phase 8's single-device run, and async
    with ``avg_every=50``, 75 epochs (cut from 100) to the 0.72 oracle (the
    sync run beside the others: cut), the
    reference's lines from the chief only, the ps tasks' two lines; and,
    beside the async run, ``examples/between_sync.py`` then
    ``between_async.py`` for one epoch.
    A task of these clusters is ``chip_smoke.py --dp-task sync|async|fused``
    (logs in ``chiprun_out/phase20/``);
21. the classifier families at the registry's default widths (bf16, batch
    100): the CNN, the LSTM and the transformer through ``DTF_MODEL`` and
    ``launch.build_trainer``, 300 steps each on the first 30,000 synthetic
    rows, no kernel launched; then the flash transformer
    (``attention_impl="flash", flash_min_len=0``: head_dim 16), whose
    launches must be B3 a step and an eval and B4a a step, and 100 steps
    with the fused backward's dq-partial cap at 0 (B4b + B4c); each run's
    cost falling, its test accuracy past ``CLASSIFIER_ORACLE`` and equal
    to ``Predictor.accuracy``'s, ms a step and examples/s printed; then B3,
    B4a, B4b and B4c at head_dim 16 at the classifier's attention shape
    (B=100, L=28, 4 heads, non-causal) in f32 and bf16 against their plain
    versions, timed (f32) beside SDPA's forward and backward and the bound;
22. f32 compute and the narrow head dims (ROADMAP A3.3): (a) decode-full
    in f32 (its prefill through B3 in f32) on f32, int8 and fp8 caches, and
    its window, GQA-2 and RoPE forms (a quarter of the new tokens), through
    phase 13's five servers, each stream held against ``"xla"`` under
    ``compare_streams``' rule; tokens/s, ms a step, TTFT, and the slab
    server's busy share (``profile_decode``); (b) the head-dim-8 model
    (the JAX engine's ``tiny()``) and a head-dim-16 one, in bf16 and f32,
    the same way; (c) GPTs at head dims 8 and 48 (padded to 64) trained
    with flash attention through the fused backward and the pair, whose
    launches and falling cost are checked.
23. MoE blocks and the quantized products (ROADMAP A5), and head dim 4:
    (a) gpt-m-L1024-flash with 8 experts, top-2, capacity factor 2.0,
    trained 2 x 16 steps on phase 12(a)'s corpus (B3 and B4 launched, cost
    and held-out perplexity falling; drop fraction and largest expert share
    printed, ms a step beside the dense one) and a top-1 epoch; (b) that
    model served (slab, pool) at a capacity factor that never drops, 8 of
    phase 4's requests: the engine resolves to "xla", B3 launches in the
    slab prefill, no decode kernel; greedy streams against the in-process
    ``greedy_decode``; (c) ``quantized_dot`` int8 (bit for bit) and fp8
    against its plain version at [16384 x 512] x [512 x 2048], timed beside
    the bf16 product, and gpt-m trained 16 steps (cut from 32) per matmul
    dtype, held-out
    perplexity within 15% of bf16's; (d) ``decode_matmul_dtype`` int8 and
    fp8 served on the slab and the pool, and int8 with an int8 cache and
    ``spec_draft=2``, streams against the in-process decode of
    ``decode_weights``; (e) B5, B6 and B7 at head dim 4 (the JAX engine's
    GQA model, 8 heads of 4 over 2 KV heads) in bf16 and f32 over every
    cache through phase 3's variant checks, timed, and that model served
    through phase 13's five servers against "xla".
24. Sequence-parallel GPT training (ROADMAP A7a): (a) B3, B4a, B4b and
    B4c with the ring offset at the hops' shapes (L_loc 1024, W 512,
    offset 1024: rows 511-1023 see no key; its GQA-2 form; L_loc 512,
    offset 512; f32 and bf16) against their plain versions, rows that see
    no key exactly 0, -1e30 and zero dq, timed beside the plain version,
    the band's bound and SDPA with the shifted band as a boolean mask
    (records ``<kernel>[offset...]``); (b) 2 ranks sharing the card
    (gloo, each hop staged through the host; ``--sp-task``) train
    gpt-s-L2048-flash-W512 (its past hops on the offset kernels),
    gpt-s-L2048-flash (diagonal, full and skipped hops) and
    gpt-s-L2048-flash-gqa2 under ``dp_mode="sp"`` on ring-flash, and one
    Ulysses step, through LMTrainer, each held to a single-device
    LMTrainer run of the same preset, seed and batches (every step's loss,
    the final parameters), each rank's hops and offset launches checked
    against its place on the ring; (c) ms a step over the ranks and on
    one device, the backend, and one hop's exchange.
25. Tensor parallelism (ROADMAP A7b): B3 and B4a at the local attention
    shape of (a) (B=16, L=512, 4 heads of 32, f32) against their plain
    versions and timed (records ``<kernel>[tp-4x32]``); then 4 ranks
    sharing the card (gloo, every collective staged through the host;
    ``--tp-task``): (a) gpt-s-L512-flash under LMTrainer(dp_mode="tp") on a
    (data 2, model 2) mesh, 4 steps; (b) gpt-s-L2048-flash-gqa2 at model 4
    (2 KV heads over 4 ranks: k and v gathered), 2 steps; (c)
    gpt-s-L2048-flash-W512 through make_lm_train_step(mesh, tp_axis,
    seq_axis) on (model 2, seq 2), 2 steps, the later sequence shard's
    ranks on the offset builds of B3/B4; (d) the MLP, CNN and LSTM under
    SyncDataParallel(param_specs=partition_specs()) on (2, 2), 24 SGD steps,
    each step held to one card's step from the same state (its cost, and
    its parameters by phase 24's rule on that step's movement). Each GPT
    run held to one card's run of the same preset, seed and batches
    (every step's loss, the final parameters by phase 24's rule), every
    rank's B3/B4 launches at its local head count, ms a step beside one
    card's, and one tp all-reduce's bytes and ms.
26. Expert and pipeline parallelism (ROADMAP A7c): B3 and B4a at the local
    attention shape of (a)-(c) (B=8, L=512, 8 heads of 32, f32) against
    their plain versions and timed (records ``<kernel>[ep-pp-8x512]``); then
    4 ranks sharing the card (gloo; ``--epp-task``) train gpt-s-L512-flash
    (batch 32) through LMTrainer: (a) with 4 experts, top-2, capacity factor
    2.0 under ``dp_mode="ep"`` on (expert 4), 4 steps; (b) 2 experts, top-1,
    on (data 2, expert 2), 2 steps; (c) ``dp_mode="pp"`` on (stage 4), 4
    microbatches, 4 steps; (d) on (data 2, stage 2) with ``remat=True``, 2
    steps. (a) and (b) hold each step to one card's step of the JAX ep
    semantics (the mean of the shards' ``model.loss``) from the same
    gathered state, every step's drop fraction 0 on every rank; (c) and (d)
    the whole run to one card's LMTrainer run (every step's loss, the final
    parameters by phase 24's rule). Every rank's B3/B4 launches against its
    schedule (layers a stage x the ticks it computes x steps, twice the
    forwards under remat), ms a step beside one card's, one all-to-all's
    and one pipeline hop's bytes and ms.
27. The LM's async and ZeRO modes and the DiLoCo outer loop (ROADMAP A7d):
    4 ranks sharing the card (gloo; ``--lsgd-task``) train gpt-s-L512-flash
    (batch 32, 8 rows a rank, bf16, 4 steps a run) through LMTrainer: (a)
    ``sync=False``, ``async_avg_every=1``, ``async_update_scale=1.0``, SGD,
    each step held to one card's step on the whole batch from the same
    state (phase 26's bounds); (b) ``async_avg_every=2`` at the default
    scale (4), AdamW: the copies differ after steps 1 and 3 and every rank
    holds the mean bit for bit after steps 2 and 4, exactly 2 parameter
    all-reduces, rank 0's first step bit for bit one card's on its 8 rows;
    (c) ``dp_mode="zero"`` against dp on the same ranks and batches, AdamW,
    parameters and slots bit for bit, each rank's bytes beside dp's; (d)
    ``dp_mode="diloco"`` (H=2, outer_lr 0.7, μ 0.9, int8 deltas, SGD) and (e)
    the same overlapped, each against the one-device gang
    (``diloco_workers=4``) run on the card on the same batches: θ, momentum
    (phase 24's rule) and the residual through what the gang owes (the
    momentum, or the delta in flight, plus the residual: phase 24's rule on
    its norm) and the residuals' norms. Every rank's B3/B4
    launches against the schedule (4 layers a step on its 8 rows; the
    records ``<kernel>[local-sgd-8x512]``, timed in phase 26 at the same
    shape), ms a step beside one card's dp step, one exchange all-reduce's
    ms and the delta's payload, dense and int8.

Phase 3 also holds the paged kernels (``decode_block_paged``,
``decode_token_paged``, ``verify_tokens_paged``) against their plain
versions at gpt-m shapes over scrambled block tables, the paged megakernel
against the slab one bit for bit on the same logical cache, two launches of
each cooperative kernel against each other bit for bit, and checks that
every pool byte outside the rows a launch may write is unchanged. The
verify kernel is held again at prefix 0 and prefixes under one block, by
its update and its committed rows, within limits that plain versions with
the suffix's causal block masked wrongly fail. It prints each cooperative
kernel's grid (CTAs, occupancy), grid syncs a launch and the time of a
sync at that grid on their own flag barrier, the decode wrapper's host
time, and a launch of the decode step, of the verify and of the per-layer
step at gpt-xl width split by phase (``coop_split``; from the probe build
``fused_decode_probe``, clock stamps). It holds one step through the
per-layer kernel layer by layer, with the commits, equal to one megakernel
launch bit for bit (slab and paged), and the per-layer kernel at gpt-xl
width against its plain version. Every kernel's ``ms`` is a call from
Python, as the path pays it; the per-layer kernel's launch replayed from a
CUDA graph is printed beside it (``graph_ms``: the device's share). For
each of ``VARIANTS`` (RoPE over bf16, int8 and fp8 caches; learned
positions over int8) it holds B5 slab/paged, B6 slab/paged and B7 against
their plain versions (h under REL_TOL, 1-byte codes within one step with
the share that differs printed and bounded, scales under REL_TOL), B5
layer by layer == B6 and paged == slab bit for bit, and times each beside
its plain version and its bound (1-byte codes plus a 4-byte scale a row);
the kernels line lists each as ``<kernel>[<variant>]``. The window
variants (``WINDOW_VARIANTS``: bf16, int8, RoPE bf16; W=256) run the same
checks over a rolling slab of 256 rows laid out from the same caches at
lengths 256..900 and over the absolute pool, paged == rolling slab bit for
bit on h and the committed rows. Phase 3 also holds B3 banded (W=256) at
S=8, L=1023 against its plain version, rows that see no key included, and
requires it to take less time than causal B3 there; phase 11 holds B4b
and B4c at W=256 and B4a at W=512 at the training shapes against the
plain backward with the same window, SDPA's backward with the band as a
boolean mask as the yardstick.

A3.3 (phases 3 and 11): each of ``F32_VARIANTS`` (f32 compute at
decode-full widths over f32, int8 and e4m3 caches, GQA-2, RoPE, the rolling
slab of 256) and of the narrow decode models (head dims 8 and 16, bf16 and
f32) through ``VARIANTS``' checks, the f32 ones at ``F32_DECODE_TOL`` over
an f32 cache, B6 in slot groups == one launch in f32; B3 (phase 3) and
B4a, B4b, B4c (phase 11) at head dim 8 and at the padded 48 in f32 and
bf16 at phase 22's training shapes, timed (f32) beside SDPA.

Head dim 32 and C1 (phases 3 and 11): B3 at D=32 (S=8, L=1023) against
its plain version, timed beside SDPA and D=64's B3; each of ``S_VARIANTS``
(gpt-s widths: bf16 and int8 caches, the rolling slab of 256 rows, 2 KV
heads, RoPE) through the same checks as ``VARIANTS``; the cooperative
kernels past one launch or one score tile (``c1_kernels``: B6 over 100
slots, grouped launches equal to one launch bit for bit, B7 over 16 slots
of gpt-m with 2 KV heads at extent 2048, B7 at L=9, B6 with one KV head at
lengths 6,000-8,000, and blocks against one block at the same lengths);
phase 11 holds B4a at gpt-s-L512's shapes and B4b + B4c at
gpt-s-L2048-W512's against the plain backward, SDPA's backward beside.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.

``--kernel-times`` runs no phase: it times the decode kernels (B5 slab
and paged at gpt-m and at gpt-xl width, B6 slab and paged and B7 over 8
gpt-m layers, and at gpt-m each of ``VARIANTS`` and the window
variants), the backward kernels (B4b at the gpt-m and gpt-xl-L1024
training shapes, B4c and B4a at gpt-m) and B3 at S=8, L=1023 (causal, and
banded) through their
public wrappers, a call from Python each as above,
and prints one JSON line with the card's name and power limit.
``--root DIR`` takes the package from another checkout (an unpacked
``git archive`` of an earlier commit has the same wrappers), so two
commits are compared with one definition of each time: run both, in
turns, in one run on one card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 and TF32
# tensor-core and f32 CUDA-core FLOP/s. The tensor-core flash kernels (B3,
# B4a, B4c) run each f32 product as three TF32 MMAs (split-TF32), so their
# f32 FLOPs are bound by a third of the TF32 peak; the f32 CUDA-core figure
# is printed beside it for the earlier, CUDA-core versions.
HBM_BPS = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_SPLIT_TF32 = PEAK_TF32 / 3
PEAK_F32 = 67e12
# The kernels that run on the tensor cores: their builds must show MMA
# instructions (phase 2). coop_step_kernel: the per-layer decode step (B5),
# the whole-model step (B6), slab and paged, and the verify (B7); q_kernel:
# dq alone (B4b).
# Each library's instantiations: every head dim (8 to 128; the narrow ones'
# kernels named *_narrow), f32 and bf16, with and without the window;
# fused_decode_f32 is the cooperative kernels in f32 compute.
TENSOR_CORE_KERNELS = {"flash_fwd": ("flash_fwd_kernel",),
                       "flash_bwd": ("kv_kernel", "q_kernel"),
                       "fused_decode": ("coop_step_kernel",),
                       "fused_decode_f32": ("coop_step_kernel",)}
# Builds (sources and probe modules) whose named kernels must not spill
# registers (phase 2): the tensor-core kernels (the cooperative decode
# kernels among them) and the MLP kernels.
NO_SPILL_KERNELS = {**TENSOR_CORE_KERNELS, "fused_mlp": ("mlp_",),
                    "fused_mlp_probe": ("mlp_", "probe_")}

SERVE_CFG = dict(
    vocab_size=8192, model_dim=512, num_layers=8, num_heads=8, max_len=1024,
    attention_impl="flash", flash_min_len=0,
)
# gpt-xl-L1024-flash-remat (distributed_tensorflow_tpu/tools/lm_bench.py
# :111-117, vocab 8192 at :126): d=2048, 4 layers, 16 heads of 128, F=8192.
# Its widths are the only fused decode wider than d=1024 (phases 3 and 5)
# and its attention backward takes the dq + dk/dv pair (phases 11, 12(c)).
XL_CFG = dict(vocab_size=8192, model_dim=2048, num_layers=4, num_heads=16, max_len=1024,
              attention_impl="flash")
PROMPT_LENS = (12, 30, 60, 100, 200, 300, 450, 600, 800, 900, 25, 700)
# New tokens a request in phases 4, 5, 10, 13 and 15 (cut from 96 to keep
# the smoke inside its time limit: each of those phases serves the same
# traffic again on the plain decode and on every continuation after a near
# tie).
MAX_NEW = 48

# Tolerances of kernel vs plain version, as multiples of the reference's
# largest magnitude. flash: f32 in, f32 math, sums in another order.
# decode: bf16 weights and caches, f32 accumulation in another order; an
# intermediate rounded to bf16 (layernormed rows, attention output,
# gelu(up), softmax weights, the fresh K/V rows) can land one bf16 ulp
# (2^-8 relative) apart, which then propagates through later products.
# fused MLP costs: f32 throughout, sums in another order (logits shares
# summed per CTA, products per warp): a few steps agree to ~1e-6, and 550
# steps accumulate that rounding.
# verify: as decode (the same rounding points; its softmax weights stay
# f32 and its products take five rows per weight read).
REL_TOL = {"flash_fwd": 1e-5, "flash_bwd_fused": 1e-5, "flash_bwd_dq": 1e-5,
           "flash_bwd_dkv": 1e-5, "decode_block_slab": 2e-2, "decode_token_slab": 2e-2,
           "decode_block_paged": 2e-2, "decode_token_paged": 2e-2,
           "verify_tokens_paged": 2e-2, "fused_mlp_step": 1e-5, "fused_mlp_epoch": 1e-3}
# fused MLP parameters are held by their UPDATE (state - start), since
# lr=0.001 moves N(0,1) weights by ~1e-4 in 3 steps and ~1e-2 in an epoch.
# Per tensor: error <= share * max|update| + ulps * ulp(max|parameter|).
# The ulp term is the f32 rounding of w - lr*dw, which may land one ulp
# apart at each step; the share term is the update's own rounding (sums in
# another order agree to ~1e-6 of it). On an H100 the kernels land within
# 1 ulp and 6e-5 of the update; a step update off by 1% (one example of
# 100 dropped, a wrong lr scaling) misses these limits.
UPDATE_TOL = {"fused_mlp_step": (1e-3, 6), "fused_mlp_epoch": (2e-3, 32)}
# flash backward kernels: f32 as REL_TOL (sums in another order); bf16
# outputs round to bf16 (2^-8 relative) and p / ds may land on the
# neighbouring bf16 value before their products.
BWD_BF16_TOL = 1e-2
# Phase 12(a): full-model gradients, flash vs dense attention, per leaf
# against its largest magnitude. The attention math is f32 in both, in
# another order; the products' cotangents round to bf16 at each cast of a
# bf16 model, so a sum that lands on the neighbouring bf16 value (2^-8
# relative) moves a gradient by that much and propagates through the layers.
GRAD_TOL = 3e-2
TRAIN_CFG = dict(epochs=3, batch_size=16, optimizer="adam", learning_rate=1e-3,
                 log_frequency=16)
# A peaky chain (concentration 0.05, against the corpus default 0.25): at
# 0.25 the JAX reference and the port alike stay at the unigram perplexity
# for hundreds of steps (PERF.md, GPT training findings), so the oracle
# could not show that the step trains. On a first-order chain the next
# token depends on the current one only, which is each position's own
# input: the embeddings and MLPs reach below the unigram perplexity
# without attention. The oracle shows that the step trains, not that
# attention learns; the flash-vs-dense gradients (full width) and the
# copy task of phase 12(b) check the attention backward.
TRAIN_CORPUS = dict(num=1536, seq_len=1024, vocab=512, concentration=0.05, n_val=256,
                    n_test=256, seed=0)
TRAIN_EVAL_BATCH = 32
XL_TRAIN_STEPS = 12  # phase 12(c)
COPY_CFG = dict(vocab_size=61, max_len=16, model_dim=128, num_heads=2, num_layers=2,
                attention_impl="flash", flash_min_len=0)
COPY_CORPUS = dict(num=768, half_len=8, vocab=61, n_val=128, n_test=128, seed=0)

SOURCES = {
    "flash_fwd": ("distributed_tensorflow_tpu_torch/ops/csrc/flash_fwd.cu",
                  "distributed_tensorflow_tpu/ops/pallas_attention.py:208"),
    "flash_bwd_fused": ("distributed_tensorflow_tpu_torch/ops/csrc/flash_bwd.cu",
                        "distributed_tensorflow_tpu/ops/pallas_attention.py:440"),
    "flash_bwd_dq": ("distributed_tensorflow_tpu_torch/ops/csrc/flash_bwd.cu",
                     "distributed_tensorflow_tpu/ops/pallas_attention.py:327"),
    "flash_bwd_dkv": ("distributed_tensorflow_tpu_torch/ops/csrc/flash_bwd.cu",
                      "distributed_tensorflow_tpu/ops/pallas_attention.py:381"),
    "decode_block_slab": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_decode.cu",
                          "distributed_tensorflow_tpu/ops/pallas_decode.py:181"),
    "decode_token_slab": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_decode.cu",
                          "distributed_tensorflow_tpu/ops/pallas_decode.py:618"),
    "decode_block_paged": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_decode.cu",
                           "distributed_tensorflow_tpu/ops/pallas_decode.py:181"),
    "decode_token_paged": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_decode.cu",
                           "distributed_tensorflow_tpu/ops/pallas_decode.py:618"),
    "verify_tokens_paged": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_decode.cu",
                            "distributed_tensorflow_tpu/ops/pallas_decode.py:1083"),
    "fused_mlp_step": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_mlp.cu",
                       "distributed_tensorflow_tpu/ops/pallas_mlp.py:69"),
    "fused_mlp_epoch": ("distributed_tensorflow_tpu_torch/ops/csrc/fused_mlp.cu",
                        "distributed_tensorflow_tpu/ops/pallas_mlp.py:181"),
}
DECODE_KERNELS = ("decode_block_slab", "decode_block_paged", "decode_token_slab",
                  "decode_token_paged", "verify_tokens_paged")
PATHS = {"decode_block_slab": "fused-layer", "fused_mlp_step": "mlp-step",
         "fused_mlp_epoch": "mlp-train", "decode_token_paged": "paged",
         "verify_tokens_paged": "paged-spec", "decode_block_paged": "paged-fused-layer",
         "flash_bwd_fused": "lm-train", "flash_bwd_dq": "lm-train-xl",
         "flash_bwd_dkv": "lm-train-xl"}
BLOCK = 16  # the paged pool's block size (phases 3 and 10)
# The decode kernels' variants held in phase 3 and served in phase 13:
# (label, RoPE, KV cache type).
VARIANTS = (("rope-bf16", True, "bf16"), ("rope-int8", True, "int8"),
            ("rope-fp8", True, "fp8"), ("learned-int8", False, "int8"))
# The sliding-window configuration gpt-m-L1024-W256 (phases 3, 11, 15, 16):
# gpt-m-L1024 with the window of tools/lm_bench.py's decode-window256
# (:137-143). Its slab is a rolling buffer of WINDOW rows; 4 W <= L puts its
# training in the banded regime (the dq + dk/dv pair).
WINDOW = 256
# Phases 13 and 15 serve their gpt-m models at 4 of the 8 layers (cut: the
# depth, which keeps the run near half its time limit since phases 17 and
# 18 came; phase 3 holds the kernels of each variant at all 8 layers).
SERVED_LAYERS = 4
WIN_CFG = dict(SERVE_CFG, window=WINDOW, num_layers=SERVED_LAYERS)
# The decode kernels' window variants held in phase 3 and served in phase
# 15: (label, RoPE, KV cache type).
WINDOW_VARIANTS = (("window-bf16", False, "bf16"), ("window-int8", False, "int8"),
                   ("window-rope-bf16", True, "bf16"))
# The flash kernels' window variants: record name -> (kernel, window, path).
# B3 at the serving shapes (phase 3), B4b/B4c banded at W=256 and B4a at
# W=512 (4 W > L: the fused backward) at the training shapes (phase 11).
FLASH_WINDOWS = {"flash_fwd[window]": ("flash_fwd", WINDOW, "window serve+train"),
                 "flash_bwd_dq[window]": ("flash_bwd_dq", WINDOW, "window-train"),
                 "flash_bwd_dkv[window]": ("flash_bwd_dkv", WINDOW, "window-train"),
                 "flash_bwd_fused[window-512]": ("flash_bwd_fused", 2 * WINDOW,
                                                 "window-512-train")}
# The gpt-s and decode-* models of tools/lm_bench.py (:50-89, :133-160;
# vocab 8192 at :126): d=256, 4 layers, 8 heads of 32 (F=1024), bf16.
S_CFG = dict(vocab_size=8192, model_dim=256, num_layers=4, num_heads=8, max_len=1024)
# Phase 17 serves decode-full (:133-136), decode-window256 (:137-143),
# decode-gqa2 (:144-150) and decode-full with RoPE: (label, knobs, cache
# types). Their prefill is lm_bench's (dense attention).
S_SERVE = (("s-full", {}, ("bf16", "int8")), ("s-window", {"window": 256}, ("bf16", "int8")),
           ("s-gqa2", {"num_kv_heads": 2}, ("bf16",)),
           ("s-rope", {"pos_embedding": "rope"}, ("bf16",)))
# Their traffic (DECODE_CONFIGS): 8 requests of 256-token prompts, 256 new
# tokens each, greedy. Phase 17 serves S_SERVED_NEW of them (cut: the new
# tokens, 256 -> 128, since phase 20 came; past the window's 256 all the
# same); phase 3 holds the kernels over the whole S_MAX_NEW. Phase 17
# serves S_PHASE17_NEW (cut: 128 -> 64, past the window's 256 all the same).
S_REQUESTS, S_PROMPT, S_MAX_NEW = 8, 256, 256
S_SERVED_NEW = 128
S_PHASE17_NEW = 64
# The decode kernels' head-dim-32 variants held in phase 3 at gpt-s widths
# and served in phase 17: (label, RoPE, KV cache type, KV heads, window).
S_VARIANTS = (("s-full-bf16", False, "bf16", 8, None), ("s-full-int8", False, "int8", 8, None),
              ("s-window-bf16", False, "bf16", 8, 256), ("s-window-int8", False, "int8", 8, 256),
              ("s-gqa2-bf16", False, "bf16", 2, None), ("s-rope-bf16", True, "bf16", 8, None))
# The flash kernels' head-dim-32 variants: record -> (kernel, path). B3 at
# the serving shapes (phase 3), B4a at gpt-s-L512-flash's and B4b + B4c at
# gpt-s-L2048-flash-W512's training shapes (phase 11), launched by phase 18.
FLASH_D32 = {"flash_fwd[d32]": ("flash_fwd", "gpt-s train"),
             "flash_bwd_fused[d32]": ("flash_bwd_fused", "gpt-s-L512 train"),
             "flash_bwd_dq[d32-window]": ("flash_bwd_dq", "gpt-s-L2048-W512 train"),
             "flash_bwd_dkv[d32-window]": ("flash_bwd_dkv", "gpt-s-L2048-W512 train")}
# The flash kernels at gpt-xl-L1024's attention shapes (B=16, L=1024, 16
# heads of 128, f32, causal; timed in phase 11), launched by phase 19(a)'s
# selective-remat training: record -> (kernel, path).
FLASH_XL_SELECTIVE = {"flash_fwd[xl-selective]": ("flash_fwd", "lm-train-xl-selective"),
                      "flash_bwd_dq[xl-selective]": ("flash_bwd_dq", "lm-train-xl-selective"),
                      "flash_bwd_dkv[xl-selective]": ("flash_bwd_dkv",
                                                      "lm-train-xl-selective")}
# Phase 18: (config, L, batch, window) of tools/lm_bench.py :57-63 and
# :76-82, trained S_TRAIN_STEPS steps each (cut: the steps).
S_TRAIN = (("gpt-s-L512-flash", 512, 32, None), ("gpt-s-L2048-flash-W512", 2048, 8, 512))
S_TRAIN_STEPS = 64
# Phase 22 and A3.3's variants. The f32 decode kernels held in phase 3
# at decode-full widths and served in phase 22: (label, RoPE, KV cache type,
# KV heads, window); a "bf16" cache is the f32 model's own layout (f32),
# shown as "f32" in the labels.
F32_VARIANTS = (("f32-full-f32", False, "bf16", 8, None), ("f32-full-int8", False, "int8", 8, None),
                ("f32-full-fp8", False, "fp8", 8, None), ("f32-window-f32", False, "bf16", 8, 256),
                ("f32-gqa2-f32", False, "bf16", 2, None), ("f32-rope-f32", True, "bf16", 8, None))
# Phase 22's f32 models (S_CFG in f32): (label, knobs, cache types, new
# tokens). decode-full takes the slab, the pool and the verify on each cache
# type over S_SERVED_NEW tokens, with its prefill through B3 (flash, D=32 in
# f32); the window, GQA-2 and RoPE forms their dense prefill and a quarter
# of the tokens (cut: the new tokens, to keep the phase near a minute).
F32_SERVE = (("f32-full", dict(attention_impl="flash", flash_min_len=0), ("bf16", "int8", "fp8"),
              S_SERVED_NEW),
             ("f32-window", {"window": 256}, ("bf16",), S_SERVED_NEW // 4),
             ("f32-gqa2", {"num_kv_heads": 2}, ("bf16",), S_SERVED_NEW // 4),
             ("f32-rope", {"pos_embedding": "rope"}, ("bf16",), S_SERVED_NEW // 4))
# Tolerance of the f32 decode kernels over an f32 cache against their plain
# versions (of the largest magnitude): split-TF32 products land within ~1e-6
# of f32 ones, and the sums run in another order.
F32_DECODE_TOL = 1e-4
# Head dims 8 and 16 on the decode kernels: the JAX engine's test model
# (tests/test_pallas_decode.py:39-47 tiny(): d=32, 4 heads of 8, RoPE) and
# d=64 over 4 heads, 2 layers, max_len 64, vocab 97, each in bf16 and f32:
# (label, model knobs). Phase 3 holds them at 8 slots over lengths
# NARROW_PROMPT..NARROW_PROMPT + NARROW_NEW of a cache of 64; phase 22
# serves 8 prompts of NARROW_PROMPT tokens, NARROW_NEW new tokens each.
NARROW_CFG = dict(vocab_size=97, max_len=64, num_layers=2)
NARROW_MODELS = (("d8", dict(model_dim=32, num_heads=4, pos_embedding="rope")),
                 ("d16", dict(model_dim=64, num_heads=4)))
NARROW_PROMPT, NARROW_NEW = 24, 24
# The flash kernels at head dim 8 and at a padded head dim (48, on the D=64
# kernels), held at the training shapes of phase 22's GPTs (B=16, L=256,
# f32, causal; d=32 over 4 heads, d=96 over 2) in phases 3 and 11 and
# launched by their training: record -> (kernel, path).
FLASH_NARROW_TRAIN = (("d8", dict(model_dim=32, num_heads=4)),
                      ("d48", dict(model_dim=96, num_heads=2)))
FLASH_NARROW_SHAPE = (16, 256)  # batch, length
FLASH_NARROW_STEPS = 32
FLASH_NARROW = {f"{k}[{lab}]": (k, f"gpt {lab} train" + (", flash_fused=False" if k in (
    "flash_bwd_dq", "flash_bwd_dkv") else ""))
    for lab, _ in FLASH_NARROW_TRAIN
    for k in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")}
# C1 (phases 3 and 17): gpt-m with 2 KV heads at max_len 2048, served paged
# with spec_draft=4 over 16 slots (80 verify rows: two launches a tick).
C1_CFG = dict(SERVE_CFG, num_kv_heads=2, max_len=2048)
C1_SLOTS, C1_DRAFT = 16, 4
# Share of a 1-byte cache's codes that may differ from the plain version's
# (phase 3): the kernel's f32 rows differ from the plain ones in the last
# bits (sums in another order), so a value at a rounding midpoint of the
# quantizer may land on the neighbouring code; any other fault moves far
# more codes.
CODE_SHARE = 0.01
# Layers >= 1 of a launch over every layer (B6, B7) against the plain
# version's chain: that chain's residual rows differ from the kernel's by
# the sums' order, so per layer a larger share of the written codes moves
# a step (``later_layers_check``). Set from the readings in PERF.md
# section 6.
LATER_CODE_SHARE = {"int8": 0.14, "fp8": 0.10}
LATER_VALUE_TOL = 5e-3
# Verify at short prefixes (phase 3), per slot: prefix 0 and prefixes under
# one block, suffix lengths 1..5; held by the update and the committed rows
# of layers >= 1, within this share of the plain version's largest.
VERIFY_SHORT_PLENS = (0, 0, 1, 3, 7, 12, 15, 0)
VERIFY_SHORT_SLENS = (5, 1, 5, 4, 5, 3, 2, 5)
VERIFY_SHORT_TOL = 2e-2
# A --kernel-times decode timing: the median of AB_BATCHES means of 20
# calls (a B5 call is host-bound, and the host's other work inflates a
# batch now and then).
AB_BATCHES = 5
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


def ab_ms(fn) -> float:
    """The median of ``AB_BATCHES`` :func:`cuda_ms` batches of 20 calls
    (``--kernel-times``)."""
    return float(np.median([cuda_ms(fn, 20, 3 if i == 0 else 0) for i in range(AB_BATCHES)]))


def graph_ms(fn, iters=20, reps=5) -> float:
    """Mean device time of ``fn``'s launches: ``iters`` calls captured in
    one CUDA graph on a side stream (after two eager calls there, so the
    stream's barrier flags and launch records exist), replayed ``reps``
    times between CUDA events. Unlike :func:`cuda_ms` this leaves out the
    host's time a call, which exceeds a short kernel's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (iters * reps)


def host_us(fn, iters=300, warmup=20) -> float:
    """Mean host-clock time of ``fn`` in us over ``iters`` calls, with no
    wait for the card inside the run (its queue absorbs what the host
    issues faster than the card runs it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


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


def check_error(name, err, ref_scale, rel=None):
    tol = (REL_TOL[name] if rel is None else rel) * max(1.0, ref_scale)
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
        **split_tf32_bound(nbytes, flops),
    )
    print(f"  flash_fwd bound at the f32 CUDA cores: "
          f"{bound(nbytes, flops, PEAK_F32)['bound_ms']:.4f} ms")
    flash_window(records, q, k, v, lens, allowed, nbytes)

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

    o7, k7, v7, _, _ = fd.decode_block_slab(h, w0, ck[0], cv[0], lengths, **kw)
    r7, rk7, rv7, _, _ = fd.decode_block_slab_plain(h, w0, ck[0], cv[0], lengths, **kw)
    torch.cuda.synchronize()
    err = max((o7 - r7).abs().max().item(), (k7.float() - rk7.float()).abs().max().item(),
              (v7.float() - rv7.float()).abs().max().item())
    check_error("decode_block_slab", err, r7.abs().max().item())
    call = lambda: fd.decode_block_slab(h, w0, ck[0], cv[0], lengths, **kw)  # noqa: E731
    records["decode_block_slab"] = dict(
        max_abs_err=err, ms=cuda_ms(call), graph_ms=graph_ms(call),
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
    check_repeat("decode_token_slab", (o8, ck8, cv8), lambda k, v: fd.decode_token_slab(
        h, w, k, v, lengths, active, **kw)[0], ck, cv)
    check_layer_by_layer("decode_block_slab", (o8, ck8, cv8), h, w, (ck, cv), None, lengths,
                         active, kw)
    records["decode_token_slab"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fd.decode_token_slab(h, w, ck8, cv8, lengths, active, **kw)),
        plain_ms=cuda_ms(lambda: fd.decode_token_slab_plain(h, w, ck8, cv8, lengths, active, **kw), 5),
        library_ms=None,
        **bound(n * (wbytes_layer + 2 * kv_elems * 2 + 2 * S * H * Dh * 2) + 2 * S * d * 4,
                n * (mat_flops_layer + attn_flops_layer), PEAK_BF16),
    )
    phase_paged_kernels(records, w, ck, cv, lengths, active, h, o7)
    coop_grids(S, n, d, H, Dh, Fw, C)
    host = host_us(lambda: fd.decode_token_slab(h, w, ck8, cv8, lengths, active, **kw))
    print(f"  decode_token_slab: host time of a call {host:.1f} us")
    grid = fd.launch_plan("decode_token_slab", S, 1, n, d, H, H, Dh, Fw, C, 0, dev).grid
    coop_split("decode_token_slab", lambda: fd.decode_token_slab(
        h, w, ck8, cv8, lengths, active, **kw), n, grid)
    block_kernels_at_xl(records)
    for variant in VARIANTS:
        kernel_variants(records, variant, w, ck, cv, lengths, active, h)
    # The window variants: the rolling slab (C = WINDOW) and the windowed
    # pool (absolute) at lengths that wrap the slab.
    wlengths = torch.randint(WINDOW, 901, (S,), device=dev, generator=g, dtype=torch.int32)
    for variant in WINDOW_VARIANTS:
        kernel_variants(records, variant, w, ck, cv, wlengths, active, h)
    flash_d32(records)
    s_kernels(records)
    f32_kernels(records)
    narrow_kernels(records)
    flash_narrow_fwd(records)
    c1_kernels(records)
    for name, r in records.items():
        call = (f" a call from Python ({r['graph_ms']:.4f} ms a launch replayed from a CUDA "
                f"graph)" if "graph_ms" in r else "")
        print(f"  {name}: kernel {r['ms']:.4f} ms{call}, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def flash_window(records, q, k, v, lens, allowed, nbytes):
    """B3 with the band of ``WINDOW`` at the serving shapes of causal B3
    (``q``/``k``/``v`` [S, 1023, 8, 64] f32, ``lens`` 513..1023, so rows past
    kv_lens + W - 1 see no key): against its plain version, then timed
    beside causal B3 and SDPA with the band as a boolean mask. The band's
    (q, k) pairs set the bound; it must take less time than causal B3 (the
    kernel visits only the band's tiles)."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_attention_with_lse,
    )

    S, L, H, Dh = q.shape
    kw = dict(causal=True, window=WINDOW, kv_lens=lens)
    out, lse = flash_attention_with_lse(q, k, v, **kw)
    ref, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
    check_error("flash_fwd", err, ref.abs().max().item())
    pos = torch.arange(L, device=q.device)
    band = allowed & (pos[None, :, None] - pos[None, None, :] < WINDOW)
    pairs = int(band.sum().item())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = band[:, None]
    records["flash_fwd[window]"] = r = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: flash_attention_with_lse(q, k, v, **kw)),
        plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
        **split_tf32_bound(nbytes, 4 * Dh * H * pairs),
    )
    causal = records["flash_fwd"]
    print(f"  flash_fwd[window] (W={WINDOW}, {pairs} pairs, "
          f"{pairs / int(allowed.sum().item()):.3f} of causal's): kernel {r['ms']:.4f} ms "
          f"against causal B3's {causal['ms']:.4f} ms at the same shapes; SDPA with the band "
          f"mask {r['library_ms']:.4f} ms (causal mask {causal['library_ms']:.4f}); plain "
          f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    if not r["ms"] < causal["ms"]:
        raise AssertionError("banded B3 is not faster than causal B3: the band's tiles are "
                             "not skipped")


def block_kernels_at_xl(records):
    """B5 (slab and paged) at gpt-xl width (``XL_CFG``: d=2048, 16 heads of
    128, F=8192), 8 slots, cache lengths 256..768 of 1024 (paged: blocks of
    16 under scrambled tables): against the plain version at REL_TOL, then
    timed beside the plain version and the bound. Stored under each
    record's ``gpt_xl``."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    S, C = 8, 1024
    d, H, Fw = XL_CFG["model_dim"], XL_CFG["num_heads"], 4 * XL_CFG["model_dim"]
    Dh = d // H

    def rw(*shape, scale):
        return torch.randn(shape, device=dev, generator=g) * scale

    w = {"ln1_scale": 1 + rw(d, scale=0.1), "ln1_bias": rw(d, scale=0.05),
         "ln2_scale": 1 + rw(d, scale=0.1), "ln2_bias": rw(d, scale=0.05),
         "b_up": rw(Fw, scale=0.05), "b_down": rw(d, scale=0.05)}
    for nm, (k, n) in dict(wq=(d, d), wk=(d, d), wv=(d, d), wo=(d, d), w_up=(d, Fw),
                           w_down=(Fw, d)).items():
        w[nm] = rw(k, n, scale=k ** -0.5).bfloat16()
    ck = rw(1, S, C, H, Dh, scale=1.0).bfloat16()
    cv = rw(1, S, C, H, Dh, scale=1.0).bfloat16()
    lengths = torch.randint(256, 769, (S,), device=dev, generator=g, dtype=torch.int32)
    h = rw(S, d, scale=1.0)
    mb = C // BLOCK
    tables = torch.randperm(S * mb, device=dev, generator=g).reshape(S, mb).int()
    pk, pv = pool_from_slab(ck, tables, S * mb)[0], pool_from_slab(cv, tables, S * mb)[0]
    kw = dict(num_heads=H, compute_dtype=torch.bfloat16)
    wbytes = sum(t.numel() * t.element_size() for t in w.values())
    kv_elems = int(lengths.sum().item()) * H * Dh
    flops = 2 * S * sum(w[nm].numel() for nm in fd.PROJ_NAMES) + 4 * (
        int(lengths.sum().item()) + S) * H * Dh
    calls = {
        "decode_block_slab": (lambda: fd.decode_block_slab(h, w, ck[0], cv[0], lengths, **kw),
                              lambda: fd.decode_block_slab_plain(h, w, ck[0], cv[0], lengths,
                                                                 **kw), 0),
        "decode_block_paged": (lambda: fd.decode_block_paged(h, w, pk, pv, tables, lengths, **kw),
                               lambda: fd.decode_block_paged_plain(h, w, pk, pv, tables,
                                                                   lengths, **kw),
                               4 * tables.numel()),
    }
    for name, (call, plain, extra) in calls.items():
        got, ref = call()[:3], plain()[:3]
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        check_error(name, err, ref[0].abs().max().item())
        r = dict(max_abs_err=err, ms=cuda_ms(call), graph_ms=graph_ms(call),
                 plain_ms=cuda_ms(plain, 5),
                 **bound(wbytes + 2 * kv_elems * 2 + 2 * S * d * 4 + 2 * S * H * Dh * 2 + extra,
                         flops, PEAK_BF16))
        records[name]["gpt_xl"] = r
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        print(f"  {name} at gpt-xl width (d={d}, {H}x{Dh}, F={Fw}, S={S}, cache 256-768): "
              f"kernel {r['ms']:.4f} ms a call from Python ({r['graph_ms']:.4f} ms a launch "
              f"replayed from a CUDA graph), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {wbytes / 1e6:.1f} MB of weights")
    p = fd.launch_plan("decode_block_slab", S, 1, 1, d, H, H, Dh, Fw, C, 0, dev)
    print(f"  decode_block_slab at gpt-xl width: grid {p.grid}, weight ring {p.layout['wslots']} x "
          f"{p.layout['wslot']} bytes, chunk rows {[q.k_rows for q in p.products]}, tiles a CTA "
          f"{[(q.tiles_per_cta, q.tile_cols) for q in p.products]} (count, columns), "
          f"{p.smem} bytes of shared memory")
    coop_split("decode_block_slab at gpt-xl width", calls["decode_block_slab"][0], 1, p.grid)


def check_layer_by_layer(name, mega, h, w, caches, tables, lengths, active, kw, rel=None):
    """One step through the per-layer kernel (B5) layer by layer, each
    layer's fresh rows committed as the model commits them, equal to the
    megakernel's ``mega`` = (h_out, k, v[, k_scale, v_scale]) bit for bit
    (h_out and every committed row and scale), from the caches ``caches``
    = (k, v[, k_scale, v_scale]) the megakernel started from: the two run
    the same cooperative body, whose sums' order depends only on the rows
    and K. Each layer's launch is also held against the plain version on
    the same inputs (:func:`own_rows_check`; scales within REL_TOL), so
    every layer of the megakernel is held on its own rows. ``rel``: the
    tolerance in place of REL_TOL's (the f32 variants')."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.ops.quantized import movable

    base = "decode_block_slab" if tables is None else "decode_block_paged"
    k, v, ks, vs = (*(t.clone() for t in caches), None, None)[:4]
    err = steps = ndiff = over = 0
    for i in range(k.shape[0]):
        wi = {k_: t[i] for k_, t in w.items()}
        sc = dict(k_scale=None if ks is None else ks[i], v_scale=None if vs is None else vs[i])
        view = (k[i], v[i]) if tables is None else (k[i], v[i], tables)
        step = fd.decode_block_slab if tables is None else fd.decode_block_paged
        plain = fd.decode_block_slab_plain if tables is None else fd.decode_block_paged_plain
        ref = plain(h, wi, *view, lengths, **kw, **sc)
        h, kq, vq, kqs, vqs = step(h, wi, *view, lengths, **kw, **sc)
        torch.cuda.synchronize()
        e = (h - ref[0]).abs().max().item() / max(1.0, ref[0].abs().max().item())
        if ks is None:
            e = max(e, *((a.float() - b.float()).abs().max().item()
                         / max(1.0, ref[0].abs().max().item()) for a, b in zip((kq, vq), ref[1:3])))
        else:
            for a, a_s, b, b_s in ((kq, kqs, ref[1], ref[3]), (vq, vqs, ref[2], ref[4])):
                st, nd, ov = code_gap(a, a_s, b, b_s)
                steps, ndiff, over = max(steps, st), max(ndiff, nd), max(over, ov)
            for a, b in zip((kqs, vqs), ref[3:]):
                scales_check(f"{name} layer {i}", a, b, base, rel)
        err = max(err, e)
        if tables is None:
            fd.commit_slot_rows(k[i], v[i], kq, vq, lengths, active, sc["k_scale"],
                                sc["v_scale"], kqs, vqs, kw.get("window"))
        else:
            fd.commit_paged_rows(k[i], v[i], kq, vq, tables, lengths, active, sc["k_scale"],
                                 sc["v_scale"], kqs, vqs)
    torch.cuda.synchronize()
    own_rows_check(name, base, err, steps, ndiff / kq.numel(), over, ks is not None, rel)
    same = [torch.equal(movable(a), movable(b)) for a, b in zip((h, k, v, ks, vs), mega)]
    if not all(same):
        err = (h - mega[0]).abs().max().item()
        raise AssertionError(f"{name} layer by layer differs from the megakernel: h_out, k, v "
                             f"equal {same}, h_out err {err}")
    print(f"  {name} layer by layer with the commits == the megakernel bitwise (h_out and "
          f"the committed rows{' and scales' if ks is not None else ''} of {k.shape[0]} "
          f"layers)")


def verify_layer_by_layer(name, mega, hv, w, pools, tables, plens, slens, active, kw,
                          rel=None):
    """The verify kernel (B7) one layer a launch, each launch held against
    the plain version on the same inputs (:func:`own_rows_check`; scales
    within REL_TOL), the chain equal to the launch over every layer
    ``mega`` = (h_out, k, v[, k_scale, v_scale]) bit for bit: so every
    layer of that launch is held on its own rows."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.ops.quantized import movable

    base = "verify_tokens_paged"
    cs = (*(t.clone() for t in pools), None, None)[:4]
    quant = cs[2] is not None
    rows = int(slens[active].sum().item()) * cs[0].shape[-2] * cs[0].shape[-1]
    h, err, steps, ndiff, over = hv, 0.0, 0, 0, 0.0
    for i in range(cs[0].shape[0]):
        wi = {k_: t[i:i + 1] for k_, t in w.items()}
        mine = tuple(None if t is None else t[i:i + 1] for t in cs)
        ref = tuple(None if t is None else t.clone() for t in mine)
        rh = fd.verify_tokens_paged_plain(h, wi, ref[0], ref[1], tables, plens, slens, active,
                                          **kw, k_scale=ref[2], v_scale=ref[3])
        h = fd.verify_tokens_paged(h, wi, mine[0], mine[1], tables, plens, slens, active, **kw,
                                   k_scale=mine[2], v_scale=mine[3])
        torch.cuda.synchronize()
        scale = max(1.0, rh.abs().max().item())
        err = max(err, (h - rh).abs().max().item() / scale)
        for j in range(2):
            if quant:
                st, nd, ov = code_gap(mine[j], mine[j + 2], ref[j], ref[j + 2])
                steps, ndiff, over = max(steps, st), max(ndiff, nd), max(over, ov)
            else:
                err = max(err, (mine[j].float() - ref[j].float()).abs().max().item() / scale)
        if quant:
            for a, b in zip(mine[2:], ref[2:]):
                scales_check(f"{name} layer {i}", a, b, base, rel)
    own_rows_check(name, base, err, steps, ndiff / rows, over, quant, rel)
    same = [torch.equal(movable(a), movable(b)) for a, b in zip((h, *cs[:len(pools)]), mega)]
    if not all(same):
        raise AssertionError(f"{name} one layer a launch differs from one launch over every "
                             f"layer: h_out, k, v, scales equal {same}")
    print(f"  {name} one layer a launch == one launch over every layer bitwise (h_out and the "
          f"committed rows{' and scales' if quant else ''} of {cs[0].shape[0]} "
          "layers)")


def check_repeat(name, first, launch, k0, v0):
    """A second launch on the same inputs (fresh copies of the caches
    ``k0``/``v0``) equal to ``first`` = (h_out, k, v) bit for bit."""
    import torch

    k, v = k0.clone(), v0.clone()
    again = (launch(k, v), k, v)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    print(f"  {name}: two launches bitwise equal (h_out and the caches)")


def coop_barrier_us(grid, smem, steps=500):
    """us a sync of the cooperative decode kernels' own grid barrier (the
    flag barrier of csrc/fused_decode.cu, its probe build's
    ``coop_barrier_probe``) at ``grid`` CTAs of ``smem`` bytes of shared
    memory."""
    import ctypes

    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    fn = _build.load("fused_decode_probe").coop_barrier_probe
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    flags = fd.barrier_flags("cuda")

    def run():
        _build.check(fn(grid, smem, steps, flags, stream), "coop_barrier_probe")

    return 1e3 * cuda_ms(run, 5, 1) / steps


# The cooperative kernels' stamp points a layer (csrc/fused_decode.cu NST):
# each phase's points, first and last its start and end.
COOP_POINTS = {"(a) LN1 + q/k/v": ("start", "LN1", "ready", "q/k/v"),
               "(b) attention": ("start", "inputs", "scores", "softmax", "P.V"),
               "(c) output proj.": ("start", "x staged", "product"),
               "(d) LN2 + up": ("start", "LN2", "ready", "up"),
               "(e) down": ("start", "x staged", "down")}


def coop_split(label, call, n_layers, grid):
    """Where one cooperative launch's time goes: ``call`` once more through
    the probe build with the phase stamps on (csrc/fused_decode.cu
    stamp()). Per phase, averaged over
    the layers: the slowest CTA's work (its start to its arrival at the
    grid barrier), that CTA's steps, and the phase's period on CTA 0 (start
    to next start); the difference is the barrier and the wait for the
    slowest CTA."""
    import ctypes

    import torch
    from distributed_tensorflow_tpu_torch.ops import _build

    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    lib = _build.load("fused_decode_probe")
    lib.coop_set_stamps.argtypes = [ctypes.c_void_p]
    lib.coop_set_stamps.restype = None
    nst = sum(len(v) for v in COOP_POINTS.values())
    ns = nst * n_layers
    stamps = torch.zeros(grid, ns + 4, dtype=torch.int64, device="cuda")
    fd.LIBRARIES[torch.bfloat16] = "fused_decode_probe"
    try:
        call()
        torch.cuda.synchronize()
        lib.coop_set_stamps(stamps.data_ptr())
        call()
        torch.cuda.synchronize()
    finally:
        lib.coop_set_stamps(None)
        fd.LIBRARIES[torch.bfloat16] = "fused_decode"
    st = stamps.cpu().numpy().astype(np.float64)
    us = 1e-3 * (st[0, ns + 1] - st[0, ns]) / (st[0, ns + 3] - st[0, ns + 2])  # us a clock
    rows, k0, total_work, total_period = [], 0, 0.0, 0.0
    for name, points in COOP_POINTS.items():
        k1 = k0 + len(points) - 1
        work, period, steps = [], [], []
        for layer in range(n_layers):
            s0, s1 = nst * layer + k0, nst * layer + k1
            w = st[:, s1] - st[:, s0]
            slow = int(np.argmax(w))
            nxt = st[0, s1 + 1] if s1 + 1 < ns else st[0, ns + 3]
            work.append(w[slow] * us)
            period.append((nxt - st[0, s0]) * us)
            steps.append(np.diff(st[slow, s0:s1 + 1]) * us)
        steps = np.mean(steps, 0)
        total_work += sum(work)
        total_period += sum(period)
        parts = ", ".join(f"{p} {t:.2f}" for p, t in zip(points[1:], steps))
        rows.append(f"{name} {np.mean(work):.2f} ({parts}) / {np.mean(period):.2f}")
        k0 = k1 + 1
    print(f"  {label}, split of a launch ({1e-3 * (st[0, ns + 1] - st[0, ns]):.1f} us with "
          f"stamps, SM clock {1e-3 / us:.3f} GHz), us a layer, the slowest CTA's work (its "
          f"steps) / period: {'; '.join(rows)}; barriers and waits "
          f"{total_period - total_work:.1f} us, work {total_work:.1f} us")


def coop_grids(S, n, d, H, Dh, Fw, C):
    """The cooperative decode kernels' launches at the phase's shapes: grid
    (CTAs, occupancy), grid syncs a launch, shared memory, and the grid
    barrier's time at that grid size."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel, r, mb in (("decode_token_slab", 1, 0), ("decode_token_paged", 1, C // BLOCK),
                          ("verify_tokens_paged", 5, C // BLOCK)):
        p = fd.launch_plan(kernel, S, r, n, d, H, H, Dh, Fw, C, mb, "cuda")
        print(f"  {kernel}: grid {p.grid} CTAs ({nsm} SMs x occupancy {p.occupancy}), "
              f"{p.syncs} grid syncs a launch, {p.smem} bytes of shared memory a CTA, "
              f"tiles a CTA {[(q.name, q.tiles_per_cta) for q in p.products]}; a sync at "
              f"{p.grid} CTAs on the kernels' flag barrier "
              f"{coop_barrier_us(p.grid, p.smem):.3f} us")


def pool_from_slab(ck, tables, nb):
    """The slab tensor [n, S, C, ...] (a bf16 cache, 1-byte codes or their
    scales) copied into a pool of ``nb`` blocks through ``tables``; blocks
    outside the tables hold noise."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.quantized import movable

    n, S, C = ck.shape[:3]
    rest = tuple(ck.shape[3:])
    pool = movable(torch.randn((n, nb, BLOCK) + rest, device=ck.device).to(ck.dtype))
    for i in range(S):
        pool[:, tables[i].long()] = movable(ck)[:, i].reshape((n, C // BLOCK, BLOCK) + rest)
    return pool.view(ck.dtype)


def writable_rows(tables, starts, counts, active, nb):
    """[nb, BLOCK] mask of the pool rows a launch may write."""
    import torch

    m = torch.zeros(nb, BLOCK, dtype=torch.bool)
    tab = tables.cpu()
    for s in range(tab.shape[0]):
        if bool(active[s]):
            for p in range(int(starts[s]), int(starts[s]) + int(counts[s])):
                m[int(tab[s, p // BLOCK]), p % BLOCK] = True
    return m.to(tables.device)


def check_untouched(name, pools, before, mask):
    """Every pool byte outside ``mask`` equal to ``before``, bit for bit."""
    import torch

    for a, b in zip(pools, before):
        if not torch.equal(a[:, ~mask], b[:, ~mask]):
            raise AssertionError(f"{name} wrote pool rows outside the ones it may write")


def phase_paged_kernels(records, w, ck, cv, lengths, active, h, o7):
    """The paged kernels at gpt-m shapes: S=8, bs=16, the default pool (8 x
    64 blocks) under scrambled tables, the slab phase's cache and lengths
    (256..768), one inactive row. ``o7`` is the slab per-layer kernel's
    output on layer 0 of the same cache."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.ops.paged_attention import gather_block_view

    dev = h.device
    g = torch.Generator(device=dev).manual_seed(1)
    n, S, C, H, Dh = ck.shape
    d = h.shape[1]
    mb = C // BLOCK
    nb = S * mb
    tables = torch.randperm(nb, device=dev, generator=g).reshape(S, mb).int()
    pk, pv = pool_from_slab(ck, tables, nb), pool_from_slab(cv, tables, nb)
    kw = dict(num_heads=H, compute_dtype=torch.bfloat16)
    w0 = {k_: t[0] for k_, t in w.items()}
    wbytes_layer = sum(t[0].numel() * t.element_size() for t in w.values())
    mat_flops_layer = 2 * S * sum(w[nm][0].numel() for nm in fd.PROJ_NAMES)
    kv_elems = int(lengths.sum().item()) * H * Dh
    attn_flops_layer = 4 * (int(lengths.sum().item()) + S) * H * Dh

    # Per-layer kernel: vs plain, and bit for bit vs the slab kernel.
    o, kf, vf, _, _ = fd.decode_block_paged(h, w0, pk[0], pv[0], tables, lengths, **kw)
    r, rk, rv, _, _ = fd.decode_block_paged_plain(h, w0, pk[0], pv[0], tables, lengths, **kw)
    torch.cuda.synchronize()
    err = max((o - r).abs().max().item(), (kf.float() - rk.float()).abs().max().item(),
              (vf.float() - rv.float()).abs().max().item())
    check_error("decode_block_paged", err, r.abs().max().item())
    if not torch.equal(o, o7):
        raise AssertionError("decode_block_paged differs from decode_block_slab bitwise")
    print("  decode_block_paged == decode_block_slab bitwise on the same logical cache")
    call = lambda: fd.decode_block_paged(h, w0, pk[0], pv[0], tables, lengths, **kw)  # noqa: E731
    records["decode_block_paged"] = dict(
        max_abs_err=err, ms=cuda_ms(call), graph_ms=graph_ms(call),
        plain_ms=cuda_ms(lambda: fd.decode_block_paged_plain(
            h, w0, pk[0], pv[0], tables, lengths, **kw)),
        library_ms=None,
        **bound(wbytes_layer + 2 * kv_elems * 2 + 2 * S * d * 4 + 2 * S * H * Dh * 2
                + 4 * tables.numel(), mat_flops_layer + attn_flops_layer, PEAK_BF16),
    )

    # Megakernel: vs plain; bit for bit vs the slab megakernel (h_out and
    # every committed row); nothing outside the active rows' write row.
    ck8, cv8 = ck.clone(), cv.clone()
    o8 = fd.decode_token_slab(h, w, ck8, cv8, lengths, active, **kw)[0]
    pk8, pv8 = pk.clone(), pv.clone()
    o = fd.decode_token_paged(h, w, pk8, pv8, tables, lengths, active, **kw)[0]
    pkp, pvp = pk.clone(), pv.clone()
    r = fd.decode_token_paged_plain(h, w, pkp, pvp, tables, lengths, active, **kw)[0]
    torch.cuda.synchronize()
    err = max((o - r).abs().max().item(), (pk8.float() - pkp.float()).abs().max().item(),
              (pv8.float() - pvp.float()).abs().max().item())
    check_error("decode_token_paged", err, r.abs().max().item())
    del pkp, pvp
    view_k = torch.stack([gather_block_view(pk8[i], tables) for i in range(n)])
    view_v = torch.stack([gather_block_view(pv8[i], tables) for i in range(n)])
    same = torch.equal(o, o8) and torch.equal(view_k, ck8) and torch.equal(view_v, cv8)
    del view_k, view_v, ck8, cv8
    if not same:
        raise AssertionError("decode_token_paged differs from decode_token_slab bitwise")
    print("  decode_token_paged == decode_token_slab bitwise (h_out and committed rows)")
    check_repeat("decode_token_paged", (o, pk8, pv8), lambda k, v: fd.decode_token_paged(
        h, w, k, v, tables, lengths, active, **kw)[0], pk, pv)
    check_layer_by_layer("decode_block_paged", (o, pk8, pv8), h, w, (pk, pv), tables, lengths,
                         active, kw)
    host = host_us(lambda: fd.decode_block_paged(h, w0, pk[0], pv[0], tables, lengths, **kw))
    print(f"  decode_block_paged: host time of a call {host:.1f} us")
    check_untouched("decode_token_paged", (pk8, pv8), (pk, pv),
                    writable_rows(tables, lengths, [1] * S, active, nb))
    records["decode_token_paged"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fd.decode_token_paged(h, w, pk8, pv8, tables, lengths, active, **kw)),
        plain_ms=cuda_ms(lambda: fd.decode_token_paged_plain(
            h, w, pk8, pv8, tables, lengths, active, **kw), 5),
        library_ms=None,
        **bound(n * (wbytes_layer + 2 * kv_elems * 2 + 2 * S * H * Dh * 2) + 2 * S * d * 4
                + 4 * tables.numel(), n * (mat_flops_layer + attn_flops_layer), PEAK_BF16),
    )
    del pk8, pv8

    # Verify at L=5: prefixes not block-aligned, suffix lengths 1..5, one
    # inactive slot.
    L = 5
    plens = lengths + (lengths % BLOCK == 0).int()
    slens = torch.tensor([1, 2, 3, 4, 5, 5, 3, 2], device=dev, dtype=torch.int32)[:S]
    hv = torch.randn(S, L, d, device=dev, generator=g)
    pk9, pv9 = pk.clone(), pv.clone()
    o = fd.verify_tokens_paged(hv, w, pk9, pv9, tables, plens, slens, active, **kw)
    pkp, pvp = pk.clone(), pv.clone()
    r = fd.verify_tokens_paged_plain(hv, w, pkp, pvp, tables, plens, slens, active, **kw)
    torch.cuda.synchronize()
    err = max((o - r).abs().max().item(), (pk9.float() - pkp.float()).abs().max().item(),
              (pv9.float() - pvp.float()).abs().max().item())
    check_error("verify_tokens_paged", err, r.abs().max().item())
    del pkp, pvp
    check_untouched("verify_tokens_paged", (pk9, pv9), (pk, pv),
                    writable_rows(tables, plens, slens.tolist(), active, nb))
    if torch.equal(pk9, pk):
        raise AssertionError("verify_tokens_paged committed nothing")
    check_repeat("verify_tokens_paged", (o, pk9, pv9), lambda k, v: fd.verify_tokens_paged(
        hv, w, k, v, tables, plens, slens, active, **kw), pk, pv)
    print("  decode_token_paged / verify_tokens_paged wrote no pool row outside "
          "the active slots' write rows")
    err = max(err, verify_short_prefixes(hv, w, pk, pv, tables, active, kw))
    grid = fd.launch_plan("verify_tokens_paged", S, L, n, d, H, H, Dh, w["w_up"].shape[-1], C,
                          mb, dev).grid
    coop_split("verify_tokens_paged", lambda: fd.verify_tokens_paged(
        hv, w, pk9, pv9, tables, plens, slens, active, **kw), n, grid)
    nrows = int(slens[active].sum().item())
    vkv = int(plens.sum().item()) * H * Dh
    vattn = 4 * int((L * plens + L * L).sum().item()) * H * Dh
    records["verify_tokens_paged"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fd.verify_tokens_paged(
            hv, w, pk9, pv9, tables, plens, slens, active, **kw)),
        plain_ms=cuda_ms(lambda: fd.verify_tokens_paged_plain(
            hv, w, pk9, pv9, tables, plens, slens, active, **kw), 5),
        library_ms=None,
        **bound(n * (wbytes_layer + 2 * vkv * 2 + 2 * nrows * H * Dh * 2) + 2 * S * L * d * 4
                + 4 * tables.numel(), n * (L * mat_flops_layer + vattn), PEAK_BF16),
    )


def code_diff(got, ref):
    """1-byte codes of the kernel ``got`` against the plain version's
    ``ref``: (the most steps apart, e4m3 by its byte's ordinal; how many
    differ)."""
    import torch

    def ordinal(t):
        if t.dtype == torch.float8_e4m3fn:
            b = t.view(torch.uint8).int()
            return torch.where(b >= 128, 128 - b, b)
        return t.int()

    d = (ordinal(got) - ordinal(ref)).abs()
    return int(d.max().item()), int(d.gt(0).sum().item())


def codes_check(name, got, ref, written):
    """Codes at most one step apart, the share of the ``written`` elements
    that differs printed and at most ``CODE_SHARE``."""
    worst, ndiff = code_diff(got, ref)
    share = ndiff / written
    print(f"    {name}: codes differ in {100 * share:.4f}% of the elements, at most "
          f"{worst} step (limit 1 step, {100 * CODE_SHARE:.1f}%)")
    if worst > 1 or share > CODE_SHARE:
        raise AssertionError(f"{name}: codes {worst} steps apart, {share} of them differ")


def code_step(codes, scale):
    """The value spacing at each code (x its row's scale): int8 1, e4m3
    2^(e - 10) for exponent field e >= 1 (2^-9 below)."""
    import torch

    if codes.dtype == torch.int8:
        step = torch.ones_like(codes, dtype=torch.float32)
    else:
        e = ((codes.view(torch.uint8).int() >> 3) & 15).clamp(min=1)
        step = torch.exp2((e - 10).float())
    return step * scale[..., None]


def code_gap(got, got_scale, ref, ref_scale):
    """1-byte codes with their row scales against the plain version's:
    (the most steps apart, how many codes differ, the largest value gap
    (codes x scales) beyond one code step at that value, over the plain
    version's largest value)."""
    from distributed_tensorflow_tpu_torch.ops.quantized import dequantize_kv

    steps, ndiff = code_diff(got, ref)
    a, b = dequantize_kv(got, got_scale), dequantize_kv(ref, ref_scale)
    step = code_step(got, got_scale).maximum(code_step(ref, ref_scale))
    return steps, ndiff, (((a - b).abs() - step).max() / b.abs().max()).item()


def later_layers_check(name, got, got_scale, ref, ref_scale, written):
    """The 1-byte caches of layers >= 1 (``got``/``ref`` [n-1, ...] with
    their scales) after a launch over every layer, against the plain
    version's chain, whose residual rows differ from the kernel's by the
    sums' order: per layer, the share of the ``written`` codes that differ
    at most ``LATER_CODE_SHARE`` of the cache type, and each value (codes x
    scales) within one code step of the plain one plus ``LATER_VALUE_TOL``
    of the largest. Each layer on the kernel's own rows is held at
    ``CODE_SHARE`` by :func:`check_layer_by_layer` and
    :func:`verify_layer_by_layer`."""
    import torch

    limit = LATER_CODE_SHARE["int8" if got.dtype == torch.int8 else "fp8"]
    shares, steps, over = [], 0, 0.0
    for j in range(got.shape[0]):
        st, nd, ov = code_gap(got[j], got_scale[j], ref[j], ref_scale[j])
        shares.append(nd / written)
        steps, over = max(steps, st), max(over, ov)
    worst = max(range(len(shares)), key=shares.__getitem__)
    print(f"    {name} layers 1-{len(shares)}: codes differ in at most "
          f"{100 * shares[worst]:.4f}% of the written elements (layer {worst + 1}; limit "
          f"{100 * limit:.1f}%), at most {steps} steps apart; values {over:.3e} of the largest "
          f"beyond one code step (limit {LATER_VALUE_TOL:.1e})")
    if not (shares[worst] <= limit and over <= LATER_VALUE_TOL):
        raise AssertionError(f"{name}: layers >= 1 differ in {shares[worst]} of their codes, "
                             f"values {over} of the largest beyond a code step")


def own_rows_check(name, base, err, steps, share, over, quant, rel=None):
    """The verdict of a kernel's layers each held against the plain version
    on the kernel's own rows: h_out (and bf16 rows) within REL_TOL of the
    largest h_out; 1-byte codes differing in at most ``CODE_SHARE`` of a
    layer's rows and each value within one code step plus
    ``LATER_VALUE_TOL`` of the largest (an e4m3 code of a value small
    against its row's amax may move more than one step)."""
    tol = REL_TOL[base] if rel is None else rel
    codes = (f"; codes differ in at most {100 * share:.4f}% of a layer's rows (limit "
             f"{100 * CODE_SHARE:.1f}%), at most {steps} steps apart, values {over:.3e} of the "
             f"largest beyond one code step (limit {LATER_VALUE_TOL:.1e})" if quant else "")
    print(f"  {name} each layer on its own rows vs the plain version: at most {err:.3e} of "
          f"the largest h_out (tolerance {tol:.0e}){codes}")
    if not (err <= tol and share <= CODE_SHARE and over <= LATER_VALUE_TOL):
        raise AssertionError(f"{name}: a layer on its own rows differs from the plain version "
                             f"(error {err}, codes differ in {share} of them, values {over} "
                             "beyond a code step)")


def scales_check(name, got, ref, base, rel=None):
    """Row scales within ``REL_TOL[base]`` (or ``rel``) of the plain ones
    (relative to their largest). Returns the relative error."""
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    if not err <= (REL_TOL[base] if rel is None else rel):
        raise AssertionError(f"{name}: scales {err} apart (relative)")
    return err


def kv_bytes(positions, H, Dh, kv, elem=2):
    """Bytes of K or V at ``positions`` cached rows: the compute dtype
    ("bf16", ``elem`` bytes: 2, or 4 for an f32 model), or 1-byte codes
    with a 4-byte scale a row and head."""
    return positions * H * (elem * Dh if kv == "bf16" else Dh + 4)


def kernel_variants(records, variant, w, ck0, cv0, lengths, active, h, hq=None, window=None,
                    compute_dtype=None):
    """Phase 3 for one of ``VARIANTS`` (RoPE and/or an int8/fp8 cache) at
    gpt-m shapes (phase 3's weights, S=8, lengths 256..768 of 1024, one
    inactive row; paged: 512 blocks of 16 under scrambled tables; B7 at
    L=5): B5 slab/paged, B6 slab/paged and B7 against their plain versions
    (h within REL_TOL, codes within one step, scales within REL_TOL), B5
    layer by layer == B6 bitwise (slab and paged), paged == slab bitwise;
    each timed beside its plain version and its bound (1-byte codes plus a
    4-byte scale a row and head), and B6 slab's launch split by phase
    (``coop_split``). Recorded as ``<kernel>[<variant>]``. A window variant
    (``WINDOW_VARIANTS``) runs with ``window=WINDOW``: the slab is the
    rolling buffer of WINDOW rows laid out from the full caches at
    ``lengths`` (which wrap it), the pool the full caches (absolute); paged
    == slab bitwise holds for h and the committed rows. ``hq``: the query
    heads where the caches hold fewer (GQA); ``window``: the window of a
    variant whose label does not start with "window"; ``compute_dtype``
    (default bf16): f32 runs the f32 kernels (``w``'s projections and a
    "bf16" cache ``ck0``/``cv0`` in f32) under ``F32_DECODE_TOL`` where the
    cache is f32 (1-byte codes keep REL_TOL: a code at a quantizer midpoint
    may land one step apart), its bound at the split-TF32 rate."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import rolling_layout
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.ops.paged_attention import gather_block_view
    from distributed_tensorflow_tpu_torch.ops.quantized import movable, quantize_kv

    label, rope, kv = variant[:3]
    window = WINDOW if label.startswith("window") else window
    cd = compute_dtype or torch.bfloat16
    f32 = cd == torch.float32
    rel = F32_DECODE_TOL if f32 and kv == "bf16" else None
    elem = 4 if f32 else 2
    peak = PEAK_SPLIT_TF32 if f32 else PEAK_BF16
    dev = h.device
    g = torch.Generator(device=dev).manual_seed(5)
    n, S, C, H, Dh = ck0.shape  # H: the KV heads
    hq = hq or H
    d, mb = h.shape[1], C // BLOCK
    nb = S * mb
    if kv == "bf16":
        caches = (ck0, cv0)
    else:
        (ck, ks), (cv, vs) = quantize_kv(ck0.float(), kv), quantize_kv(cv0.float(), kv)
        caches = (ck, cv, ks, vs)
    full = caches
    if window is not None:
        caches = tuple(rolling_layout(t, lengths, window) for t in full)
    kw = dict(num_heads=hq, rope=rope, compute_dtype=cd, window=window)
    w0 = {k_: t[0] for k_, t in w.items()}

    def sc(cs, layer=None):
        if len(cs) == 2:
            return {}
        return dict(k_scale=cs[2] if layer is None else cs[2][layer],
                    v_scale=cs[3] if layer is None else cs[3][layer])

    def clones(cs):
        return tuple(t.clone() for t in cs)

    def same(a, b):
        return all(torch.equal(movable(x), movable(y)) for x, y in zip(a, b))

    wbytes_layer = sum(t[0].numel() * t.element_size() for t in w.values())
    mat_flops_layer = 2 * S * sum(w[nm][0].numel() for nm in fd.PROJ_NAMES)
    # Positions a step reads: the band's, W - 1 below the length, with a window.
    band = lengths if window is None else lengths.clamp(max=window - 1)
    pos = int(band.sum().item())
    attn_flops_layer = 4 * (pos + S) * hq * Dh
    fresh = 2 * kv_bytes(S, H, Dh, kv, elem)
    tables = torch.randperm(nb, device=dev, generator=g).reshape(S, mb).int()
    pools = tuple(pool_from_slab(t, tables, nb) for t in full)
    print(f"  variant {label}:")

    def hold(name, got, ref, written, layers=False):
        """h, then the cache tensors (codes or values, of which ``written``
        elements each were written, then scales). A bf16 cache is held as
        values with h (REL_TOL). With ``layers`` (B6, B7: a leading layer
        axis) 1-byte codes are held one step apart on the first layer
        (written from the same residual rows) and by
        :func:`later_layers_check` on the others."""
        base, full = name, f"{name}[{label}]"
        err = (got[0] - ref[0]).abs().max().item()
        if len(got) == 3:
            err = max(err, *((a.float() - b.float()).abs().max().item()
                             for a, b in zip(got[1:], ref[1:])))
        check_error(base, err, ref[0].abs().max().item(), rel)
        if len(got) == 3:
            return err
        for i in (1, 2):
            if layers:
                codes_check(f"{full} layer 0", got[i][0], ref[i][0], written // n)
                later_layers_check(full, got[i][1:], got[i + 2][1:], ref[i][1:],
                                   ref[i + 2][1:], written // n)
            else:
                codes_check(full, got[i], ref[i], written)
        for t_got, t_ref in zip(got[3:], ref[3:]):
            scales_check(full, t_got, t_ref, base, rel)
        return err

    # B5 slab and paged (layer 0), vs plain; paged == slab bitwise.
    c0 = tuple(t[0] for t in caches)
    p0 = tuple(t[0] for t in pools)
    o5 = fd.decode_block_slab(h, w0, c0[0], c0[1], lengths, **kw, **sc(c0))
    r5 = fd.decode_block_slab_plain(h, w0, c0[0], c0[1], lengths, **kw, **sc(c0))
    torch.cuda.synchronize()
    row = H * Dh  # elements of a fresh row
    nact = int(active.sum().item())
    errs = {"decode_block_slab": hold("decode_block_slab", [t for t in o5 if t is not None],
                                      [t for t in r5 if t is not None], S * row)}
    o5p = fd.decode_block_paged(h, w0, p0[0], p0[1], tables, lengths, **kw, **sc(p0))
    r5p = fd.decode_block_paged_plain(h, w0, p0[0], p0[1], tables, lengths, **kw, **sc(p0))
    torch.cuda.synchronize()
    errs["decode_block_paged"] = hold("decode_block_paged", [t for t in o5p if t is not None],
                                      [t for t in r5p if t is not None], S * row)
    if not same([t for t in o5p if t is not None], [t for t in o5 if t is not None]):
        raise AssertionError(f"decode_block_paged[{label}] differs from decode_block_slab")

    # B6 slab and paged, vs plain (h and every committed row); paged ==
    # slab bitwise; B5 layer by layer == B6 (both layouts).
    k6 = clones(caches)
    o6 = fd.decode_token_slab(h, w, k6[0], k6[1], lengths, active, **kw, **sc(k6))[0]
    r6c = clones(caches)
    r6 = fd.decode_token_slab_plain(h, w, r6c[0], r6c[1], lengths, active, **kw, **sc(r6c))[0]
    torch.cuda.synchronize()
    errs["decode_token_slab"] = hold("decode_token_slab", (o6, *k6), (r6, *r6c),
                                     n * nact * row, layers=True)
    del r6c
    check_layer_by_layer(f"decode_block_slab[{label}]", (o6, *k6), h, w, caches, None, lengths,
                         active, kw, rel)
    p6 = clones(pools)
    o6p = fd.decode_token_paged(h, w, p6[0], p6[1], tables, lengths, active, **kw, **sc(p6))[0]
    r6p = clones(pools)
    r6pv = fd.decode_token_paged_plain(h, w, r6p[0], r6p[1], tables, lengths, active, **kw,
                                       **sc(r6p))[0]
    torch.cuda.synchronize()
    errs["decode_token_paged"] = hold("decode_token_paged", (o6p, *p6), (r6pv, *r6p),
                                      n * nact * row, layers=True)
    del r6p
    if window is None:
        views = tuple(torch.stack([gather_block_view(t[i], tables) for i in range(n)])
                      for t in p6)
        rows_same = same(views, k6)
        del views
    else:  # the committed rows: the pool's at the length, the rolling slab's at length % W
        rows = torch.arange(S, device=dev)[active]
        ln = lengths[active].long()
        rows_same = all(torch.equal(movable(pt)[:, tables[rows, ln // BLOCK].long(), ln % BLOCK],
                                    movable(st)[:, rows, ln % window])
                        for pt, st in zip(p6, k6))
    if not (torch.equal(o6p, o6) and rows_same):
        raise AssertionError(f"decode_token_paged[{label}] differs from decode_token_slab")
    check_layer_by_layer(f"decode_block_paged[{label}]", (o6p, *p6), h, w, pools, tables,
                         lengths, active, kw, rel)
    print(f"    paged == {'rolling ' if window else ''}slab bitwise (B5 h and fresh rows; B6 h "
          "and committed rows)")

    # B7 at L=5, prefixes not block-aligned.
    L = 5
    plens = lengths + (lengths % BLOCK == 0).int()
    slens = torch.tensor([1, 2, 3, 4, 5, 5, 3, 2], device=dev, dtype=torch.int32)[:S]
    hv = torch.randn(S, L, d, device=dev, generator=g)
    p7 = clones(pools)
    o7 = fd.verify_tokens_paged(hv, w, p7[0], p7[1], tables, plens, slens, active, **kw,
                                **sc(p7))
    r7c = clones(pools)
    r7 = fd.verify_tokens_paged_plain(hv, w, r7c[0], r7c[1], tables, plens, slens, active,
                                      **kw, **sc(r7c))
    torch.cuda.synchronize()
    errs["verify_tokens_paged"] = hold("verify_tokens_paged", (o7, *p7), (r7, *r7c),
                                       n * int(slens[active].sum().item()) * row, layers=True)
    verify_layer_by_layer(f"verify_tokens_paged[{label}]", (o7, *p7), hv, w, pools, tables,
                          plens, slens, active, kw, rel)
    del r7c, p7

    # Times, bounds.
    kvb = kv_bytes(pos, H, Dh, kv, elem)
    nrows = int(slens[active].sum().item())
    vband = plens if window is None else plens.clamp(max=window - 1)
    vkvb = kv_bytes(int(vband.sum().item()), H, Dh, kv, elem)
    vattn = 4 * int((L * vband + L * L).sum().item()) * hq * Dh
    tab = 4 * tables.numel()
    calls = {
        "decode_block_slab": (
            lambda: fd.decode_block_slab(h, w0, c0[0], c0[1], lengths, **kw, **sc(c0)),
            lambda: fd.decode_block_slab_plain(h, w0, c0[0], c0[1], lengths, **kw, **sc(c0)),
            wbytes_layer + 2 * kvb + 2 * S * d * 4 + fresh,
            mat_flops_layer + attn_flops_layer),
        "decode_block_paged": (
            lambda: fd.decode_block_paged(h, w0, p0[0], p0[1], tables, lengths, **kw, **sc(p0)),
            lambda: fd.decode_block_paged_plain(h, w0, p0[0], p0[1], tables, lengths, **kw,
                                                **sc(p0)),
            wbytes_layer + 2 * kvb + 2 * S * d * 4 + fresh + tab,
            mat_flops_layer + attn_flops_layer),
        "decode_token_slab": (
            lambda: fd.decode_token_slab(h, w, k6[0], k6[1], lengths, active, **kw, **sc(k6)),
            lambda: fd.decode_token_slab_plain(h, w, k6[0], k6[1], lengths, active, **kw,
                                               **sc(k6)),
            n * (wbytes_layer + 2 * kvb + fresh) + 2 * S * d * 4,
            n * (mat_flops_layer + attn_flops_layer)),
        "decode_token_paged": (
            lambda: fd.decode_token_paged(h, w, p6[0], p6[1], tables, lengths, active, **kw,
                                          **sc(p6)),
            lambda: fd.decode_token_paged_plain(h, w, p6[0], p6[1], tables, lengths, active,
                                                **kw, **sc(p6)),
            n * (wbytes_layer + 2 * kvb + fresh) + 2 * S * d * 4 + tab,
            n * (mat_flops_layer + attn_flops_layer)),
        "verify_tokens_paged": (
            lambda: fd.verify_tokens_paged(hv, w, p6[0], p6[1], tables, plens, slens, active,
                                           **kw, **sc(p6)),
            lambda: fd.verify_tokens_paged_plain(hv, w, p6[0], p6[1], tables, plens, slens,
                                                 active, **kw, **sc(p6)),
            n * (wbytes_layer + 2 * vkvb + 2 * kv_bytes(nrows, H, Dh, kv, elem)) + 2 * S * L * d * 4
            + tab, n * (L * mat_flops_layer + vattn)),
    }
    if window is None and not f32:  # the probe build is bf16's
        grid = fd.launch_plan("decode_token_slab", S, 1, n, d, hq, H, Dh, w["w_up"].shape[-1], C,
                              0, dev, caches[0].dtype).grid
        coop_split(f"decode_token_slab[{label}]", calls["decode_token_slab"][0], n, grid)
    for name, (call, plain, nbytes, flops) in calls.items():
        per_layer = name.startswith("decode_block")
        records[f"{name}[{label}]"] = r = dict(
            max_abs_err=errs[name], ms=cuda_ms(call), plain_ms=cuda_ms(plain, 10 if per_layer else 5),
            library_ms=None, **bound(nbytes, flops, peak))
        print(f"    {name}[{label}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def layer_weights(n, d, hq, hkv, dh, f, g, dev, dtype=None):
    """Seeded weights of ``n`` layers as the decode kernels take them:
    projections in ``dtype`` (default bf16; KV width hkv x dh), layernorms
    and biases f32."""
    import torch

    def rw(*shape, scale):
        return torch.randn(shape, device=dev, generator=g) * scale

    w = {"ln1_scale": 1 + rw(n, d, scale=0.1), "ln1_bias": rw(n, d, scale=0.05),
         "ln2_scale": 1 + rw(n, d, scale=0.1), "ln2_bias": rw(n, d, scale=0.05),
         "b_up": rw(n, f, scale=0.05), "b_down": rw(n, d, scale=0.05)}
    for nm, (k, m) in dict(wq=(d, hq * dh), wk=(d, hkv * dh), wv=(d, hkv * dh),
                           wo=(hq * dh, d), w_up=(d, f), w_down=(f, d)).items():
        w[nm] = rw(n, k, m, scale=k ** -0.5).to(dtype or torch.bfloat16)
    return w


def s_kernels(records):
    """Phase 3 at head_dim 32: each of ``S_VARIANTS`` at gpt-s widths (d=256,
    4 layers, 8 heads of 32, F=1024; 8 slots at lengths 256..512, the
    decode-* traffic's, of a cache of 1024, one inactive; decode-gqa2 with
    2 KV heads, decode-window256 over the rolling slab of 256 rows) through
    :func:`kernel_variants`: B5, B6 and B7 against their plain versions,
    paged == slab and B5 layer by layer == B6 bit for bit, timed."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    n, S, C = S_CFG["num_layers"], 8, S_CFG["max_len"]
    d, hq = S_CFG["model_dim"], S_CFG["num_heads"]
    dh = d // hq
    lengths = torch.randint(S_PROMPT, S_PROMPT + S_MAX_NEW + 1, (S,), device=dev, generator=g,
                            dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    active[S - 1] = False
    h = torch.randn(S, d, device=dev, generator=g)
    for hkv in sorted({v[3] for v in S_VARIANTS}):
        w = layer_weights(n, d, hq, hkv, dh, 4 * d, g, dev)
        ck, cv = (torch.randn(n, S, C, hkv, dh, device=dev, generator=g).bfloat16()
                  for _ in range(2))
        for variant in S_VARIANTS:
            if variant[3] == hkv:
                kernel_variants(records, variant, w, ck, cv, lengths, active, h, hq=hq,
                                window=variant[4])
        del w, ck, cv


def f32_kernels(records):
    """Phase 3 in f32 compute: each of ``F32_VARIANTS`` at decode-full
    widths (d=256, 4 layers, 8 heads of 32, F=1024; 8 slots at lengths
    256..512 of a cache of 1024, one inactive; GQA-2; the rolling slab of
    256 rows) through :func:`kernel_variants` with f32 weights and an f32
    cache (or its 1-byte codes): B5, B6 and B7 against their plain versions
    (``F32_DECODE_TOL`` over the f32 cache), paged == slab and B5 layer by
    layer == B6 bit for bit, timed; then the same step in slot groups of 3
    against one launch bit for bit."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    n, S, C = S_CFG["num_layers"], 8, S_CFG["max_len"]
    d, hq = S_CFG["model_dim"], S_CFG["num_heads"]
    dh = d // hq
    lengths = torch.randint(S_PROMPT, S_PROMPT + S_MAX_NEW + 1, (S,), device=dev, generator=g,
                            dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    active[S - 1] = False
    h = torch.randn(S, d, device=dev, generator=g)
    for hkv in sorted({v[3] for v in F32_VARIANTS}):
        w = layer_weights(n, d, hq, hkv, dh, 4 * d, g, dev, torch.float32)
        ck, cv = (torch.randn(n, S, C, hkv, dh, device=dev, generator=g) for _ in range(2))
        for variant in F32_VARIANTS:
            if variant[3] == hkv:
                kernel_variants(records, variant, w, ck, cv, lengths, active, h, hq=hq,
                                window=variant[4], compute_dtype=torch.float32)
        if hkv == hq:  # grouped launches == one launch (f32)
            kw = dict(num_heads=hq, compute_dtype=torch.float32)
            runs = []
            for group in (None, 3):
                k, v = ck.clone(), cv.clone()
                fd.MAX_GROUP = group
                try:
                    runs.append((fd.decode_token_slab(h, w, k, v, lengths, active, **kw)[0], k, v))
                finally:
                    fd.MAX_GROUP = None
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("f32 decode_token_slab in groups of 3 differs from one launch")
            print("  decode_token_slab[f32-full-f32] in slot groups of 3 == one launch bitwise "
                  "(h_out and the committed rows)")
        del w, ck, cv


def narrow_kernels(records):
    """Phase 3 at head dims 8 and 16: each of ``NARROW_MODELS`` in bf16 and
    f32 (2 layers, 8 slots at lengths NARROW_PROMPT..NARROW_PROMPT +
    NARROW_NEW of a cache of 64, one inactive) through
    :func:`kernel_variants`: B5, B6 and B7 against their plain versions
    (REL_TOL in bf16, ``F32_DECODE_TOL`` in f32), paged == slab and B5
    layer by layer == B6 bit for bit, timed. Recorded as
    ``<kernel>[d8-bf16]`` etc."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    n, S, C = NARROW_CFG["num_layers"], 8, NARROW_CFG["max_len"]
    lengths = torch.randint(NARROW_PROMPT, NARROW_PROMPT + NARROW_NEW + 1, (S,), device=dev,
                            generator=g, dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    active[S - 1] = False
    for label, knobs in NARROW_MODELS:
        d, hq = knobs["model_dim"], knobs["num_heads"]
        dh, rope = d // hq, knobs.get("pos_embedding") == "rope"
        h = torch.randn(S, d, device=dev, generator=g)
        for cd in (torch.bfloat16, torch.float32):
            w = layer_weights(n, d, hq, hq, dh, 4 * d, g, dev, cd)
            ck, cv = (torch.randn(n, S, C, hq, dh, device=dev, generator=g).to(cd)
                      for _ in range(2))
            name = f"{label}-{'f32' if cd == torch.float32 else 'bf16'}"
            kernel_variants(records, (name, rope, "bf16"), w, ck, cv, lengths, active, h, hq=hq,
                            compute_dtype=cd)


def flash_narrow_inputs(label, knobs, dtype, g):
    """Seeded q/k/v/dO at ``FLASH_NARROW_SHAPE`` for one of
    ``FLASH_NARROW_TRAIN`` (its heads and head dim) in ``dtype``."""
    import torch

    b, l = FLASH_NARROW_SHAPE
    hq = knobs["num_heads"]
    d = knobs["model_dim"] // hq
    return tuple(torch.randn(b, l, hq, d, device="cuda", generator=g).to(dtype) for _ in range(4))


def flash_narrow_fwd(records):
    """Phase 3: B3 at head dim 8 and at the padded head dim 48 (on the D=64
    kernel), at ``FLASH_NARROW_SHAPE`` (causal) in f32 (the training path's
    q/k/v) and bf16, against the plain forward (REL_TOL in f32; 2^-7 of the
    largest output in bf16); the f32 one timed beside the plain forward,
    SDPA and the bound of the causal pairs. Recorded under
    ``FLASH_NARROW``."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(29)
    b, l = FLASH_NARROW_SHAPE
    for label, knobs in FLASH_NARROW_TRAIN:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _ = flash_narrow_inputs(label, knobs, dtype, g)
            hq, d = q.shape[2], q.shape[3]
            out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            scale = max(1.0, ref.float().abs().max().item())
            tol = REL_TOL["flash_fwd"] * scale if dtype == torch.float32 else 2 ** -7 * scale
            kind = str(dtype).split(".")[1]
            print(f"  flash_fwd[{label}] {kind} (B={b} L={l} {hq}x{d}, causal; runs on "
                  f"D={fa.kernel_head_dim(d)}): max_abs_err {err:.3e} (tolerance {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"flash_fwd[{label}] {kind} disagrees with its plain version")
            if dtype != torch.float32:
                continue
            pairs = b * hq * l * (l + 1) // 2
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            records[f"flash_fwd[{label}]"] = r = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, causal=True)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 5),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          is_causal=True)),
                **split_tf32_bound(4 * (2 * q.numel() + k.numel() + v.numel() + lse.numel()),
                                   4 * d * pairs))
            print(f"  flash_fwd[{label}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']})")


def flash_narrow_bwd(records):
    """Phase 11: B4a, B4b and B4c at head dim 8 and at the padded head dim
    48, at ``FLASH_NARROW_SHAPE`` (causal) in f32 and bf16, against the
    plain backward (REL_TOL in f32, BWD_BF16_TOL in bf16); in f32 each
    timed beside the plain backward, the bound of the causal pairs and, for
    B4a, SDPA's backward. Recorded under ``FLASH_NARROW``."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(31)
    b, l = FLASH_NARROW_SHAPE
    for label, knobs in FLASH_NARROW_TRAIN:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_narrow_inputs(label, knobs, dtype, g)
            hq, d = q.shape[2], q.shape[3]
            out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            delta = (do.float() * out.float()).sum(-1)
            plain = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, None, True)
            kw = dict(causal=True)
            calls = {"flash_bwd_fused": lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw),
                     "flash_bwd_dq": lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                                              None, None),
                     "flash_bwd_dkv": lambda: (None, *fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                                       **kw))}
            kind = str(dtype).split(".")[1]
            errs = {name: check_bwd(f"{name}[{label}] {kind} vs plain", fn(), plain,
                                    REL_TOL[name] if dtype == torch.float32 else BWD_BF16_TOL)
                    for name, fn in calls.items()}
            if dtype != torch.float32:
                continue
            pairs = b * hq * l * (l + 1) // 2
            io, rows = 4 * q.numel(), 4 * lse.numel()
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            dot = do.transpose(1, 2)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                          retain_graph=True))
            plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, delta, None,
                                                          True), 3)
            print(f"  {label} (B={b} L={l} {hq}x{d}, causal, f32; runs on "
                  f"D={fa.kernel_head_dim(d)}): SDPA backward {lib_bwd:.4f} ms, plain backward "
                  f"{plain_ms:.4f} ms")
            for name, fn in calls.items():
                fl = {"flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
                nbytes = {"flash_bwd_fused": 7, "flash_bwd_dq": 5, "flash_bwd_dkv": 6}[name] * io
                # SDPA's backward computes the fused kernel's function; no
                # call computes dq or dk/dv alone.
                records[f"{name}[{label}]"] = r = dict(
                    max_abs_err=errs[name], ms=cuda_ms(fn), plain_ms=plain_ms,
                    library_ms=lib_bwd if name == "flash_bwd_fused" else None,
                    **split_tf32_bound(nbytes + 2 * rows, 2 * d * pairs * fl))
                print(f"  {name}[{label}]: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                      f"({r['bound_by']})")


def flash_d32(records):
    """B3 at head_dim 32 at the serving shapes of causal B3 (S=8, L=1023, 8
    heads, f32, kv_lens 513..1023): against its plain version, then timed
    beside SDPA (a yardstick) and causal B3 at D=64 (``flash_fwd``: the same
    (q, k) pairs, twice the products a pair). Recorded as
    ``flash_fwd[d32]``."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_attention_with_lse,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    S, L, H, Dh = 8, 1023, 8, 32
    q, k, v = (torch.randn(S, L, H, Dh, device=dev, generator=g) for _ in range(3))
    lens = torch.randint(513, L + 1, (S,), device=dev, generator=g, dtype=torch.int32)
    kw = dict(causal=True, kv_lens=lens)
    out, lse = flash_attention_with_lse(q, k, v, **kw)
    ref, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
    check_error("flash_fwd", err, ref.abs().max().item())
    pos = torch.arange(L, device=dev)
    allowed = ((pos[None, :, None] >= pos[None, None, :])
               & (pos[None, None, :] < lens[:, None, None]))
    pairs = int(allowed.sum().item())
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + lse.numel()) + 4 * S
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = allowed[:, None]
    records["flash_fwd[d32]"] = r = dict(
        max_abs_err=err, ms=cuda_ms(lambda: flash_attention_with_lse(q, k, v, **kw)),
        plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
        **split_tf32_bound(nbytes, 4 * Dh * H * pairs))
    print(f"  flash_fwd[d32] (S={S}, L={L}, {H}x{Dh}, f32, {pairs} pairs): kernel "
          f"{r['ms']:.4f} ms against D=64's {records['flash_fwd']['ms']:.4f} ms at the same "
          f"pairs; SDPA {r['library_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def c1_kernels(records):
    """Phase 3, C1: the cooperative kernels over shapes past one launch or
    past one score tile, each against its plain version at REL_TOL and
    timed beside it and its bound: (a) B6 slab at gpt-m over 100 slots (two
    launches, 64 + 36 slots), and 64 slots in groups of 24 against their
    one launch bit for bit (h and the committed rows); (b) B7 at gpt-m with
    2 KV heads, 16 slots x L=5 over a pool of extent 2048 (12 + 4 slots,
    score tiles narrower than the extent), recorded as
    ``verify_tokens_paged[c1-gqa2-2048]``; (c) B7 at L=9 (gpt-m, 8 slots:
    7 + 1); (d) B6 at gpt-m with one KV head at lengths 6,000-8,000 over
    8,192 (blocks), and at lengths 3,000-4,000 over 4,096 (one block) and
    over 8,192 (blocks): the blocks' cost at the same lengths. The others
    are kept under their kernel's record (``c1``)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    n, d, hq, dh, f = 8, 512, 8, 64, 2048
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    out = {}

    def held(label, base, call, plain, launches, nbytes, flops, plan, timed):
        """call() and plain() each from fresh clones of their caches (inside
        them), the kernel's launches counted; then ``timed`` = (kernel,
        plain) timed, each over the caches in place (no clone in the
        time)."""
        before = _build.LAUNCHES[base]
        got = call()
        got_launches = _build.LAUNCHES[base] - before
        ref = plain()
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        check_error(base, err, ref[0].abs().max().item())
        if got_launches != launches:
            raise AssertionError(f"{label}: {got_launches} launches, expected {launches}")
        del got, ref
        r = dict(max_abs_err=err, ms=cuda_ms(timed[0], 10), plain_ms=cuda_ms(timed[1], 3),
                 library_ms=None, **bound(nbytes, flops, PEAK_BF16))
        out[label] = r
        print(f"  {label}: {launches} launches a call (score tile {plan.kb} keys, cs "
              f"{plan.cs}), kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        return r

    def clones(*ts):
        return [None if t is None else t.clone() for t in ts]

    def wbytes(w):
        return sum(t.numel() * t.element_size() for t in w.values())

    def mat_flops(w, rows):
        return 2 * rows * sum(w[nm].numel() for nm in fd.PROJ_NAMES)

    # (a) B6 over 100 slots; 64 slots grouped == one launch.
    w = layer_weights(n, d, hq, hq, dh, f, g, dev)
    s, c = 100, 1024
    ck, cv = (torch.randn(n, s, c, hq, dh, device=dev, generator=g).bfloat16() for _ in range(2))
    lengths = torch.randint(256, 769, (s,), device=dev, generator=g, dtype=torch.int32)
    active = torch.ones(s, dtype=torch.bool, device=dev)
    h = torch.randn(s, d, device=dev, generator=g)
    pos = int(lengths.sum().item())
    plan = fd.launch_plan("decode_token_slab", 64, 1, n, d, hq, hq, dh, f, c, 0, dev)

    def b6(fn, s_=s, clone=True):
        k, v = clones(ck[:, :s_], cv[:, :s_]) if clone else (ck, cv)
        return (fn(h[:s_], w, k, v, lengths[:s_], active[:s_], **kw)[0], k, v)

    held("decode_token_slab 100 slots", "decode_token_slab", lambda: b6(fd.decode_token_slab),
         lambda: b6(fd.decode_token_slab_plain), 2,
         wbytes(w) + n * 2 * kv_bytes(pos + s, hq, dh, "bf16") + 2 * s * d * 4,
         mat_flops(w, s) + n * 4 * (pos + s) * hq * dh, plan,
         (lambda: b6(fd.decode_token_slab, clone=False),
          lambda: b6(fd.decode_token_slab_plain, clone=False)))
    whole = b6(fd.decode_token_slab, 64)
    fd.MAX_GROUP = 24
    try:
        grouped = b6(fd.decode_token_slab, 64)
    finally:
        fd.MAX_GROUP = None
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(whole, grouped)):
        raise AssertionError("B6 over 64 slots in groups of 24 differs from its one launch")
    print("  decode_token_slab: 64 slots in groups of 24 (24 + 24 + 16) == one launch bitwise "
          "(h_out and the committed rows)")
    del ck, cv, whole, grouped

    # (b) B7 at gpt-m GQA-2, 16 slots x L=5 over 2048.
    hkv, s, c, L = 2, C1_SLOTS, 2048, C1_DRAFT + 1
    w = layer_weights(n, d, hq, hkv, dh, f, g, dev)
    slab = [torch.randn(n, s, c, hkv, dh, device=dev, generator=g).bfloat16() for _ in range(2)]
    mb = c // BLOCK
    tables = torch.randperm(s * mb, device=dev, generator=g).reshape(s, mb).int()
    pk, pv = (pool_from_slab(t, tables, s * mb) for t in slab)
    del slab
    plens = torch.randint(1500, c - L, (s,), device=dev, generator=g, dtype=torch.int32)
    slens = torch.randint(1, L + 1, (s,), device=dev, generator=g, dtype=torch.int32)
    vact = torch.ones(s, dtype=torch.bool, device=dev)
    hv = torch.randn(s, L, d, device=dev, generator=g)
    plan = fd.launch_plan("verify_tokens_paged", 12, L, n, d, hq, hkv, dh, f, c, mb, dev,
                          ref_rows=60)

    def b7(fn, hv=hv, pk=pk, pv=pv, tables=tables, plens=plens, slens=slens, vact=vact,
           clone=True):
        k, v = clones(pk, pv) if clone else (pk, pv)
        return (fn(hv, w, k, v, tables, plens, slens, vact, **kw), k, v)

    vpos = int(plens.sum().item())
    rows = int(slens.sum().item())
    records["verify_tokens_paged[c1-gqa2-2048]"] = held(
        "verify_tokens_paged[c1-gqa2-2048]", "verify_tokens_paged",
        lambda: b7(fd.verify_tokens_paged), lambda: b7(fd.verify_tokens_paged_plain), 2,
        n * (wbytes(w) // n + 2 * kv_bytes(vpos + rows, hkv, dh, "bf16")) + 2 * s * L * d * 4
        + 4 * tables.numel(), mat_flops(w, s * L) + n * 4 * (L * vpos + L * L * s) * hq * dh,
        plan, (lambda: b7(fd.verify_tokens_paged, clone=False),
               lambda: b7(fd.verify_tokens_paged_plain, clone=False)))
    del pk, pv

    # (c) B7 at L=9, gpt-m MHA, 8 slots (7 + 1).
    s, c, L = 8, 1024, 9
    w = layer_weights(n, d, hq, hq, dh, f, g, dev)
    slab = [torch.randn(n, s, c, hq, dh, device=dev, generator=g).bfloat16() for _ in range(2)]
    mb = c // BLOCK
    t9 = torch.randperm(s * mb, device=dev, generator=g).reshape(s, mb).int()
    p9k, p9v = (pool_from_slab(t, t9, s * mb) for t in slab)
    del slab
    pl9 = torch.randint(100, c - L, (s,), device=dev, generator=g, dtype=torch.int32)
    sl9 = torch.randint(1, L + 1, (s,), device=dev, generator=g, dtype=torch.int32)
    a9 = torch.ones(s, dtype=torch.bool, device=dev)
    h9 = torch.randn(s, L, d, device=dev, generator=g)
    plan = fd.launch_plan("verify_tokens_paged", 7, L, n, d, hq, hq, dh, f, c, mb, dev,
                          ref_rows=63)
    vpos, rows = int(pl9.sum().item()), int(sl9.sum().item())
    args9 = (h9, p9k, p9v, t9, pl9, sl9, a9)
    held("verify_tokens_paged L=9", "verify_tokens_paged",
         lambda: b7(fd.verify_tokens_paged, *args9),
         lambda: b7(fd.verify_tokens_paged_plain, *args9), 2,
         n * (wbytes(w) // n + 2 * kv_bytes(vpos + rows, hq, dh, "bf16")) + 2 * s * L * d * 4
         + 4 * t9.numel(), mat_flops(w, s * L) + n * 4 * (L * vpos + L * L * s) * hq * dh, plan,
         (lambda: b7(fd.verify_tokens_paged, *args9, clone=False),
          lambda: b7(fd.verify_tokens_paged_plain, *args9, clone=False)))
    del p9k, p9v

    # (d) B6 with one KV head past ~4,944 positions, and blocks against one
    # block at the same lengths.
    w = layer_weights(n, d, hq, 1, dh, f, g, dev)
    s = 8
    for c, lo, hi in ((8192, 6000, 8001), (4096, 3000, 4001), (8192, 3000, 4001)):
        ck, cv = (torch.randn(n, s, c, 1, dh, device=dev, generator=g).bfloat16()
                  for _ in range(2))
        lengths = torch.randint(lo, hi, (s,), device=dev, generator=g, dtype=torch.int32)
        act = torch.ones(s, dtype=torch.bool, device=dev)
        h = torch.randn(s, d, device=dev, generator=g)
        pos = int(lengths.sum().item())
        plan = fd.launch_plan("decode_token_slab", s, 1, n, d, hq, 1, dh, f, c, 0, dev)

        def b6k(fn, ck=ck, cv=cv, lengths=lengths, act=act, h=h, clone=True):
            k, v = clones(ck, cv) if clone else (ck, cv)
            return (fn(h, w, k, v, lengths, act, **kw)[0], k, v)

        held(f"decode_token_slab 8:1 lengths {lo}-{hi - 1} over {c}", "decode_token_slab",
             lambda: b6k(fd.decode_token_slab), lambda: b6k(fd.decode_token_slab_plain), 1,
             wbytes(w) + n * 2 * kv_bytes(pos + s, 1, dh, "bf16") + 2 * s * d * 4,
             mat_flops(w, s) + n * 4 * (pos + s) * hq * dh, plan,
             (lambda: b6k(fd.decode_token_slab, clone=False),
              lambda: b6k(fd.decode_token_slab_plain, clone=False)))
        del ck, cv
    records["decode_token_slab"]["c1"] = {k: v for k, v in out.items()
                                          if k.startswith("decode_token_slab")}
    records["verify_tokens_paged"]["c1"] = {k: v for k, v in out.items()
                                            if k.startswith("verify_tokens_paged")}
    for rec in ("decode_token_slab", "verify_tokens_paged"):
        for r in records[rec]["c1"].values():
            records[rec]["max_abs_err"] = max(records[rec]["max_abs_err"], r["max_abs_err"])


def wrong_suffix_mask(kind):
    """``paged_extend_attention`` with the suffix's own causal block masked
    wrongly: ``"strict"`` lets row li see fresh rows lj < li (not <=),
    ``"dropped"`` leaves the fresh rows out. A fault the verify check must
    catch."""
    import math

    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import NEG_INF, group_query_heads

    def attn(q, k_new, v_new, k_view, v_view, q_positions, prefix_lens, suffix_lens,
             window=None):
        assert window is None  # the check runs without a window
        s, l, hq, dh = q.shape
        c, dev = k_view.shape[1], q.device
        qg = group_query_heads(q, k_new.shape[2]).float()
        kcat = torch.cat([k_view.float(), k_new.float()], dim=1)
        vcat = torch.cat([v_view.float(), v_new.float()], dim=1)
        sc = torch.einsum("slhgd,skhd->shglk", qg, kcat) / math.sqrt(dh)
        li = torch.arange(l, device=dev)
        fresh = (li[None, :] < suffix_lens[:, None])[:, None, :] & (
            li[None, :] < li[:, None] if kind == "strict" else torch.zeros(
                l, l, dtype=torch.bool, device=dev))
        view = (torch.arange(c, device=dev)[None, :] < prefix_lens[:, None])[:, None, :]
        mask = torch.cat([view.expand(s, l, c), fresh.expand(s, l, l)], dim=-1)
        w = torch.softmax(sc.masked_fill(~mask[:, None, None], NEG_INF), dim=-1)
        out = torch.einsum("shglk,skhd->slhgd", w, vcat)
        return out.reshape(s, l, hq, dh).to(q.dtype)

    return attn


def verify_short_prefixes(hv, w, pk, pv, tables, active, kw):
    """``verify_tokens_paged`` against its plain version where the suffix's
    own causal block carries most of each softmax: prefix 0 (that block
    alone) and prefixes under one block. Held by what the launch changes,
    undiluted by the residual: the update ``h_out - h_in``, and the rows
    committed at layers >= 1 (layer 0's rows depend on ``h_in`` alone). The
    limits are ``VERIFY_SHORT_TOL`` of the plain version's largest update
    and committed row; plain versions with the suffix block masked wrongly
    must fail them. Returns the largest error."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    dev = hv.device
    plens = torch.tensor(VERIFY_SHORT_PLENS, device=dev, dtype=torch.int32)
    slens = torch.tensor(VERIFY_SHORT_SLENS, device=dev, dtype=torch.int32)
    rows = writable_rows(tables, plens, slens.tolist(), active, pk.shape[1])

    def run(fn):
        k, v = pk.clone(), pv.clone()
        upd = fn(hv, w, k, v, tables, plens, slens, active, **kw) - hv
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return upd, k[1:, rows].float(), v[1:, rows].float()

    def errors(got, ref):
        return ((got[0] - ref[0]).abs().max().item(),
                max((a - b).abs().max().item() for a, b in zip(got[1:], ref[1:])))

    ref = run(fd.verify_tokens_paged_plain)
    tol = (VERIFY_SHORT_TOL * ref[0].abs().max().item(),
           VERIFY_SHORT_TOL * max(t.abs().max().item() for t in ref[1:]))
    err = errors(run(fd.verify_tokens_paged), ref)
    print(f"  verify_tokens_paged at prefixes {list(VERIFY_SHORT_PLENS)}: update err "
          f"{err[0]:.3e} (tolerance {tol[0]:.3e}), committed rows of layers >= 1 err "
          f"{err[1]:.3e} (tolerance {tol[1]:.3e})")
    if not (err[0] <= tol[0] and err[1] <= tol[1]):
        raise AssertionError(f"verify_tokens_paged disagrees at short prefixes: {err} > {tol}")
    for kind in ("strict", "dropped"):
        real = fd.paged_extend_attention
        fd.paged_extend_attention = wrong_suffix_mask(kind)
        try:
            bad = errors(run(fd.verify_tokens_paged_plain), ref)
        finally:
            fd.paged_extend_attention = real
        print(f"  plain version with the suffix block {kind}: update err {bad[0]:.3e}, "
              f"rows err {bad[1]:.3e}")
        if bad[0] <= tol[0] or bad[1] <= tol[1]:
            raise AssertionError(f"the short-prefix limits pass a {kind} suffix mask: {bad}")
    return max(err)


def bound(nbytes, flops, peak):
    tb, tf = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return dict(bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf else "operations")


def split_tf32_bound(nbytes, flops):
    """The bound of a split-TF32 kernel on f32 inputs: three TF32 MMAs per
    f32 product."""
    return dict(**bound(nbytes, flops, PEAK_SPLIT_TF32), bound_peak="split-TF32, 495/3 TFLOP/s")


def start_sass(src):
    """``cuobjdump -sass`` of ``src``'s library, started (its output read by
    :func:`check_hmma`), so that every library's dump runs at once."""
    import shutil
    import tempfile

    from distributed_tensorflow_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError(f"cuobjdump not found: {src}'s SASS cannot be checked for HMMA")
    out = tempfile.TemporaryFile("w+")  # a file, not a pipe: no dump waits on its reader
    return out, subprocess.Popen([tool, "-sass", _build._lib_path(src)], stdout=out,
                                 stderr=subprocess.PIPE, text=True)


def check_hmma(src, kernels, dump):
    """Every instantiation of the tensor-core kernels in ``src``'s library
    holds HMMA instructions in its SASS (``dump``: :func:`start_sass`)."""
    out, proc = dump
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"cuobjdump failed on {src}: {err}")
    out.seek(0)
    counts, fn = {}, None
    for line in out:
        m = re.search(r"Function : (\S+)", line) if "Function :" in line else None
        if m:
            fn = m.group(1) if any(k in m.group(1) for k in kernels) else None
            if fn:
                counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    print(f"  {src}: HMMA instructions per tensor-core kernel: {sorted(counts.values())}")
    if not counts or not all(counts.values()):
        raise AssertionError(f"{src}: a tensor-core kernel has no HMMA: {counts}")


def serve_requests(vocab, seed, max_new=MAX_NEW):
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]
    configs = [
        GenerationConfig(max_new=max_new) if i % 2 == 0 else
        GenerationConfig(max_new=max_new, greedy=False, temperature=0.9,
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
    profile_decode(srv, prompts[:8], configs[:8])
    return model, params, prompts, configs, outs


def profile_decode(srv, prompts, configs):
    """Where a decode step's time goes: the served requests' decode chunks
    (their prefill dispatches excluded), run twice on the same requests:
    once without the profiler for the steps' wall time, once under
    ``torch.profiler`` with CUDA activity only (no host-side op tracing)
    for the device's time by kernel. The device's busy share is its time
    over the unprofiled wall time; the profiled window's own wall time is
    printed beside it (what tracing costs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window(prof=None):
        for p, c in zip(prompts, configs):
            srv.submit(p, c)
        srv._admit_slab()  # the prefill, outside the window
        if srv._queue:
            raise AssertionError("profile_decode: the requests did not all fit in the slots")
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        steps0 = srv.timing["decode_steps"]
        while not srv.idle():
            srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        return wall, srv.timing["decode_steps"] - steps0

    wall, steps = window()
    prof = profile(activities=[ProfilerActivity.CUDA])
    pwall, psteps = window(prof)
    if psteps != steps:
        raise AssertionError(f"profile_decode: {steps} steps, then {psteps}")
    dev = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = dev.get(e.key, 0) + t
    busy = sum(dev.values()) / 1e3  # ms
    share = busy / (1e3 * wall)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    print(f"  decode window: {steps} steps in {1e3 * wall:.1f} ms ({1e3 * wall / steps:.3f} ms "
          f"a step) unprofiled, {1e3 * pwall:.1f} ms ({1e3 * pwall / steps:.3f} ms a step) "
          f"under the profiler; device busy {busy:.1f} ms ({busy / steps:.3f} ms a step), "
          f"{100 * share:.1f}% of the unprofiled wall time, idle {100 - 100 * share:.1f}%; "
          f"by kernel, ms a step: "
          + ", ".join(f"{k[:40]} {v / 1e3 / steps:.3f}" for k, v in top))


def phase_fused_layer(records, model, params, prompts, configs, outs):
    """The per-layer kernel path (its decode step split between host and
    device as phase 4's), and an 8-step greedy logits comparison."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
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
    same = sum(int((a == b).sum()) for a, b in zip(outs2, (outs[i] for i in greedy)))
    total = sum(len(a) for a in outs2)
    print(f"  greedy streams, megakernel vs per-layer kernel: {same}/{total} tokens agree")
    profile_decode(srv, prompts[:8], configs[:8])

    # 8-step greedy decode from one prefilled cache: megakernel, per-layer
    # kernel and the plain version on the card, each fed its own argmax.
    greedy_steps("gpt-m", model, srv.params, prompts, "fused", ("fused-layer", "plain"))


def greedy_steps(label, model, sp, prompts, ref_engine, engines, steps=8):
    """``steps`` greedy decode steps of 8 slots from one prefilled cache on
    each engine ("fused", "fused-layer", or "plain": the plain decode on
    the card), each fed its own argmax. Where an engine's pick differs from
    the reference engine's, the reference's margin of its pick over the
    engine's must be below the two engines' logit disagreement in that row
    at that step (what can flip it), and the engine continues from the
    reference's token, so every step's logits are compared on the same
    inputs; the logits must agree within 0.25 of their largest magnitude."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

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

    def run(eng, ref=None):
        cache = cache0._replace(k=cache0.k.clone(), v=cache0.v.clone(),
                                lengths=cache0.lengths.clone())
        tok = logits0.argmax(-1).int()
        act = torch.ones(S, dtype=torch.bool, device=dev)
        lg, tk, ties = [], [], []
        for i in range(steps):
            if eng == "plain":
                logits, cache = plain_step(tok, cache, act)
            else:
                logits, cache = model.decode_slots(sp, tok, cache, act, engine=eng)
            tok = logits.argmax(-1).int()
            lg.append(logits)
            tk.append(tok)
            if ref is not None and (tok != ref[1][i]).any():
                rl = ref[0][i].float()
                diff = (logits.float() - rl).abs().amax(-1)
                for r in (tok != ref[1][i]).nonzero()[:, 0].tolist():
                    gap = (rl[r, ref[1][i][r]] - rl[r, tok[r]]).item()
                    ties.append((gap, diff[r].item()))
                    if not gap < diff[r].item():
                        raise AssertionError(
                            f"{label}: {eng} picks another token than {ref_engine} at step "
                            f"{i}, slot {r}, where the margin {gap} >= their logit "
                            f"disagreement {diff[r].item()}")
                tok = ref[1][i].clone()
        return torch.stack(lg), torch.stack(tk), ties

    ref_l, ref_t, _ = run(ref_engine)
    for eng in engines:
        lgs, tks, ties = run(eng, (ref_l, ref_t))
        err = (lgs - ref_l).abs().max().item()
        agree = (tks == ref_t).float().mean().item()
        print(f"  {label} decode-{ref_engine}-vs-{eng}: max logit err {err:.3e}, "
              f"token agreement {agree:.4f} over {steps} greedy steps x {S} slots; near-ties "
              f"continued from the {ref_engine} token: {len(ties)} (margin / row's logit "
              f"disagreement: {', '.join(f'{x:.3e} / {y:.3e}' for x, y in ties) or '-'})")
        if not (torch.isfinite(lgs).all() and err <= 0.25 * max(1.0, ref_l.abs().max().item())):
            raise AssertionError(f"{label}: {ref_engine} logits disagree with {eng}: {err}")


def phase_fused_layer_xl(prompts):
    """The per-layer engine at gpt-xl width (``XL_CFG``, 4 layers, seeded
    random weights, bf16): 8 greedy steps through ``decode_engine=
    "fused-layer"`` (B5) and the megakernel (B6) against the plain decode
    on the card, under phase 5's rule; B5 must launch 4 times a step."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build

    model = GPTLM(**XL_CFG, flash_min_len=0, compute_dtype=torch.bfloat16)
    sp = model.serving_params(perturbed_params(model, 7, "cuda"))
    _build.reset_launches()
    greedy_steps("gpt-xl", model, sp, prompts, "plain", ("fused-layer", "fused"))
    n = _build.LAUNCHES["decode_block_slab"]
    print(f"  gpt-xl launches: {dict((k, v) for k, v in _build.LAUNCHES.items() if v)}")
    if n != 8 * model.num_layers:
        raise AssertionError(f"gpt-xl fused-layer: decode_block_slab launched {n} times")


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


def paged_requests(vocab, seed):
    """Phase 10's traffic: 8 requests behind one 256-token system prompt
    (16 full blocks) with tails of 20..600 tokens, and 8 of 32..48 tokens
    made of a repeated 8-token pattern (what the drafter feeds on);
    greedy and sampled alternate."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 256)
    prompts = [np.concatenate([system, rng.integers(0, vocab, t)]).astype(np.int32)
               for t in (20, 600, 60, 500, 120, 400, 200, 300)]
    prompts += [np.resize(rng.integers(0, vocab, 8), n).astype(np.int32)
                for n in (32, 34, 36, 38, 40, 42, 44, 48)]
    configs = [
        GenerationConfig(max_new=MAX_NEW) if i % 2 == 0 else
        GenerationConfig(max_new=MAX_NEW, greedy=False, temperature=0.9, top_p=0.95,
                         seed=100 + i)
        for i in range(len(prompts))
    ]
    return prompts, configs


def pick_gap(model, params, prompt, out, i, cfg, kv_dtype="bf16"):
    """The top-2 gap of the pick that chose ``out[i]``, from a dense
    forward of prompt + out[:i] on the card (for an int8/fp8 cache, the
    model the server computes: one prefill whose K/V go through the
    quantizer, ``GPTLM.prefill_slots`` into a ``kv_dtype`` cache): the raw
    logits for a greedy request; for a sampled one the nucleus-masked
    logits/temperature plus the Gumbel noise of the request's (i+1)-th
    draw, replayed from its seed. Returns (gap, tolerance, the dense
    forward's logits)."""
    import torch

    dev = params.embed.device
    toks = torch.from_numpy(np.concatenate([prompt, out[:i]]).astype(np.int32)).to(dev)
    if kv_dtype == "bf16":
        logits = model.apply(params, toks[None])[0, -1].float()
    else:
        one = torch.ones(1, dtype=torch.bool, device=dev)
        logits = model.prefill_slots(params, model.empty_slot_cache(1, kv_dtype, device=dev),
                                     toks[None], torch.tensor([len(toks)], device=dev),
                                     one)[0][0].float()
    dense = logits
    tol = REL_TOL["decode_token_slab"] * max(1.0, logits.abs().max().item())
    if not cfg.greedy:
        lt = logits / cfg.temperature
        keep = nucleus(logits, cfg)[0]
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        for _ in range(i + 1):
            u = torch.rand(lt.shape[-1], generator=gen, device=dev)
        logits = lt.masked_fill(~keep, float("-inf")) - torch.log(-torch.log(u))
    top = torch.topk(logits, 2).values
    return (top[0] - top[1]).item(), tol, dense


def nucleus(logits, cfg):
    """The server's nucleus over one row of logits (``TextServer._pick``):
    (kept [V] bool, the mass ranked before each token [V], each token's
    rank by probability)."""
    import torch

    sl, order = torch.sort(logits.float() / cfg.temperature, descending=True)
    probs = torch.softmax(sl, -1)
    before = torch.empty_like(probs).scatter_(0, order, torch.cumsum(probs, -1) - probs)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(len(order), device=order.device))
    return before < cfg.top_p, before, rank


class PickLog:
    """A server's sampled picks, recorded through ``TextServer._pick``: for
    every sampled row of every pick, the row of logits (f32) and its
    generator's state before the draw, by the generator's seed. So
    ``rows[seed][k]`` is what the request of that seed drew its token k
    from (its (k+1)-th draw, as ``pick_gap`` replays)."""

    def __init__(self, srv):
        self.srv, self.rows = srv, {}
        orig = srv._pick

        def pick(logits, greedy, temp, top_p, gens):
            for slot, gen in enumerate(gens):
                if gen is not None:
                    self.rows.setdefault(gen.initial_seed(), []).append(
                        (logits[slot].float().clone(), gen.get_state()))
            return orig(logits, greedy, temp, top_p, gens)

        srv._pick = pick

    def close(self):
        del self.srv._pick

    def replay(self, row, state, cfg):
        """The server's own sampler on ``row`` with the draw ``state``."""
        import torch

        dev = row.device
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        one = lambda v, dt: torch.tensor([v], dtype=dt, device=dev)  # noqa: E731
        return int(self.srv._pick(row[None], one(False, torch.bool),
                                  one(np.float32(cfg.temperature), torch.float32),
                                  one(np.float32(cfg.top_p), torch.float32), [gen])[0])


def logged_generate(srv, prompts, configs):
    """``srv.generate`` with its sampled picks recorded: (streams, PickLog)."""
    seeds = [c.seed for c in configs if not c.greedy]
    if len(set(seeds)) != len(seeds):
        raise AssertionError("the sampled requests of one call need distinct seeds")
    log = PickLog(srv)
    try:
        return srv.generate(prompts, configs), log
    finally:
        log.close()


def cut_flip(logs, cfg, i, tok_a, tok_b, dense, band=False):
    """Whether two servers' sampled picks at token ``i`` (``tok_a`` by the
    server under test, ``tok_b`` by the reference) part at the nucleus cut
    because their own logits there differ, by what those logits show: both
    drew the same noise; each server's sampler on its own recorded row
    gives its own token; the rows differ by at most the decode tolerance
    (of the reference's row); one of the two tokens is in one nucleus and
    not the other; and ``tok_a`` ranks before ``tok_b`` in the reference's
    order or is the first token past the reference's nucleus. With
    ``band`` (phase 13's flat random-weight nuclei of ~7,000 near-equal
    tokens, where a disagreement of 5e-3 reorders the tokens at the cut),
    ``tok_a`` may also lie further past the reference's cut if it is inside
    the server's nucleus and the reference's mass ranked before it is at
    most ``exp(2 d) top_p + m``: ``d`` the rows' disagreement over the
    temperature, ``m`` the reference's mass of the other tokens whose
    logits lie within ``2 d`` above ``tok_a``'s (each token's probability
    moves by at most a factor ``exp(2 d)`` between the rows, and only those
    tokens can change sides of ``tok_a``). Prints both rows' masses beside
    the dense forward's. Returns (flip, tolerance)."""
    import math

    import torch

    (la, sa), (lb, sb) = logs[0].rows[cfg.seed][i], logs[1].rows[cfg.seed][i]
    tol = REL_TOL["decode_token_slab"] * max(1.0, lb.abs().max().item())
    dis = (la - lb).abs().max().item()
    (ka, ma, _), (kb, mb, rb) = nucleus(la, cfg), nucleus(lb, cfg)
    md = nucleus(dense.to(lb.device), cfg)[1]
    pa, pb = logs[0].replay(la, sa, cfg), logs[1].replay(lb, sb, cfg)
    moved = bool(ka[tok_a] != kb[tok_a]) or bool(ka[tok_b] != kb[tok_b])
    ranked = int(rb[tok_a]) < int(rb[tok_b]) or int(rb[tok_a]) == int(kb.sum())
    reach = ""
    if band and not ranked and not bool(kb[tok_a]) and bool(ka[tok_a]):
        d = dis / cfg.temperature
        zb = lb.float() / cfg.temperature
        near = (zb >= zb[tok_a]) & (zb <= zb[tok_a] + 2 * d)
        near[tok_a] = False
        limit = math.exp(2 * d) * cfg.top_p + torch.softmax(zb, -1)[near].sum().item()
        ranked = mb[tok_a].item() <= limit
        reach = (f"; past the reference's cut by its rows' disagreement: mass before it "
                 f"{mb[tok_a].item():.6f}, at most {limit:.6f} ({int(near.sum())} tokens within "
                 f"{2 * d:.4e} above it): {ranked}")
    flip = (torch.equal(sa, sb) and pa == tok_a and pb == tok_b and dis <= tol and moved
            and ranked)
    print(f"    nucleus (top_p {cfg.top_p}), mass ranked before the tokens {tok_b} / {tok_a}: "
          f"reference {mb[tok_b].item():.6f} / {mb[tok_a].item():.6f}, server "
          f"{ma[tok_b].item():.6f} / {ma[tok_a].item():.6f}, dense forward "
          f"{md[tok_b].item():.6f} / {md[tok_a].item():.6f}; the servers' logits there "
          f"differ by {dis:.4e} (tolerance {tol:.4e}); same draw {torch.equal(sa, sb)}; "
          f"their samplers replayed on their own rows pick {pb} / {pa}; {tok_a} ranks "
          f"{int(rb[tok_a])} in the reference's order, {tok_b} {int(rb[tok_b])}, nucleus "
          f"{int(kb.sum())}{reach}; a flip at the cut: {flip}")
    return flip, tol


def compare_streams(label, model, params, prompts, configs, outs, ref, servers, fresh,
                    kv_dtype="bf16", band=False):
    """Streams equal to ``ref``'s, or diverging only at a near-tie: a top-2
    gap (of the dense forward) below the decode tolerance, or, for a
    sampled request, a flip at the nucleus cut that the two servers'
    recorded logits at that token show (``cut_flip``); with an int8/fp8
    ``kv_dtype`` the dense forward quantizes its K/V as the cache does
    (``pick_gap``). The first round's
    logits come from a replay on ``fresh`` servers (made as the ones that
    made ``outs`` and ``ref``), which must give the same streams. After a
    near-tie at token i, both ``servers`` (the one that made ``outs``, the
    one that made ``ref``) serve the prompt extended by ``ref``'s first i+1
    tokens for the rest of the budget (a sampled request restarts its
    seed's draws), with their picks recorded, and the rest is compared the
    same way, so every token of ``ref`` is checked."""
    same = checked = reruns = 0
    total = sum(len(b) for b in ref)
    work, logs = list(zip(prompts, configs, outs, ref)), None
    while work:
        nxt = []
        for p, c, a, b in work:
            if len(a) != len(b):
                raise AssertionError(f"{label}: streams of {len(a)} and {len(b)} tokens")
            diff = np.flatnonzero(a != b)
            if not len(diff):
                checked += len(b)
                same += not reruns
                continue
            i = int(diff[0])
            gap, tol, dense = pick_gap(model, params, p, b, i, c, kv_dtype)
            kind = "greedy" if c.greedy else "sampled"
            print(f"  {label}: a {len(p)}-token {kind} request diverges at token {i}; "
                  f"top-2 gap there {gap:.4e} (tolerance {tol:.4e})")
            if not gap < tol:
                if c.greedy:
                    raise AssertionError(f"{label}: divergence at a top-2 gap {gap} >= {tol}")
                if logs is None:  # the first round: replay it with the picks recorded
                    ps, cs_ = [q[0] for q in work], [q[1] for q in work]
                    logs = []
                    for make, want in ((fresh[0], [q[2] for q in work]),
                                       (fresh[1], [q[3] for q in work])):
                        got, log = logged_generate(make(), ps, cs_)
                        if not all(np.array_equal(x, y) for x, y in zip(got, want)):
                            raise AssertionError(f"{label}: a fresh server's replay of the "
                                                 "requests gave other streams")
                        logs.append(log)
                flip, tol2 = cut_flip(logs, c, i, int(a[i]), int(b[i]), dense, band)
                if not flip:
                    raise AssertionError(f"{label}: divergence at a top-2 gap {gap} >= {tol}, "
                                         "and not a flip at the nucleus cut that the servers' "
                                         f"logits (within {tol2}) show")
            checked += i + 1
            if i + 1 < len(b):
                nxt.append((np.concatenate([p, b[: i + 1]]).astype(np.int32),
                            dataclasses.replace(c, max_new=len(b) - i - 1)))
        if nxt:
            reruns += 1
            ps, cs_ = [q for q, _ in nxt], [c for _, c in nxt]
            (oa, la), (ob, lb) = (logged_generate(srv, ps, cs_) for srv in servers)
            work, logs = list(zip(ps, cs_, oa, ob)), [la, lb]
        else:
            work = []
    if checked != total:
        raise AssertionError(f"{label}: checked {checked} of {total} tokens")
    print(f"  {label}: {same}/{len(outs)} streams token-identical; {checked} of {total} "
          f"tokens checked ({reruns} rounds of continuations after near-ties)")


def phase_paged_serve(records, model, params):
    """Serve the paged traffic on the slab engine and on three paged
    servers; launches, prefix hits, accepted drafts, pool hygiene and the
    streams are checked."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import TextServer

    prompts, configs = paged_requests(model.vocab_size, 1)
    print(f"  {len(prompts)} requests of {min(map(len, prompts))}..{max(map(len, prompts))} "
          f"tokens, max_new {MAX_NEW}")
    make = {"slab": functools.partial(TextServer, model, params, slots=8, chunk=32)}
    slab_srv = make["slab"]()
    slab = slab_srv.generate(prompts, configs)
    runs, servers = {}, {}
    for label, kw, kernel in (
            ("(a) paged", {}, "decode_token_paged"),
            ("(b) paged+spec", dict(spec_draft=4, spec_ngram=2), "verify_tokens_paged"),
            ("(c) paged fused-layer", dict(decode_engine="fused-layer"), "decode_block_paged")):
        make[label] = functools.partial(TextServer, model, params, slots=8, chunk=32,
                                        paged=True, block_size=BLOCK, prefix_caching=True, **kw)
        srv = make[label]()
        _build.reset_launches()
        t0 = time.perf_counter()
        outs = srv.generate(prompts, configs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        cnt, tm = srv.counters, srv.timing
        ntok = sum(len(o) for o in outs)
        ttft = [srv.stats[i]["ttft_s"] for i in sorted(srv.stats)]
        print(f"  {label}: launches {launches}; counters {cnt}")
        line = (f"  {label}: {srv.kv_blocks} blocks; {ntok} tokens in {wall:.3f} s: "
                f"{ntok / wall:.1f} tokens/s; TTFT mean {1e3 * np.mean(ttft):.1f} ms max "
                f"{1e3 * max(ttft):.1f} ms; prefill total {1e3 * tm['prefill_s']:.1f} ms")
        if tm["decode_steps"]:
            line += (f"; decode {1e3 * tm['decode_s'] / tm['decode_steps']:.3f} ms per step "
                     f"({tm['decode_steps']} steps)")
        if tm["verify_ticks"]:
            line += (f"; verify {1e3 * tm['verify_s'] / tm['verify_ticks']:.3f} ms per tick "
                     f"({tm['verify_ticks']} ticks, {tm['verify_tokens']} tokens, "
                     f"{cnt['spec_tokens_accepted'] / tm['verify_ticks']:.3f} accepted "
                     f"per tick)")
        print(line)
        if launches.get(kernel, 0) < 1:
            raise AssertionError(f"{label} never launched {kernel}")
        records[kernel]["launches"] = launches[kernel]
        if cnt["prefix_cache_hits"] < 1:
            raise AssertionError(f"{label}: no prefix-cache hit")
        if kernel == "verify_tokens_paged" and cnt["spec_tokens_accepted"] < 1:
            raise AssertionError(f"{label}: no draft token accepted")
        if srv._alloc.used_blocks != len(srv._prefix._map):
            raise AssertionError(f"{label}: {srv._alloc.used_blocks} blocks live after "
                                 f"the drain, the radix holds {len(srv._prefix._map)}")
        for o, c in zip(outs, configs):
            if len(o) != c.max_new or o.min() < 0 or o.max() >= model.vocab_size:
                raise AssertionError(f"{label}: bad stream {o}")
        runs[label], servers[label] = outs, srv
    # After the launch counts are read: the continuations launch kernels too.
    for label, ref in (("(a) paged", "slab"), ("(b) paged+spec", "slab"),
                       ("(c) paged fused-layer", "slab"), ("(b) paged+spec", "(a) paged"),
                       ("(c) paged fused-layer", "(a) paged")):
        compare_streams(f"{label} vs {ref}", model, srv.params, prompts, configs, runs[label],
                        slab if ref == "slab" else runs[ref],
                        (servers[label], slab_srv if ref == "slab" else servers[ref]),
                        (make[label], make[ref]))


# Phase 13's servers: (name, paged, TextServer knobs, the kernel it runs).
KV_SERVERS = (("slab", False, {}, "decode_token_slab"),
              ("slab fused-layer", False, dict(decode_engine="fused-layer"), "decode_block_slab"),
              ("paged", True, {}, "decode_token_paged"),
              ("paged+spec", True, dict(spec_draft=4, spec_ngram=2), "verify_tokens_paged"),
              ("paged fused-layer", True, dict(decode_engine="fused-layer"), "decode_block_paged"))
# The JAX package's quality budgets of a quantized cache against the bf16
# one (greedy-stream divergence, tests/test_serve_quantized.py:43), read on
# random weights here, not gated.
DIVERGENCE_BUDGET = {"int8": 0.15, "fp8": 0.25}


def phase_kv_serve(records, label, model, params, kv_dtypes, paged_traffic=True,
                   requests=None):
    """Serve ``model`` with each cache type of ``kv_dtypes`` through
    ``KV_SERVERS``: the slab server (phase 4's requests) and the paged
    servers (phase 10's: prefix cache, speculation, the per-layer engine).
    Each must launch its kernel (the launches of variant
    ``<label>-<kv_dtype>``), the paged ones must hit the prefix cache and
    speculation accept drafts; their streams are held against the plain
    decode (``decode_engine="xla"``) at the same cache type under
    ``compare_streams``' rule. Prints tokens/s and ms per step, and the
    quantized caches' greedy divergence from the bf16 cache's streams
    beside the JAX package's budgets. ``paged_traffic=False`` gives the
    paged servers phase 4's requests too (no shared prefix: the prefix
    cache and the drafts are read, not required); ``requests`` = (prompts,
    configs) gives both the same traffic. A windowed flash model's slab
    server must launch the banded flash forward (its prefill)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import TextServer

    if requests is not None:
        reqs = {False: requests, True: requests}
    else:
        reqs = {False: serve_requests(model.vocab_size, 0),
                True: (paged_requests(model.vocab_size, 1) if paged_traffic
                       else serve_requests(model.vocab_size, 0))}
    streams = {}
    for kv in kv_dtypes:
        # An f32 model's "bf16" layout stores f32.
        shown = "f32" if kv == "bf16" and model.compute_dtype == torch.float32 else kv
        variant = f"{label}-{shown}"

        def maker(paged, **kw):
            extra = dict(paged=True, block_size=BLOCK, prefix_caching=True) if paged else {}
            return functools.partial(TextServer, model, params, slots=8, chunk=32, kv_dtype=kv,
                                     **extra, **kw)

        refs = {}
        for paged in (False, True):
            make = maker(paged, decode_engine="xla")
            srv = make()
            refs[paged] = (srv.generate(*reqs[paged]), srv, make)
        for name, paged, kw, kernel in KV_SERVERS:
            make = maker(paged, **kw)
            srv = make()
            prompts, configs = reqs[paged]
            _build.reset_launches()
            t0 = time.perf_counter()
            outs = srv.generate(prompts, configs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            tm, cnt = srv.timing, srv.counters
            ntok = sum(len(o) for o in outs)
            ttft = [srv.stats[i]["ttft_s"] for i in sorted(srv.stats)]
            line = (f"  {variant} {name}: launches {launches}; {ntok} tokens in {wall:.3f} s: "
                    f"{ntok / wall:.1f} tokens/s; TTFT mean {1e3 * np.mean(ttft):.1f} ms")
            if tm["decode_steps"]:
                line += f"; decode {1e3 * tm['decode_s'] / tm['decode_steps']:.3f} ms per step"
            if tm["verify_ticks"]:
                line += (f"; verify {1e3 * tm['verify_s'] / tm['verify_ticks']:.3f} ms per tick, "
                         f"{cnt['spec_tokens_accepted'] / tm['verify_ticks']:.3f} accepted")
            if paged:
                line += f"; prefix hits {cnt['prefix_cache_hits']}, {srv.kv_blocks} blocks"
            print(line)
            if launches.get(kernel, 0) < 1:
                raise AssertionError(f"{variant} {name} never launched {kernel}")
            records[f"{kernel}[{variant}]"]["launches"] = launches[kernel]
            if model.window is not None and model.attention_impl == "flash" and not paged:
                if launches.get("flash_fwd", 0) < 1:
                    raise AssertionError(f"{variant} {name}: the prefill never launched B3")
                records["flash_fwd[window]"]["launches"] = launches["flash_fwd"]
            if paged and paged_traffic and cnt["prefix_cache_hits"] < 1:
                raise AssertionError(f"{variant} {name}: no prefix-cache hit")
            if (kernel == "verify_tokens_paged" and paged_traffic
                    and cnt["spec_tokens_accepted"] < 1):
                raise AssertionError(f"{variant} {name}: no draft token accepted")
            for o, c in zip(outs, configs):
                if len(o) != c.max_new or o.min() < 0 or o.max() >= model.vocab_size:
                    raise AssertionError(f"{variant} {name}: bad stream {o}")
            streams[(kv, name)] = outs
            ref_outs, ref_srv, ref_make = refs[paged]
            compare_streams(f"{variant} {name} vs xla", model, srv.params, prompts, configs,
                            outs, ref_outs, (srv, ref_srv), (make, ref_make), kv, band=True)
    if "bf16" not in kv_dtypes:
        return
    shown = "f32" if model.compute_dtype == torch.float32 else "bf16"
    for kv in kv_dtypes:
        if kv == "bf16":
            continue
        for name, paged, _, _ in KV_SERVERS:
            greedy = [i for i, c in enumerate(reqs[paged][1]) if c.greedy]
            a, b = streams[(kv, name)], streams[("bf16", name)]
            same = sum(int((a[i] == b[i]).sum()) for i in greedy)
            total = sum(len(b[i]) for i in greedy)
            print(f"  {label}-{kv} {name}: greedy divergence from the {shown} cache "
                  f"{1 - same / total:.4f} of {total} tokens (the JAX package's budget "
                  f"{DIVERGENCE_BUDGET[kv]}, on a trained model; a reading here)")


def greedy_decode_steps(label, model, sp, prompt, ref_engine, engines, steps=64):
    """``steps`` greedy tokens through ``prefill`` / ``decode_step`` on each
    engine, each fed the reference engine's tokens, under
    :func:`greedy_steps`' rule: where an engine's pick differs from the
    reference's, the reference's margin of its pick over the engine's must
    be below the two engines' logit disagreement in that row; the logits
    agree within 0.25 of their largest magnitude."""
    import torch

    logits0, cache0 = model.prefill(sp, prompt)
    first = logits0.argmax(-1).to(prompt.dtype)
    runs = {}
    for eng in (ref_engine, *engines):
        cache = cache0._replace(k=cache0.k.clone(), v=cache0.v.clone())
        tok, lg, tk = first, [], []
        for i in range(steps - 1):
            logits, cache = model.decode_step(sp, tok, cache, engine=eng)
            lg.append(logits)
            tk.append(logits.argmax(-1).to(prompt.dtype))
            tok = runs[ref_engine][1][i] if eng != ref_engine else tk[-1]
        runs[eng] = (torch.stack(lg), torch.stack(tk))
    ref_l, ref_t = runs[ref_engine]
    for eng in engines:
        lgs, tks = runs[eng]
        ties = []
        for i, r in (tks != ref_t).nonzero().tolist():
            rl = ref_l[i, r].float()
            gap = (rl[ref_t[i, r]] - rl[tks[i, r]]).item()
            diff = (lgs[i, r].float() - rl).abs().max().item()
            ties.append((gap, diff))
            if not gap < diff:
                raise AssertionError(f"{label}: {eng} picks another token than {ref_engine} at "
                                     f"step {i}, row {r}, margin {gap} >= disagreement {diff}")
        err = (lgs - ref_l).abs().max().item()
        agree = (tks == ref_t).float().mean().item()
        print(f"  {label} decode_step-{ref_engine}-vs-{eng}: max logit err {err:.3e}, token "
              f"agreement {agree:.4f} over {steps} greedy tokens x {prompt.shape[0]} rows; "
              f"near-ties: {len(ties)} (margin / disagreement: "
              f"{', '.join(f'{x:.3e} / {y:.3e}' for x, y in ties) or '-'})")
        if not (torch.isfinite(lgs).all() and err <= 0.25 * max(1.0, ref_l.abs().max().item())):
            raise AssertionError(f"{label}: {ref_engine} logits disagree with {eng}: {err}")


def phase_single_sequence(records):
    """The single-sequence decode API at gpt-m width: on the RoPE model
    (bf16), 64 greedy tokens of 8 rows through ``prefill`` /
    ``decode_step`` on "fused" (B6 slab) and "fused-layer" (B5) against
    "xla" under ``greedy_decode_steps``' rule, then ``greedy_decode`` on
    each engine (launch counts, valid tokens, agreement printed); then an
    f32 gpt-m model (8 layers, the f32 kernels at gpt-m width): 16 greedy
    tokens on "fused" and "fused-layer" against "xla" under the same rule,
    and ``greedy_decode`` on "auto", which must launch B6."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build

    model = GPTLM(**SERVE_CFG, pos_embedding="rope", compute_dtype=torch.bfloat16)
    sp = model.serving_params(perturbed_params(model, 11, "cuda"))
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, model.vocab_size, (8, 100)).astype(np.int32)).cuda()
    greedy_decode_steps("gpt-m rope", model, sp, prompt, "xla", ("fused", "fused-layer"))
    outs = {}
    for eng, kernel in (("xla", None), ("fused", "decode_token_slab"),
                        ("fused-layer", "decode_block_slab")):
        _build.reset_launches()
        out = model.greedy_decode(sp, prompt, 64, engine=eng)
        torch.cuda.synchronize()
        # xla: the plain decode, no decode kernel (the prefill's flash kernel runs).
        n = _build.LAUNCHES[kernel] if kernel else sum(_build.LAUNCHES[k] for k in DECODE_KERNELS)
        if (kernel and n < 1) or (not kernel and n):
            raise AssertionError(f"greedy_decode engine={eng}: {dict(_build.LAUNCHES)}")
        gen = out[:, 100:]
        if gen.shape != (8, 64) or gen.min() < 0 or gen.max() >= model.vocab_size:
            raise AssertionError(f"greedy_decode engine={eng}: bad tokens {gen}")
        outs[eng] = gen
        print(f"  greedy_decode engine={eng}: 8 x 64 tokens, {n} decode-kernel launches"
              + ("" if eng == "xla" else
                 f", {(gen == outs['xla']).float().mean().item():.4f} of tokens as on xla"))
    f32 = GPTLM(**SERVE_CFG, compute_dtype=torch.float32)
    p32 = f32.serving_params(perturbed_params(f32, 12, "cuda"))
    greedy_decode_steps("f32 gpt-m", f32, p32, prompt[:, :32], "xla", ("fused", "fused-layer"),
                        steps=16)
    _build.reset_launches()
    out = f32.greedy_decode(p32, prompt[:, :16], 16, engine="auto")
    torch.cuda.synchronize()
    if out.shape != (8, 32) or out.min() < 0 or out.max() >= f32.vocab_size or (
            _build.LAUNCHES["decode_token_slab"] < 1):
        raise AssertionError(f"f32 gpt-m on engine=auto: {out}, {dict(_build.LAUNCHES)}")
    print(f"  f32 gpt-m, engine=auto: 8 x 16 greedy tokens, "
          f"{_build.LAUNCHES['decode_token_slab']} launches of B6 (f32)")


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
    x0, y0 = xs32[0], ys32[0]
    records["fused_mlp_step"] = dict(
        max_abs_err=err1,
        ms=cuda_ms(lambda: fm.fused_train_step(t1, x0, y0, learning_rate=MLP_LR), 200),
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
    # A diagnostic beside B1's time, which is a call from Python as the bench
    # makes it: the same launches replayed from a CUDA graph, the kernel
    # without the host's part of a call.
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(50):
            fm.fused_train_step(t1, x0, y0, learning_rate=MLP_LR)
    graph_ms = cuda_ms(graph.replay, 10, 2) / 50
    print(f"  fused_mlp_step {records['fused_mlp_step']['ms']:.4f} ms a call from Python; "
          f"{graph_ms:.4f} ms a launch replayed from a CUDA graph")
    print(f"  epoch kernel: {1e3 * records['fused_mlp_epoch']['ms'] / steps:.3f} us per step "
          f"against {1e3 * records['fused_mlp_epoch']['bound_ms'] / steps:.3f} us bound")

    mlp_probes(base, xs32, ys32, xs16, ys16, records, graph_ms)

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


MLP_SPLIT_SLOTS = 12  # csrc/mlp_probe.cuh
# The phases of a step as each probe build stamps them.
MLP_PHASES = {
    "fused_mlp_v1_probe": ("forward", "logits share", "grid barrier + share sum", "softmax",
                           "dz1/db2/cost", "update W2/b1/b2", "dW1 + W1"),
    "fused_mlp_probe": ("forward products", "forward sums + sigmoid", "logits share + labels",
                        "grid barrier + share sum", "softmax/dlogits/dz1",
                        "batch sums + W2/b1/b2", "dW1 products",
                        "dW1 slice sums + W1 + copies issued"),
}


def mlp_split(module, launch):
    """Run ``launch(lib)`` (one kernel launch of the probe build ``module``)
    and read its stamps (CTA 0): ``({phase: us}, kernel us, SM cycles per
    ns)`` for the whole launch."""
    import ctypes

    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    lib = fm.kernels(module)
    launch(lib)
    out = (ctypes.c_ulonglong * (MLP_SPLIT_SLOTS + 2))()
    lib.mlp_split.argtypes = [ctypes.c_void_p]
    lib.mlp_split.restype = ctypes.c_int
    _build.check(lib.mlp_split(ctypes.addressof(out)), f"{module} split")
    cycles, ns = out[MLP_SPLIT_SLOTS], out[MLP_SPLIT_SLOTS + 1]
    rate = cycles / ns
    phases = {name: out[k] / rate / 1e3 for k, name in enumerate(MLP_PHASES[module])}
    return phases, ns / 1e3, rate


def print_split(label, phases, total_us, steps, rate):
    per = {k: v / steps for k, v in phases.items()}
    body = ", ".join(f"{k} {v:.3f}" for k, v in per.items())
    print(f"  split of a step, {label} (us, CTA 0, SM clock {rate:.3f} GHz): {body}; "
          f"sum {sum(per.values()):.3f}; the launch {total_us / steps:.3f} a step")


def mlp_probes(base, xs32, ys32, xs16, ys16, records, graph_ms):
    """Phase 7's measurements of the MLP kernels' insides: the split of an
    epoch step by phase (the PR-2 kernel and the current one, bf16 and f32
    streams; the current one also without its copies and at B=1), B1's
    overhead beside its step, the layout of x in shared memory, and the
    barrier options (a) grid, (b) cluster."""
    import ctypes

    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    steps = xs16.shape[0]

    def fresh():
        return fm.FusedState(*(t.clone() for t in base))

    for module, label in (("fused_mlp_v1_probe", "PR-2 kernel"),
                          ("fused_mlp_probe", "current kernel")):
        for kind, xs, ys in (("bf16", xs16, ys16), ("f32", xs32, ys32)):
            st = fresh()
            phases, total, rate = mlp_split(
                module, lambda lib: fm.launch_epoch(lib, st, xs, ys, MLP_LR))
            print_split(f"{label}, epoch, {kind} stream", phases, total, steps, rate)
    # The same launches without the copies of x after the first fills
    # (the steps compute on stale batches): what the copies cost.
    lib = fm.kernels("fused_mlp_probe")
    lib.mlp_probe_flags.argtypes = [ctypes.c_int]
    lib.mlp_probe_flags.restype = ctypes.c_int
    _build.check(lib.mlp_probe_flags(1), "mlp_probe_flags")
    for kind, xs, ys in (("bf16", xs16, ys16), ("f32", xs32, ys32)):
        st = fresh()
        phases, total, rate = mlp_split(
            "fused_mlp_probe", lambda lib: fm.launch_epoch(lib, st, xs, ys, MLP_LR))
        print_split(f"current kernel, epoch, {kind} stream, no copies after the first",
                    phases, total, steps, rate)
    _build.check(lib.mlp_probe_flags(0), "mlp_probe_flags")
    # The fixed cost of a step: the tiny probe's shapes (B=1, 32->100->10).
    tiny = fm.FusedState(torch.zeros(32, 100, device=base.w1.device),
                         torch.zeros(1, 100, device=base.w1.device),
                         torch.zeros(100, 10, device=base.w1.device),
                         torch.zeros(1, 10, device=base.w1.device))
    tx = torch.rand(steps, 1, 32, device=base.w1.device)
    ty = torch.zeros(steps, 1, 10, device=base.w1.device)
    ty[..., 0] = 1
    phases, total, rate = mlp_split(
        "fused_mlp_probe", lambda lib: fm.launch_epoch(lib, tiny, tx, ty, MLP_LR))
    print_split("current kernel, epoch, B=1, 32->100->10", phases, total, steps, rate)
    # B1: its one step inside the launch, and what the launch adds.
    st = fresh()
    phases, total, rate = mlp_split(
        "fused_mlp_probe", lambda lib: fm.launch_step(lib, st, xs32[0], ys32[0], MLP_LR))
    print_split("current kernel, step (B1)", phases, total, 1, rate)
    # The overhead of a B1 call. On the card: a launch replayed from a graph
    # less an f32 step of B2 at the same shapes (CUDA-event means of the
    # package's build). On the host: the host clock's time of a call, and of
    # the launcher alone given the same arguments (the rest is the wrapper's
    # Python); a call from Python takes the longer of the host's and the
    # card's times.
    t = fresh()
    f32_step = 1e3 * cuda_ms(lambda: fm.fused_epoch(t, xs32, ys32, learning_rate=MLP_LR),
                             5, 1) / steps
    b1_us, graph_us = 1e3 * records["fused_mlp_step"]["ms"], 1e3 * graph_ms
    x0, y0 = xs32[0], ys32[0]
    lib = fm.kernels("fused_mlp")
    stream = fm._stream(x0)
    shares = fm._workspace(lib, *x0.shape, *t.w2.shape, False, x0.device, stream)
    cost = torch.empty((), device=x0.device)
    args = (x0.data_ptr(), y0.data_ptr(), *(p.data_ptr() for p in t), cost.data_ptr(),
            shares.data_ptr(), *x0.shape, *t.w2.shape, MLP_LR, stream)
    call_us = host_us(lambda: fm.fused_train_step(t, x0, y0, learning_rate=MLP_LR))
    raw_us = host_us(lambda: lib.mlp_step(*args))
    print(f"  B1: {b1_us:.3f} us a call from Python; on the card {graph_us:.3f} a launch from "
          f"a graph = an f32 step {f32_step:.3f} (B2, f32 stream) + {graph_us - f32_step:.3f} "
          f"of launch, parameter load/store and first copies (in the kernel, outside the "
          f"step's phases: {total - sum(phases.values()):.3f}); on the host {call_us:.3f} a "
          f"call = the launcher {raw_us:.3f} + the wrapper {call_us - raw_us:.3f}")

    # How x sits in shared memory at the reference shapes, as the launcher
    # plans it.
    dev = base.w1.device
    print(f"  x in shared memory at the reference shapes: bf16 "
          f"{fm.smem_layout(100, 784, 100, 10, torch.bfloat16, dev.index)}, f32 "
          f"{fm.smem_layout(100, 784, 100, 10, torch.float32, dev.index)} "
          f"(bytes a CTA, slots, resident)")

    # The barrier options at the tiny probe's exchange (B=1: 10 floats a
    # CTA) and at the reference's (B=100: 1000): (a) the cooperative grid
    # of 25 CTAs of 4 units; (b) one cluster of 15 CTAs of 7 units, or of 8
    # CTAs of 13.
    fn = fm.kernels("fused_mlp_probe").probe_exchange
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    out = torch.empty(512, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n in (10, 1000):
        row = []
        for cluster, nblk in ((0, 25), (1, 15), (1, 8)):
            shares = torch.empty(2 * nblk * n, device=dev)
            ms = cuda_ms(lambda: _build.check(
                fn(cluster, nblk, n, steps, shares.data_ptr(), out.data_ptr(), stream),
                "probe_exchange"), 5, 1)
            row.append(f"{'(b) cluster' if cluster else '(a) grid'} of {nblk} "
                       f"{1e3 * ms / steps:.3f}")
        print(f"  barrier + share exchange of {n} floats a CTA, us a step: {', '.join(row)}")


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
    trajectory = [float(ln.split()[-1]) for ln in lines if ln.startswith("Test-Accuracy:")]
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
    records["mlp_train_single"] = dict(plain_ex_s=2 * n / wall, trajectory=trajectory)


def phase_mlp_bench(records, ds):
    """The port's bench for every impl; the step impl's launches must
    equal the steps it ran."""
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.ops import _build

    for argv, kernel in ((["--impl", "pallas-epoch"], "fused_mlp_epoch"),
                         (["--impl", "pallas", "--epochs-per-dispatch", "1"], "fused_mlp_step"),
                         (["--impl", "xla", "--epochs-per-dispatch", "1",
                           "--timed-dispatches", "1"], None)):
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


def bwd_inputs(b, l, hq, hkv, d, dtype, ragged, with_dlse, g, dev, window=None):
    """Seeded q/k/v/dO, the forward's out and lse (causal, with ``window``),
    delta, kv_lens."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    q, do = (torch.randn(b, l, hq, d, device=dev, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, l, hkv, d, device=dev, generator=g).to(dtype) for _ in range(2))
    lens = (torch.randint(1, l + 1, (b,), device=dev, generator=g, dtype=torch.int32)
            if ragged else None)
    o, lse = flash_attention_with_lse(q, k, v, causal=True, window=window, kv_lens=lens)
    delta = (do.float() * o.float()).sum(-1)
    if with_dlse:
        delta = delta - torch.randn(b, l, hq, device=dev, generator=g)
    return q, k, v, do, o, lse, delta, lens


def check_bwd(label, got, ref, rel):
    """Each of ``got``'s outputs within ``rel`` of max(1, |ref|) of the
    matching output of ``ref``. Returns the largest error."""
    worst = 0.0
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        if a is None:
            continue
        err = (a.float() - r.float()).abs().max().item()
        tol = rel * max(1.0, r.float().abs().max().item())
        print(f"  {label} {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{label} {name} disagrees: {err} > {tol}")
        worst = max(worst, err)
    return worst


def phase_bwd_kernels(records):
    """B4a / B4b / B4c against the plain backward, at the training path's
    shapes and at small shapes over the kernels' domain, then timed."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    errs = {n: 0.0 for n in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")}
    cases = (  # (B, L, Hq, Hkv, D, dtype, kv_lens, lse cotangent)
        (16, 1024, 8, 8, 64, torch.float32, False, False),  # the training path's shapes
        (3, 200, 8, 2, 128, torch.bfloat16, True, True),
        (3, 77, 8, 2, 64, torch.float32, True, True),
        (2, 130, 4, 4, 128, torch.float32, False, True),
        (3, 100, 8, 8, 64, torch.bfloat16, True, False),
    )
    main = None
    for b, l, hq, hkv, d, dt, ragged, dlse in cases:
        q, k, v, do, o, lse, delta, lens = bwd_inputs(b, l, hq, hkv, d, dt, ragged, dlse, g, dev)
        kw = dict(causal=True, kv_lens=lens)
        ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, lens, True)
        fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        label = (f"B={b} L={l} Hq={hq} Hkv={hkv} D={d} {str(dt)[6:]} "
                 f"kv_lens={'yes' if ragged else 'no'} dlse={'yes' if dlse else 'no'}")
        print(f"  {label}:")
        rel = REL_TOL["flash_bwd_fused"] if dt == torch.float32 else BWD_BF16_TOL
        errs["flash_bwd_fused"] = max(errs["flash_bwd_fused"],
                                      check_bwd("fused vs plain", fused, ref, rel))
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"],
                                   check_bwd("dq vs plain", (dq, None, None), ref, rel))
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"],
                                    check_bwd("dkv vs plain", (None, dk, dv), ref, rel))
        check_bwd("fused vs dq+dkv", fused, (dq, dk, dv), rel)
        if main is None:
            main = (q, k, v, do, o, lse, delta)
        del ref, fused

    # Times at the training path's shapes; the bound from these inputs.
    q, k, v, do, o, lse, delta = main
    b, l, h, d = q.shape
    pairs = b * h * l * (l + 1) // 2  # causal, no kv_lens
    io = 4 * q.numel()  # each of q, k, v, dO, dq, dk, dv (f32)
    rows = 4 * lse.numel()  # lse, delta
    fl = dict(flash_bwd_fused=5, flash_bwd_dq=3, flash_bwd_dkv=4)
    nbytes = dict(flash_bwd_fused=7 * io + 2 * rows, flash_bwd_dq=5 * io + 2 * rows,
                  flash_bwd_dkv=6 * io + 2 * rows)
    calls = dict(
        flash_bwd_fused=lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True),
        flash_bwd_dq=lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
        flash_bwd_dkv=lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True),
    )
    plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True), 5)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    choice = getattr(torch, "_fused_sdp_choice", None)
    names = {int(v): k for k, v in torch.nn.attention.SDPBackend.__members__.items()}
    backend = ("not reported" if choice is None else
               names.get(int(choice(qt, kt, vt, None, 0.0, True)), "unknown"))
    lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
    print(f"  library yardstick: SDPA backward (causal, f32, backend {backend}): {lib_ms:.4f} ms")
    # The forward the training step runs: checked against its plain version
    # on these inputs, then timed alone.
    print(f"  flash_fwd at the training shapes (B={b} L={l} H={h} D={d} f32 causal):")
    fwd_work = (4 * (4 * q.numel() + lse.numel()), 4 * d * pairs)
    with torch.no_grad():
        out, out_lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max((out - ref).abs().max().item(), (out_lse - ref_lse).abs().max().item())
        check_error("flash_fwd", err, ref.abs().max().item())
        del out, out_lse, ref, ref_lse
        fwd = dict(max_abs_err=err,
                   ms=cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, causal=True)),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 5),
                   sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True)),
                   **split_tf32_bound(*fwd_work))
    records["flash_fwd"]["train_shape"] = fwd
    records["flash_fwd"]["max_abs_err"] = max(records["flash_fwd"]["max_abs_err"], err)
    print(f"  flash_fwd: kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, SDPA "
          f"{fwd['sdpa_ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}, "
          f"{fwd['bound_peak']}; {bound(*fwd_work, PEAK_F32)['bound_ms']:.4f} ms at the f32 "
          f"CUDA cores)")
    for name, fn in calls.items():
        work = (nbytes[name], 2 * d * pairs * fl[name])
        records[name] = dict(
            max_abs_err=errs[name], ms=cuda_ms(fn), plain_ms=plain_ms,
            library_ms=lib_ms if name == "flash_bwd_fused" else None,
            **split_tf32_bound(*work),
        )
        r = records[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bound_peak']}; {bound(*work, PEAK_F32)['bound_ms']:.4f} ms at the f32 "
              f"CUDA cores)")
    bwd_window_kernels(records, g)
    dq_at_xl(records, g)
    bwd_d32_kernels(records, g)
    flash_narrow_bwd(records)


def band_pairs(l, w):
    """(q, k) pairs a (batch, head) keeps under causal + window ``w``:
    ``w (w + 1) / 2 + (l - w) w`` for w <= l."""
    w = min(w, l)
    return w * (w + 1) // 2 + (l - w) * w


def bwd_window_kernels(records, g):
    """The backward kernels' window variants at the training shapes (B=16,
    L=1024, 8 heads of 64, f32): B4b and B4c at W=WINDOW (banded: the
    pair the auto rule takes) and B4a at 2 WINDOW (4 W > L: the fused
    kernel), each against the plain backward with the same window at
    REL_TOL, then timed beside the band's bound, the plain backward and,
    as a yardstick, the backward of SDPA with the band as a boolean
    mask."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    b, l, h, d = 16, 1024, 8, 64
    # (window, the records its kernels fill): the banded pair, then B4a.
    for w, recs in ((WINDOW, ("flash_bwd_dq[window]", "flash_bwd_dkv[window]")),
                    (2 * WINDOW, ("flash_bwd_fused[window-512]",))):
        q, k, v, do, o, lse, delta, _ = bwd_inputs(b, l, h, h, d, torch.float32, False, False, g,
                                                   dev, window=w)
        kw = dict(causal=True, window=w)
        pair = not fa.resolve_fused(None, b * h, l, d, w)
        print(f"  W={w} (B={b} L={l} H={h} D={d} f32; banded {fa.use_banding(w, l)}, the auto "
              f"rule takes the {'pair' if pair else 'fused kernel'}):")
        ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True, w)
        calls = {"flash_bwd_fused": lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw),
                 "flash_bwd_dq": lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw), None,
                                          None),
                 "flash_bwd_dkv": lambda: (None, *fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                                   **kw))}
        errs = {rec: check_bwd(f"{rec} vs plain", calls[FLASH_WINDOWS[rec][0]](), ref,
                               REL_TOL[FLASH_WINDOWS[rec][0]]) for rec in recs}
        del ref
        plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True, w),
                           3)
        pos = torch.arange(l, device=dev)
        band = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
        dot = do.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
        print(f"  library yardstick: SDPA backward with the band mask (W={w}, f32): "
              f"{lib_ms:.4f} ms")
        pairs = b * h * band_pairs(l, w)
        io, rows = 4 * q.numel(), 4 * lse.numel()
        for rec in recs:
            base = FLASH_WINDOWS[rec][0]
            fl = {"flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[base]
            nbytes = {"flash_bwd_fused": 7, "flash_bwd_dq": 5, "flash_bwd_dkv": 6}[base] * io
            work = (nbytes + 2 * rows, 2 * d * pairs * fl)
            records[rec] = r = dict(max_abs_err=errs[rec], ms=cuda_ms(calls[base]),
                                    plain_ms=plain_ms,
                                    library_ms=lib_ms if base == "flash_bwd_fused" else None,
                                    **split_tf32_bound(*work))
            print(f"  {rec}: kernel {r['ms']:.4f} ms (causal {records[base]['ms']:.4f}), plain "
                  f"{plain_ms:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {r['bound_peak']})")
        del q, k, v, do, o, lse, delta, qt, kt, vt, out


def bwd_d32_kernels(records, g):
    """The backward kernels at head_dim 32, at the training shapes of
    phase 18 (f32, causal): B4a at gpt-s-L512-flash's (B=32, L=512, 8 heads
    of 32) and B4b + B4c at gpt-s-L2048-flash-W512's (B=8, L=2048, W=512:
    banded, the pair the auto rule takes), each against the plain backward
    at REL_TOL, then timed beside the bound of the pairs the mask keeps, the
    plain backward and, as a yardstick, SDPA's backward with the same mask.
    Recorded under ``FLASH_D32``."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    h, d = S_CFG["num_heads"], S_CFG["model_dim"] // S_CFG["num_heads"]
    for (name, l, b, w), recs in zip(S_TRAIN, (("flash_bwd_fused[d32]",),
                                               ("flash_bwd_dq[d32-window]",
                                                "flash_bwd_dkv[d32-window]"))):
        q, k, v, do, o, lse, delta, _ = bwd_inputs(b, l, h, h, d, torch.float32, False, False, g,
                                                   dev, window=w)
        kw = dict(causal=True, window=w)
        pair = not fa.resolve_fused(None, b * h, l, d, w)
        if pair != (len(recs) == 2):
            raise AssertionError(f"{name}: the auto rule does not take the expected backward")
        print(f"  {name} (B={b} L={l} H={h} D={d} f32, W={w}; the auto rule takes the "
              f"{'pair' if pair else 'fused kernel'}):")
        ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True, w)
        calls = {"flash_bwd_fused": lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw),
                 "flash_bwd_dq": lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw), None,
                                          None),
                 "flash_bwd_dkv": lambda: (None, *fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                                   **kw))}
        errs = {rec: check_bwd(f"{rec} vs plain", calls[FLASH_D32[rec][0]](), ref,
                               REL_TOL[FLASH_D32[rec][0]]) for rec in recs}
        del ref
        plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True, w),
                           2)
        pos = torch.arange(l, device=dev)
        mask = pos[:, None] >= pos[None, :]
        if w is not None:
            mask &= pos[:, None] - pos[None, :] < w
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
        print(f"  library yardstick: SDPA backward with the mask (f32): {lib_ms:.4f} ms")
        pairs = b * h * band_pairs(l, w or l)
        io, rows = 4 * q.numel(), 4 * lse.numel()
        for rec in recs:
            base = FLASH_D32[rec][0]
            fl = {"flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[base]
            nbytes = {"flash_bwd_fused": 7, "flash_bwd_dq": 5, "flash_bwd_dkv": 6}[base] * io
            # SDPA's backward computes the fused kernel's function; no call
            # computes dq or dk/dv alone.
            records[rec] = r = dict(max_abs_err=errs[rec], ms=cuda_ms(calls[base], 10),
                                    plain_ms=plain_ms,
                                    library_ms=lib_ms if base == "flash_bwd_fused" else None,
                                    **split_tf32_bound(nbytes + 2 * rows, 2 * d * pairs * fl))
            print(f"  {rec}: kernel {r['ms']:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{r['bound_peak']})")
        fwd_ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, **kw), 10)
        records["flash_fwd[d32]"].setdefault("train_ms", {})[name] = fwd_ms
        print(f"  flash_fwd[d32] at these shapes: {fwd_ms:.4f} ms")
        del q, k, v, do, o, lse, delta, qt, kt, vt, out


def dq_at_xl(records, g):
    """B4b (and B4c beside it) at the gpt-xl-L1024 attention shapes (B=16,
    L=1024, 16 heads of 128, f32, causal): against the plain backward at
    REL_TOL before timing, then timed; B3 at the same shapes against its
    plain version, then timed beside the plain version and SDPA. Recorded
    under ``FLASH_XL_SELECTIVE`` (and B4b/B4c under their records'
    ``gpt_xl``)."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    b, l, h, d = 16, XL_CFG["max_len"], XL_CFG["num_heads"], XL_CFG["model_dim"] // XL_CFG["num_heads"]
    q, k, v, do, o, lse, delta, _ = bwd_inputs(b, l, h, h, d, torch.float32, False, False, g, dev)
    print(f"  gpt-xl-L1024 attention shapes (B={b} L={l} H={h} D={d} f32 causal), the split "
          f"pair by resolve_fused: {not fa.resolve_fused(None, b * h, l, d)}:")
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    errs = {"flash_bwd_dq": check_bwd("dq vs plain", (dq, None, None), ref, REL_TOL["flash_bwd_dq"]),
            "flash_bwd_dkv": check_bwd("dkv vs plain", (None, dk, dv), ref,
                                       REL_TOL["flash_bwd_dkv"])}
    del ref, dq, dk, dv
    plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True), 3, 1)
    pairs = b * h * l * (l + 1) // 2
    io, rows = 4 * q.numel(), 4 * lse.numel()
    for name, fn, nfl, nb in (
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True), 3,
             5 * io + 2 * rows),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True), 4,
             6 * io + 2 * rows)):
        work = (nb, 2 * d * pairs * nfl)
        r = dict(max_abs_err=errs[name], ms=cuda_ms(fn, 10), plain_ms=plain_ms,
                 **split_tf32_bound(*work))
        records[name]["gpt_xl"] = r
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], errs[name])
        # No one call computes dq or dk/dv alone.
        records[f"{name}[xl-selective]"] = dict(r, library_ms=None)
        print(f"  {name} at gpt-xl-L1024: kernel {r['ms']:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_peak']}; "
              f"{bound(*work, PEAK_F32)['bound_ms']:.4f} ms at the f32 CUDA cores)")
    del do, o, lse, delta
    with torch.no_grad():
        out, out_lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max((out - ref).abs().max().item(), (out_lse - ref_lse).abs().max().item())
        check_error("flash_fwd", err, ref.abs().max().item())
        del out, out_lse, ref, ref_lse
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        work = (4 * (4 * q.numel() + b * l * h), 4 * d * pairs)
        records["flash_fwd[xl-selective]"] = r = dict(
            max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, causal=True)),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 3, 1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      is_causal=True)),
            **split_tf32_bound(*work))
    print(f"  flash_fwd at gpt-xl-L1024: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{r['bound_peak']}; {bound(*work, PEAK_F32)['bound_ms']:.4f} ms at the f32 CUDA "
          f"cores)")


def unigram_perplexity(tokens, vocab):
    """exp of the empirical token entropy of ``tokens``."""
    counts = np.bincount(tokens.ravel(), minlength=vocab).astype(np.float64)
    p = counts[counts > 0] / counts.sum()
    return float(np.exp(-(p * np.log(p)).sum()))


def phase_train_gradients(model, params, toks):
    """Full-model gradients on one batch, flash attention vs dense, leaf by
    leaf within GRAD_TOL of each leaf's largest magnitude."""
    import copy

    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    dense = copy.copy(model)
    dense.attention_impl = "xla"
    lf, gf = lm_value_and_grad(model, params, toks)
    ld, gd = lm_value_and_grad(dense, params, toks)
    torch.cuda.synchronize()
    names = ["embed", "pos", *(f"blocks.{n}" for n in params.blocks._fields), "lnf_scale",
             "lnf_bias"]
    print(f"  loss flash {float(lf):.6f}, dense {float(ld):.6f}")
    worst = 0.0
    for name, a, r in zip(names, tree_leaves(gf), tree_leaves(gd)):
        err = (a - r).abs().max().item()
        scale = r.abs().max().item()
        worst = max(worst, err / scale)
        if name.split(".")[-1] in ("wq", "wk", "wv"):
            print(f"  grad {name}: max|dense| {scale:.3e}, max|flash - dense| {err:.3e}")
        if not (scale > 0 and err <= GRAD_TOL * scale):
            raise AssertionError(f"gradient {name}: flash vs dense {err} > {GRAD_TOL} * {scale}")
    print(f"  all {len(names)} gradient leaves within {GRAD_TOL} of their largest "
          f"magnitude (worst {worst:.3e})")


def phase_train(records):
    """(a) gpt-m-L1024-flash trained through LMTrainer.run() on the card."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    ds = markov_corpus(**TRAIN_CORPUS)
    uni = unigram_perplexity(ds.train.tokens, TRAIN_CORPUS["vocab"])
    model = GPTLM(**SERVE_CFG, compute_dtype=torch.bfloat16)
    lines = []
    tr = LMTrainer(model, ds, TrainConfig(**TRAIN_CFG), eval_batch=TRAIN_EVAL_BATCH,
                   print_fn=lines.append)
    steps = ds.train.num_examples // TRAIN_CFG["batch_size"]
    print(f"  {ds.train.num_examples} training sequences of {ds.train.seq_len} tokens, "
          f"{steps} steps an epoch, unigram perplexity of the split {uni:.2f}")
    # At init wo and w_down are zero, so nothing reaches wq/wk/wv: the
    # gradients are compared at perturbed parameters (every leaf nonzero).
    toks = torch.from_numpy(ds.train.tokens[: TRAIN_CFG["batch_size"]]).cuda()
    phase_train_gradients(model, perturbed_params(model, 5, "cuda"), toks)
    del toks
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"  launches on the training path: {launches}")
    epochs = TRAIN_CFG["epochs"]
    evals = epochs * -(-ds.validation.num_examples // TRAIN_EVAL_BATCH)
    n = model.num_layers
    want = {"flash_fwd": n * (epochs * steps + evals), "flash_bwd_fused": n * epochs * steps}
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    records["flash_bwd_fused"]["launches"] = launches["flash_bwd_fused"]
    for line in [ln for ln in lines if not ln.startswith("Step:")] + lines[:1]:
        print(f"  | {line}")
    avg = [float(ln.split("AvgTime:")[1].rstrip("ms")) for ln in lines if ln.startswith("Step:")]
    ppls = [h["perplexity"] for h in tr.history]
    tokens_step = TRAIN_CFG["batch_size"] * ds.train.seq_len
    for e in range(epochs):
        ms = avg[(e + 1) * (len(avg) // epochs) - 1]
        print(f"  epoch {e + 1}: {ms:.2f} ms a step, {tokens_step / ms * 1e3:.1f} tokens/s, "
              f"held-out perplexity {ppls[e]:.4f}")
    records["flash_bwd_fused"]["step_ms"] = ms
    attn = n * (records["flash_fwd"]["train_shape"]["ms"] + records["flash_bwd_fused"]["ms"])
    print(f"  attention kernels (phase 11 times at these shapes, {n} layers): {attn:.2f} ms "
          f"a step, {100 * attn / ms:.1f}% of the last epoch's {ms:.2f} ms")
    print(f"  run of {epochs} epochs ({res['global_step']} steps and {epochs} evaluations) "
          f"in {wall:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; final cost "
          f"{res['final_cost']:.4f}")
    if lines[-1] != "Done" or not np.isfinite([res["final_cost"], *ppls]).all():
        raise AssertionError(f"the training run failed: {lines[-3:]}")
    if not all(b < a for a, b in zip(ppls, ppls[1:])):
        raise AssertionError(f"held-out perplexity did not fall every epoch: {ppls}")
    if not ppls[-1] < uni:
        raise AssertionError(f"perplexity {ppls[-1]} not below the unigram {uni}")
    print(f"  oracle met: perplexity fell every epoch, {ppls[-1]:.4f} < unigram {uni:.2f}")


def phase_copy_task(records):
    """(b) The copy task through the kernels: the fused backward (the auto
    rule), then the dq + dk/dv pair (``flash_fused=False``)."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    runs = {}
    for label, fused, kernels in (("fused", None, ("flash_bwd_fused",)),
                                  ("split", False, ("flash_bwd_dq", "flash_bwd_dkv"))):
        tr = LMTrainer(GPTLM(**COPY_CFG, flash_fused=fused, compute_dtype=torch.bfloat16),
                       copy_corpus(**COPY_CORPUS),
                       TrainConfig(epochs=6, batch_size=64, optimizer="adam",
                                   learning_rate=3e-3, log_frequency=10**9),
                       print_fn=lambda *a: None)
        _build.reset_launches()
        tr.run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        ppls = [h["perplexity"] for h in tr.history]
        print(f"  {label}: launches {launches}; perplexity "
              f"{', '.join(f'{p:.3f}' for p in ppls)}")
        if label == "split" and "flash_bwd_fused" in launches:
            raise AssertionError("copy task (split): the fused kernel launched")
        for k in kernels:
            if launches.get(k, 0) != tr.model.num_layers * tr.global_step:
                raise AssertionError(f"copy task ({label}): {k} launched {launches.get(k)}")
            if label == "split":
                records[k]["launches"] = launches[k]
        if not (ppls[-1] < 0.75 * ppls[0] and ppls[-1] < 40):
            raise AssertionError(f"copy-task oracle missed ({label}): {ppls}")
        runs[label] = ppls
    gap = max(abs(a - b) / b for a, b in zip(runs["fused"], runs["split"]))
    print(f"  oracle met on both; fused vs split perplexities within {gap:.2e} (relative)")


def phase_train_xl(records):
    """(c) gpt-xl-L1024-flash-remat (``XL_CFG``, remat, bf16) trained for a
    few steps through ``LMTrainer.run()``: batch 16, ``adam(1e-3)``, phase
    12(a)'s corpus at 1024 tokens. Its dq partials (2.1 GB) exceed the
    fused backward's cap, so each layer's backward is B4b + B4c: each must
    launch 4 times a step, B4a never; the loss must be finite and fall."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    batch, steps = 16, XL_TRAIN_STEPS
    model = GPTLM(**XL_CFG, remat=True, compute_dtype=torch.bfloat16)
    d, h, n = model.model_dim, model.num_heads, model.num_layers
    if fa.resolve_fused(None, batch * h, XL_CFG["max_len"], d // h):
        raise AssertionError("gpt-xl-L1024: resolve_fused took the fused backward")
    ds = markov_corpus(**{**TRAIN_CORPUS, "num": batch * steps + 64, "n_val": 32,
                          "n_test": 32})
    lines = []
    tr = LMTrainer(model, ds, TrainConfig(epochs=1, batch_size=batch, optimizer="adam",
                                          learning_rate=1e-3, log_frequency=1),
                   eval_batch=8, print_fn=lines.append)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"  launches: {launches}")
    want = n * tr.global_step
    if (tr.global_step != steps or launches.get("flash_bwd_dq") != want
            or launches.get("flash_bwd_dkv") != want or "flash_bwd_fused" in launches):
        raise AssertionError(f"gpt-xl training: {tr.global_step} steps, launches {launches}; "
                             f"want B4b and B4c {n} a step and no B4a")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        records[name]["launches"] = launches[name]
    costs = [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in lines
             if ln.startswith("Step:")]
    ms = [float(ln.split("AvgTime:")[1].rstrip("ms")) for ln in lines if ln.startswith("Step:")]
    print(f"  {steps} steps of {batch} x {XL_CFG['max_len']} tokens: cost "
          f"{', '.join(f'{c:.4f}' for c in costs)}; ms a step (from step 3) "
          f"{np.mean(ms[2:]):.2f} ({', '.join(f'{m:.1f}' for m in ms)}); "
          f"{batch * XL_CFG['max_len'] / np.mean(ms[2:]) * 1e3:.1f} tokens/s; run {wall:.2f} s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    attn = n * (records["flash_bwd_dq"]["gpt_xl"]["ms"] + records["flash_bwd_dkv"]["gpt_xl"]["ms"])
    print(f"  B4b + B4c (phase 11 times at these shapes, {n} layers): {attn:.2f} ms a step, "
          f"{100 * attn / np.mean(ms[2:]):.1f}% of it")
    k = max(1, len(costs) // 4)
    if not (np.isfinite(costs).all() and np.mean(costs[-k:]) < np.mean(costs[:k])):
        raise AssertionError(f"gpt-xl training: the loss is not finite and falling: {costs}")


def phase_window_serve(records):
    """Phase 15: gpt-m-L1024-W256 (``WIN_CFG``: 4 of its 8 layers, bf16,
    seeded random weights) served on phase 4's traffic through ``KV_SERVERS`` on bf16 and
    int8 caches, and its RoPE form on bf16, each stream held against
    ``decode_engine="xla"`` of the same model (``phase_kv_serve``); the
    slab's K/V bytes are its rolling buffer's, a quarter of the full
    slab's."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.serve import TextServer

    model = GPTLM(**WIN_CFG, compute_dtype=torch.bfloat16)
    params = perturbed_params(model, 0, "cuda")
    for kv in ("bf16", "int8"):
        srv = TextServer(model, params, slots=8, chunk=32, kv_dtype=kv)
        full = model.max_len * srv.kv_position_bytes * srv.slots
        got = srv.kv_slot_bytes * srv.slots
        print(f"  {kv} slab: cache_len {model.cache_len} of max_len {model.max_len}; K/V "
              f"{got} bytes for 8 slots against {full} for the full slab ({got / full:.3f}), "
              f"the cache tensor {srv._cache.k.numel() * srv._cache.k.element_size() * 2} "
              f"bytes of K and V")
        if got * model.max_len != full * model.cache_len or srv._cache.k.shape[2] != WINDOW:
            raise AssertionError("the windowed slab is not the rolling buffer of W rows")
        del srv
    phase_kv_serve(records, "window", model, params, ("bf16", "int8"), paged_traffic=False)
    rope = GPTLM(**WIN_CFG, pos_embedding="rope", compute_dtype=torch.bfloat16)
    phase_kv_serve(records, "window-rope", rope, perturbed_params(rope, 11, "cuda"), ("bf16",),
                   paged_traffic=False)


def phase_window_train(records):
    """Phase 16: (a) gpt-m-L1024-W256 trained through ``LMTrainer.run()`` on
    12(a)'s corpus and batch (16 x 1024, ``adam(1e-3)``, bf16) for one
    epoch of 64 steps (cut: the step count): banded, so every layer's
    backward is B4b + B4c (each once a layer a step, B4a never) after the
    banded B3; the final cost must fall below the loss at the initial
    parameters on the first batch less one nat. (b) gpt-m-L1024-W512 for 8
    steps: 4 W > L, so the fused backward B4a runs with the window; the
    cost finite."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    batch = TRAIN_CFG["batch_size"]
    for w, corpus, kernel in ((WINDOW, TRAIN_CORPUS, "flash_bwd_dq"),
                              (2 * WINDOW, {**TRAIN_CORPUS, "num": batch * 8 + 64, "n_val": 32,
                                            "n_test": 32}, "flash_bwd_fused")):
        ds = markov_corpus(**corpus)
        model = GPTLM(**{**SERVE_CFG, "window": w}, compute_dtype=torch.bfloat16)
        lines = []
        tr = LMTrainer(model, ds, TrainConfig(epochs=1, batch_size=batch, optimizer="adam",
                                              learning_rate=1e-3, log_frequency=16 if w == WINDOW
                                              else 1),
                       eval_batch=TRAIN_EVAL_BATCH, print_fn=lines.append)
        with torch.no_grad():
            first = torch.from_numpy(ds.train.tokens[:batch]).cuda()
            loss0 = float(model.loss(tr.state.params, first))
        _build.reset_launches()
        t0 = time.perf_counter()
        res = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        n, steps = model.num_layers, tr.global_step
        evals = -(-ds.validation.num_examples // TRAIN_EVAL_BATCH)
        want = {"flash_fwd": n * (steps + evals)}
        if kernel == "flash_bwd_dq":
            want.update(flash_bwd_dq=n * steps, flash_bwd_dkv=n * steps)
        else:
            want.update(flash_bwd_fused=n * steps)
        print(f"  W={w}: launches {launches}")
        if launches != want:
            raise AssertionError(f"W={w} training: expected launches {want}, got {launches}")
        costs = [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in lines
                 if ln.startswith("Step:")]
        ms = [float(ln.split("AvgTime:")[1].rstrip("ms")) for ln in lines if ln.startswith("Step:")]
        print(f"  W={w}: {steps} steps of {batch} x {ds.train.seq_len}: the loss at the "
              f"initial parameters {loss0:.4f}, then cost {', '.join(f'{c:.4f}' for c in costs)}; "
              f"final {res['final_cost']:.4f}; run {wall:.2f} s")
        if not np.isfinite([*costs, res["final_cost"]]).all():
            raise AssertionError(f"W={w} training: a cost is not finite: {costs}")
        if w == WINDOW:
            for name in ("flash_bwd_dq[window]", "flash_bwd_dkv[window]"):
                records[name]["launches"] = launches[FLASH_WINDOWS[name][0]]
            ref = records["flash_bwd_fused"].get("step_ms", float("nan"))
            attn = n * (records["flash_bwd_dq[window]"]["ms"]
                        + records["flash_bwd_dkv[window]"]["ms"])
            print(f"  W={w}: {ms[-1]:.2f} ms a step (the last 16-step window; 12(a)'s causal "
                  f"model {ref:.2f} ms), {batch * ds.train.seq_len / ms[-1] * 1e3:.1f} tokens/s; "
                  f"B4b + B4c (phase 11 times, {n} layers) {attn:.2f} ms of it; held-out "
                  f"perplexity {tr.history[-1]['perplexity']:.4f}")
            if not res["final_cost"] < loss0 - 1.0:
                raise AssertionError(f"W={w} training: the cost did not fall: {loss0} then "
                                     f"{costs}")
        else:
            records["flash_bwd_fused[window-512]"]["launches"] = launches["flash_bwd_fused"]


def s_requests(vocab, seed, new=S_SERVED_NEW):
    """The decode-* traffic: ``S_REQUESTS`` seeded prompts of ``S_PROMPT``
    tokens, ``new`` greedy tokens each."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, S_PROMPT).astype(np.int32) for _ in range(S_REQUESTS)]
    return prompts, [GenerationConfig(max_new=new) for _ in prompts]


def phase_s_serve(records):
    """Phase 17: the decode-* models (``S_SERVE``: decode-full, on bf16 and
    int8 caches; decode-window256, on both; decode-gqa2; decode-full with
    RoPE; seeded random weights) on their traffic through ``KV_SERVERS``
    (slab B6, slab B5, paged B6, paged + spec_draft=4 B7, paged B5), each
    held against ``decode_engine="xla"`` (``phase_kv_serve``); then C1
    end to end (:func:`phase_c1_serve`)."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    for label, knobs, kv_dtypes in S_SERVE:
        model = GPTLM(**S_CFG, **knobs, compute_dtype=torch.bfloat16)
        print(f"  {label}: {knobs or 'decode-full'}, head_dim {model.head_dim}, cache_len "
              f"{model.cache_len}")
        phase_kv_serve(records, label, model, perturbed_params(model, 3, "cuda"), kv_dtypes,
                       paged_traffic=False,
                       requests=s_requests(model.vocab_size, 4, S_PHASE17_NEW))
    phase_c1_serve(records)


def phase_c1_serve(records):
    """C1 end to end: ``TextServer(gpt-m with 2 KV heads, max_len 2048,
    paged, spec_draft=4, slots=16)`` on 16 requests of 1,000-1,900 tokens
    (half of them repeated 8-token patterns, so the drafter proposes) must
    launch B7 in two groups a tick (80 rows), accept drafts and match
    ``decode_engine="xla"`` under ``compare_streams``' rule; then a server
    of a model whose head dim the kernels are not built for (256) must be
    refused at construction."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    model = GPTLM(**C1_CFG, compute_dtype=torch.bfloat16)
    params = perturbed_params(model, 13, "cuda")
    rng = np.random.default_rng(14)
    prompts = []
    for i in range(C1_SLOTS):
        n = int(rng.integers(1000, 1901))
        if i % 2:
            prompts.append(np.tile(rng.integers(0, model.vocab_size, 8), n // 8 + 1)[:n])
        else:
            prompts.append(rng.integers(0, model.vocab_size, n))
    prompts = [p.astype(np.int32) for p in prompts]
    configs = [GenerationConfig(max_new=64) for _ in prompts]

    def make(**kw):
        return functools.partial(TextServer, model, params, slots=C1_SLOTS, chunk=32,
                                 paged=True, block_size=BLOCK, spec_draft=C1_DRAFT, **kw)

    ref_make = make(decode_engine="xla")
    ref_srv = ref_make()
    ref = ref_srv.generate(prompts, configs)
    srv = make()()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, configs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    tm, cnt = srv.timing, srv.counters
    ntok = sum(len(o) for o in outs)
    print(f"  C1 server (gpt-m 8:2 heads, max_len 2048, paged, spec_draft={C1_DRAFT}, "
          f"{C1_SLOTS} slots, prompts {min(map(len, prompts))}-{max(map(len, prompts))}): "
          f"launches {launches}; {ntok} tokens in {wall:.3f} s: {ntok / wall:.1f} tokens/s; "
          f"{tm['verify_ticks']} verify ticks, "
          f"{1e3 * tm['verify_s'] / max(1, tm['verify_ticks']):.3f} ms a tick, "
          f"{cnt['spec_tokens_accepted']} drafts accepted")
    if launches.get("verify_tokens_paged", 0) < 2 or cnt["spec_tokens_accepted"] < 1:
        raise AssertionError("the C1 server did not verify in groups or accepted no draft")
    records["verify_tokens_paged[c1-gqa2-2048]"]["launches"] = launches["verify_tokens_paged"]
    compare_streams("C1 server vs xla", model, srv.params, prompts, configs, outs, ref,
                    (srv, ref_srv), (make(), ref_make))
    wide = GPTLM(**{**S_CFG, "num_heads": 1}, compute_dtype=torch.bfloat16)
    try:
        TextServer(wide, wide.init(seed=1, device="cuda"), slots=8)
    except ValueError as e:
        print(f"  a server of a model of head dim 256 is refused at construction: {e}")
    else:
        raise AssertionError("a server of a model of head dim 256 was made")


def narrow_requests(vocab, seed):
    """Phase 22's traffic at head dims 8 and 16: 8 seeded prompts of
    ``NARROW_PROMPT`` tokens, ``NARROW_NEW`` greedy tokens each."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, NARROW_PROMPT).astype(np.int32) for _ in range(8)]
    return prompts, [GenerationConfig(max_new=NARROW_NEW) for _ in prompts]


def phase_f32_serve(records):
    """Phase 22: (a) decode-full in f32 compute (``F32_SERVE``: decode-full,
    its prefill through B3 in f32, on f32, int8 and fp8 caches; its window,
    GQA-2 and RoPE forms on the f32 cache; seeded random weights) on the
    decode-* traffic through ``KV_SERVERS`` (slab B6, slab B5, paged B6,
    paged + spec_draft=4 B7, paged B5), each held against
    ``decode_engine="xla"`` (``phase_kv_serve``: tokens/s, ms a step,
    TTFT); the slab server's prefill must launch B3, and its decode step is
    split between host and device (``profile_decode``: the busy share).
    (b) The head-dim-8 and -16 models (``NARROW_MODELS``) in bf16 and f32
    the same way on ``narrow_requests``. (c) The flash kernels at head dim
    8 and the padded 48 through GPT training (:func:`phase_narrow_train`)."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import TextServer

    for label, knobs, kv_dtypes, new in F32_SERVE:
        model = GPTLM(**S_CFG, **knobs, compute_dtype=torch.float32)
        params = perturbed_params(model, 3, "cuda")
        prompts, configs = s_requests(model.vocab_size, 4)
        configs = [dataclasses.replace(c, max_new=new) for c in configs]
        print(f"  {label}: {knobs}, f32, head_dim {model.head_dim}, cache_len {model.cache_len}, "
              f"{len(prompts)} prompts of {S_PROMPT}, {new} new tokens")
        phase_kv_serve(records, label, model, params, kv_dtypes, paged_traffic=False,
                       requests=(prompts, configs))
        if label != "f32-full":
            continue
        srv = TextServer(model, params, slots=8, chunk=32)
        _build.reset_launches()
        srv.generate(prompts, configs)
        torch.cuda.synchronize()
        if _build.LAUNCHES["flash_fwd"] < 1 or _build.LAUNCHES["decode_token_slab"] < 1:
            raise AssertionError(f"{label}: the slab server's prefill or decode launched no "
                                 f"kernel: {dict(_build.LAUNCHES)}")
        print(f"  {label} slab: B3 (the f32 prefill, D=32) {_build.LAUNCHES['flash_fwd']} "
              f"launches, B6 {_build.LAUNCHES['decode_token_slab']}")
        profile_decode(srv, prompts, configs)
        del srv
    for label, knobs in NARROW_MODELS:
        for cd in (torch.bfloat16, torch.float32):
            model = GPTLM(**NARROW_CFG, **knobs, compute_dtype=cd)
            print(f"  {label} ({str(cd).split('.')[1]}): {knobs}, head_dim {model.head_dim}")
            phase_kv_serve(records, label, model, perturbed_params(model, 5, "cuda"), ("bf16",),
                           paged_traffic=False, requests=narrow_requests(model.vocab_size, 6))
    phase_narrow_train(records)


def phase_narrow_train(records):
    """Phase 22(c): the GPTs of ``FLASH_NARROW_TRAIN`` (head dims 8 and 48;
    2 layers, f32, flash attention at every length, max_len and batch of
    ``FLASH_NARROW_SHAPE``) trained through ``LMTrainer.run()`` for one
    epoch of ``FLASH_NARROW_STEPS`` steps on 12(a)'s corpus recipe at that
    length, with the fused backward and then with ``flash_fused=False``
    (the dq + dk/dv pair): the launches must be B3 and B4a, then B3, B4b and
    B4c, the cost must fall; ms a step printed."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    b, l = FLASH_NARROW_SHAPE
    ds = markov_corpus(**{**TRAIN_CORPUS, "seq_len": l, "num": b * FLASH_NARROW_STEPS + 64,
                          "n_val": 32, "n_test": 32})
    for label, knobs in FLASH_NARROW_TRAIN:
        fwd = 0
        for fused in (None, False):
            model = GPTLM(vocab_size=TRAIN_CORPUS["vocab"], max_len=l, num_layers=2, **knobs,
                          attention_impl="flash", flash_min_len=0, flash_fused=fused,
                          compute_dtype=torch.float32)
            lines = []
            tr = LMTrainer(model, ds, TrainConfig(epochs=1, batch_size=b, optimizer="adam",
                                                  learning_rate=3e-3, log_frequency=8),
                           eval_batch=TRAIN_EVAL_BATCH, print_fn=lines.append)
            with torch.no_grad():
                loss0 = float(model.loss(tr.state.params,
                                         torch.from_numpy(ds.train.tokens[:b]).cuda()))
            _build.reset_launches()
            res = tr.run()
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            n, steps = model.num_layers, tr.global_step
            evals = -(-ds.validation.num_examples // TRAIN_EVAL_BATCH)
            want = {"flash_fwd": n * (steps + evals)}
            if fused is None:
                want["flash_bwd_fused"] = n * steps
            else:
                want.update(flash_bwd_dq=n * steps, flash_bwd_dkv=n * steps)
            if launches != want:
                raise AssertionError(f"gpt {label} (flash_fused={fused}): expected launches "
                                     f"{want}, got {launches}")
            for k, v in want.items():
                if k != "flash_fwd":
                    records[f"{k}[{label}]"]["launches"] = v
            fwd += want["flash_fwd"]
            costs = [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in lines
                     if ln.startswith("Step:")]
            ms = [float(ln.split("AvgTime:")[1].rstrip("ms")) for ln in lines
                  if ln.startswith("Step:")]
            print(f"  gpt {label} ({knobs}, head_dim {model.head_dim}, flash_fused={fused}): "
                  f"launches {launches}; the loss at the initial parameters {loss0:.4f}, then "
                  f"cost {', '.join(f'{c:.4f}' for c in costs)}; final {res['final_cost']:.4f}; "
                  f"{ms[-1]:.2f} ms a step")
            if not (np.isfinite([*costs, res["final_cost"]]).all() and res["final_cost"] < loss0):
                raise AssertionError(f"gpt {label}: the cost did not fall: {loss0} then {costs}")
        records[f"flash_fwd[{label}]"]["launches"] = fwd


def phase_s_train(records):
    """Phase 18: gpt-s-L512-flash and gpt-s-L2048-flash-W512 (``S_TRAIN``;
    bf16, Adam 1e-3) trained through ``LMTrainer.run()`` for one epoch of
    ``S_TRAIN_STEPS`` steps on 12(a)'s corpus recipe at their lengths (cut:
    the steps): the launches must be B3 and B4a for the first, B3, B4b and
    B4c for the second (banded: 4 W <= L), the cost must fall below the
    loss at the initial parameters less one nat; ms a step and tokens/s
    printed."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    fwd = 0
    for name, l, batch, w in S_TRAIN:
        corpus = {**TRAIN_CORPUS, "seq_len": l, "num": batch * S_TRAIN_STEPS + 64,
                  "n_val": 32, "n_test": 32}
        ds = markov_corpus(**corpus)
        model = GPTLM(**{**S_CFG, "max_len": l}, window=w, attention_impl="flash",
                      flash_min_len=0, compute_dtype=torch.bfloat16)
        lines = []
        tr = LMTrainer(model, ds, TrainConfig(epochs=1, batch_size=batch, optimizer="adam",
                                              learning_rate=1e-3, log_frequency=16),
                       eval_batch=TRAIN_EVAL_BATCH, print_fn=lines.append)
        with torch.no_grad():
            loss0 = float(model.loss(tr.state.params,
                                     torch.from_numpy(ds.train.tokens[:batch]).cuda()))
        _build.reset_launches()
        t0 = time.perf_counter()
        res = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        n, steps = model.num_layers, tr.global_step
        evals = -(-ds.validation.num_examples // TRAIN_EVAL_BATCH)
        want = {"flash_fwd": n * (steps + evals)}
        if w is None:
            want["flash_bwd_fused"] = n * steps
            records["flash_bwd_fused[d32]"]["launches"] = n * steps
        else:
            want.update(flash_bwd_dq=n * steps, flash_bwd_dkv=n * steps)
            for rec in ("flash_bwd_dq[d32-window]", "flash_bwd_dkv[d32-window]"):
                records[rec]["launches"] = n * steps
        fwd += want["flash_fwd"]
        print(f"  {name}: launches {launches}")
        if launches != want:
            raise AssertionError(f"{name}: expected launches {want}, got {launches}")
        costs = [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in lines
                 if ln.startswith("Step:")]
        ms = [float(ln.split("AvgTime:")[1].rstrip("ms")) for ln in lines if ln.startswith("Step:")]
        print(f"  {name}: {steps} steps of {batch} x {l}: the loss at the initial parameters "
              f"{loss0:.4f}, then cost {', '.join(f'{c:.4f}' for c in costs)}; final "
              f"{res['final_cost']:.4f}; {ms[-1]:.2f} ms a step (the last 16-step window), "
              f"{batch * l / ms[-1] * 1e3:.1f} tokens/s; run {wall:.2f} s")
        if not np.isfinite([*costs, res["final_cost"]]).all():
            raise AssertionError(f"{name}: a cost is not finite: {costs}")
        if not res["final_cost"] < loss0 - 1.0:
            raise AssertionError(f"{name}: the cost did not fall: {loss0} then {costs}")
    records["flash_fwd[d32]"]["launches"] = fwd


def remat_step(model, params, toks, mode, timed=3):
    """One training step's loss and gradient leaves of ``model`` under
    ``remat=mode`` on one batch, copied to the host, its launches, and
    (``timed`` steps more, CUDA events) its ms a step and the peak device
    memory of those steps. No gradients of an earlier step or mode stay on
    the card, so each mode's peak is its own step's."""
    import copy

    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    m = copy.copy(model)
    m.remat = mode
    torch.cuda.synchronize()
    _build.reset_launches()
    loss, grads = lm_value_and_grad(m, params, toks)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    loss, grads = float(loss), [x.cpu() for x in tree_leaves(grads)]
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        lm_value_and_grad(m, params, toks)
    end.record()
    torch.cuda.synchronize()
    return loss, grads, launches, start.elapsed_time(end) / timed, torch.cuda.max_memory_allocated()


def phase_selective_remat(records):
    """19(a): selective remat at gpt-xl-L1024 width, then 12 steps of
    LMTrainer with it and the composed optimizer."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    batch, steps = 16, XL_TRAIN_STEPS
    model = GPTLM(**XL_CFG, compute_dtype=torch.bfloat16)
    n = model.num_layers
    ds = markov_corpus(**{**TRAIN_CORPUS, "num": batch * steps + 64, "n_val": 32,
                          "n_test": 32})
    toks = torch.from_numpy(ds.train.tokens[:batch]).cuda()
    params = perturbed_params(model, 7, "cuda")
    runs = {}
    for mode in (True, "selective"):
        loss, runs[mode], launches, ms, peak = remat_step(model, params, toks, mode)
        print(f"  remat={mode!r}: loss {loss:.6f}, launches a step {launches}, "
              f"{ms:.2f} ms a step (forward and backward), peak {peak / 2**30:.2f} GiB")
        want = {"flash_fwd": n if mode == "selective" else 2 * n, "flash_bwd_dq": n,
                "flash_bwd_dkv": n}
        if launches != want:
            raise AssertionError(f"remat={mode!r}: launches {launches}, want {want}")
    try:
        _, _, _, ms, peak = remat_step(model, params, toks, False)
        print(f"  remat=False: {ms:.2f} ms a step, peak {peak / 2**30:.2f} GiB")
    except torch.cuda.OutOfMemoryError:
        print("  remat=False: does not fit in the card's memory")
    torch.cuda.empty_cache()
    diff = [(a != b).sum().item() for a, b in zip(runs[True], runs["selective"])]
    if any(diff):
        # Bit for bit unless B3 itself does not repeat: then the two modes
        # are held to GRAD_TOL, as flash vs dense in 12(a).
        _, again, _, _, _ = remat_step(model, params, toks, True, timed=0)
        repeat = all(torch.equal(a, b) for a, b in zip(runs[True], again))
        if repeat:
            raise AssertionError(f"selective vs True: {sum(diff)} gradient elements differ "
                                 "although remat=True repeats bit for bit")
        worst = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(runs["selective"], runs[True]))
        print(f"  B3 does not repeat bit for bit on this card: selective vs True within "
              f"{worst:.3e} of each leaf's largest (GRAD_TOL {GRAD_TOL})")
        if not worst <= GRAD_TOL:
            raise AssertionError(f"selective vs True: {worst} > GRAD_TOL")
    else:
        print(f"  selective == True bit for bit on all {len(diff)} gradient leaves")
    del runs, params, toks

    lines = []
    total = steps // 2  # applies: accumulation over 2 steps
    opt = optim.accumulate(
        optim.clip(optim.make("adamw", optim.schedule("cosine", 1e-3, total, warmup_steps=2)),
                   1.0), 2)
    tr = LMTrainer(model, ds, TrainConfig(epochs=1, batch_size=batch, remat="selective",
                                          log_frequency=1),
                   optimizer=opt, eval_batch=8, print_fn=lines.append)
    _build.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    evals = -(-ds.validation.num_examples // 8)
    want = {"flash_fwd": n * (steps + evals), "flash_bwd_dq": n * steps,
            "flash_bwd_dkv": n * steps}
    print(f"  LMTrainer(remat='selective', accumulate(clip(adamw(cosine)))): {steps} steps in "
          f"{wall:.2f} s, launches {launches}")
    if tr.global_step != steps or launches != want:
        raise AssertionError(f"selective training: {tr.global_step} steps, launches "
                             f"{launches}, want {want}")
    for rec, (name, _) in FLASH_XL_SELECTIVE.items():
        records[rec]["launches"] = launches[name]
    costs = [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in lines
             if ln.startswith("Step:")]
    ms = [float(ln.split("AvgTime:")[1].rstrip("ms")) for ln in lines if ln.startswith("Step:")]
    print(f"  cost {', '.join(f'{c:.4f}' for c in costs)}; ms a step (from step 3) "
          f"{np.mean(ms[2:]):.2f}; applies {int(tr.state.opt_state.gradient_step)}")
    k = 3
    if not (np.isfinite(costs).all() and np.mean(costs[-k:]) < np.mean(costs[:k])):
        raise AssertionError(f"selective training: the loss is not finite and falling: {costs}")
    if int(tr.state.opt_state.gradient_step) != total:
        raise AssertionError("accumulate(2) did not apply once every 2 steps")
    # The composed optimizer alone at these parameters: a call that only
    # accumulates, and one that applies (clip + AdamW).
    params, state = tr.state.params, tr.state.opt_state
    grads = optim.tree_map(torch.ones_like, params)
    times = {k: cuda_ms(lambda k=k: opt.update(grads, state._replace(mini_step=k), params), 10)
             for k in (0, 1)}
    print(f"  optimizer update at {sum(x.numel() for x in tree_leaves(params))} parameters: "
          f"accumulate only {times[0]:.3f} ms, apply {times[1]:.3f} ms")


# 19(b): ~6 s of BPE training in pure Python; 228 training rows of 512.
TEXT_DOCS, TEXT_MERGES = 8192, 512
TEXT_CFG = dict(model_dim=512, num_heads=8, num_layers=4, max_len=512,
                attention_impl="flash", flash_min_len=0)


def phase_text(records):
    """19(b): BPE → text_corpus → LMTrainer.run() and run_compiled() on a
    gpt-m-width model → greedy decoding through the tokenizer."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.text import (
        BPETokenizer,
        synthetic_documents,
        text_corpus,
    )
    from distributed_tensorflow_tpu_torch.data.tokens import _split
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    t0 = time.perf_counter()
    tok = BPETokenizer.train(synthetic_documents(TEXT_DOCS, seed=0), num_merges=TEXT_MERGES)
    t1 = time.perf_counter()
    ds = text_corpus(num_docs=TEXT_DOCS, seq_len=512, n_val=16, n_test=16, seed=0,
                     tokenizer=tok)
    rows = np.concatenate([ds.train.tokens, ds.validation.tokens, ds.test.tokens])
    print(f"  BPE: {len(tok.merges)} merges over {TEXT_DOCS} documents in {t1 - t0:.2f} s "
          f"(vocab {tok.vocab_size}); corpus {ds.train.tokens.shape} train rows in "
          f"{time.perf_counter() - t1:.2f} s")
    model = GPTLM(**TEXT_CFG, vocab_size=tok.vocab_size, compute_dtype=torch.bfloat16)
    cfg = TrainConfig(epochs=2, batch_size=8, optimizer="adam", learning_rate=3e-3,
                      log_frequency=1)
    out = {}
    for label in ("run", "run_compiled"):
        lines, costs = [], []
        # text_corpus's splits anew (its _split), each with a fresh index stream.
        tr = LMTrainer(model, _split(rows, None, 16, 16, 0), cfg, eval_batch=8, tokenizer=tok,
                       print_fn=lines.append)
        step = tr._train_step  # each step's cost tensor, kept on the device

        def keep(toks, lens, step=step, costs=costs):
            costs.append(step(toks, lens))
            return costs[-1]

        tr._train_step = keep
        t0 = time.perf_counter()
        res = getattr(tr, label)()
        torch.cuda.synchronize()
        ppls = [h["perplexity"] for h in tr.history]
        logged = [ln.split("AvgTime:")[0] for ln in lines if not ln.startswith("Total Time")]
        out[label] = (torch.stack(costs), ppls, tree_leaves(tr.state.params), tr, logged)
        print(f"  {label}: {tr.global_step} steps in {time.perf_counter() - t0:.2f} s, "
              f"perplexity {', '.join(f'{p:.4f}' for p in ppls)}, final {res['perplexity']:.4f}")
    (ca, pa, wa, tr, la), (cb, pb, wb, _, lb) = out["run"], out["run_compiled"]
    same = all(torch.equal(a, b) for a, b in zip(wa, wb))
    if not torch.equal(ca, cb) or pa != pb or not same or la != lb:
        raise AssertionError(f"run_compiled != run: costs {torch.equal(ca, cb)}, perplexities "
                             f"{pa} vs {pb}, parameters {same}, log lines {la == lb}")
    print(f"  run_compiled == run bit for bit: {ca.numel()} costs, {len(pa)} perplexities, "
          f"every parameter; the same {len(la)} log lines but for AvgTime")
    if not pa[-1] < tok.vocab_size:
        raise AssertionError(f"perplexity {pa[-1]} not below the vocabulary {tok.vocab_size}")
    prompt = torch.from_numpy(tok.encode("the model ")[None, :]).cuda()
    greedy = model.greedy_decode(tr.state.params, prompt, 24)[0, prompt.shape[1]:].cpu().numpy()
    print(f"  greedy continuation of 'the model ': {greedy.tolist()} -> "
          f"{tok.decode(greedy)!r}")


def phase_mlp_optimizers(records, ds):
    """19(c): the MLP Trainer with Adam, then with a schedule, warmup,
    clipping and accumulation; the fused engine refuses both."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.ops import _build

    kws = {"adam": dict(optimizer="adam"),
           "adam+cosine+clip+accumulate": dict(optimizer="adam", lr_schedule="cosine",
                                               warmup_steps=50, grad_clip_norm=1.0,
                                               accumulate_steps=2)}
    for label, kw in kws.items():
        lines = []
        tr = build_trainer(TrainConfig(epochs=1, **kw), datasets=ds, print_fn=lines.append)
        t0 = time.perf_counter()
        res = tr.run()
        torch.cuda.synchronize()
        costs = [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in lines
                 if ln.startswith("Step:")]
        print(f"  {label}: {res['global_step']} steps in {time.perf_counter() - t0:.2f} s, "
              f"cost {costs[0]:.4f} -> {costs[-1]:.4f}, accuracy {res['accuracy']:.4f}")
        if not (np.isfinite(costs).all() and costs[-1] < costs[0]):
            raise AssertionError(f"MLP {label}: the cost did not fall: {costs}")
        pallas = build_trainer(TrainConfig(epochs=1, compiled_run=True, engine="pallas", **kw),
                               datasets=ds, print_fn=lambda *a: None)
        _build.reset_launches()
        try:
            pallas.run()
        except ValueError as exc:
            if any(_build.LAUNCHES.values()):
                raise AssertionError(f"engine='pallas' launched before refusing: "
                                     f"{dict(_build.LAUNCHES)}") from exc
            print(f"  engine='pallas' refused it before any launch: {exc}")
        else:
            raise AssertionError(f"engine='pallas' ran {label}")


# Phase 21: the classifier families at the registry's default widths (the
# JAX constructors: CNN 32/64 channels of 5x5 and 256 hidden, LSTM 128
# hidden over 28 rows, transformer d=64 with 4 heads of 16 over 28 rows),
# bf16, batch 100, built by build_trainer from DTF_MODEL. Each trains one
# epoch over the first CLASSIFIER_ROWS synthetic training rows (cut: the
# rows, to 300 steps, so that the phase takes about a minute), at the rates
# of the JAX package's own classifier tests (tests/test_cnn.py:146 SGD 0.05,
# tests/test_rnn.py:162 SGD 0.5, tests/test_transformer.py:90 Adam 1e-3).
# The flash transformer (attention_impl="flash", flash_min_len=0) runs the
# same epoch through B3 and B4a, then CLASSIFIER_PAIR_ROWS rows with the
# fused backward's dq-partial cap at 0, so that the auto rule takes B4b +
# B4c (as phase 12(b) drives the pair).
CLASSIFIER_ROWS = 30000
CLASSIFIER_PAIR_ROWS = 10000
# Test accuracy each run must pass: the synthetic classes are easy for these
# families (CNN 1.0000 and LSTM 0.9998 after 300 steps on an H100 80GB HBM3
# at 700 W).
CLASSIFIER_ORACLE = 0.9
CLASSIFIER_RUNS = {"cnn": dict(learning_rate=0.05), "lstm": dict(learning_rate=0.5),
                   "transformer": dict(optimizer="adam", learning_rate=1e-3)}
# The classifier's attention shape: B=100, L=28, 4 heads of 16, non-causal.
CLS_ATTN = (100, 28, 4, 16)
# The flash kernels at head_dim 16, held at CLS_ATTN and launched by the
# flash transformer's training: record -> (kernel, path).
FLASH_D16 = {"flash_fwd[d16]": ("flash_fwd", "transformer-classifier train"),
             "flash_bwd_fused[d16]": ("flash_bwd_fused", "transformer-classifier train"),
             "flash_bwd_dq[d16]": ("flash_bwd_dq", "transformer-classifier train, dq cap 0"),
             "flash_bwd_dkv[d16]": ("flash_bwd_dkv", "transformer-classifier train, dq cap 0")}


def d16_kernels(records):
    """B3, B4a, B4b and B4c at head_dim 16 at the classifier's shape
    (``CLS_ATTN``), f32 (the path's: q, k, v are f32 products) and bf16,
    against their plain versions (flash tolerances: REL_TOL in f32, 2^-7 of
    the largest output and BWD_BF16_TOL in bf16); then, in f32, each timed
    beside the plain version, SDPA (forward, and its backward for B4a) and
    the bound of the 313,600 (q, k) pairs. Recorded under ``FLASH_D16``."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    b, l, h, d = CLS_ATTN
    g = torch.Generator(device=dev).manual_seed(16)
    for dtype in (torch.float32, torch.bfloat16):
        label = f"d16 {str(dtype).split('.')[1]}"
        q, k, v, do = (torch.randn(b, l, h, d, device=dev, generator=g).to(dtype)
                       for _ in range(4))
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ref, ref_lse = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = max((out.float() - ref.float()).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        scale = max(1.0, ref.float().abs().max().item())
        tol = REL_TOL["flash_fwd"] * scale if dtype == torch.float32 else 2 ** -7 * scale
        print(f"  flash_fwd[{label}]: max_abs_err {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"flash_fwd[{label}] disagrees with its plain version")
        delta = (do.float() * out.float()).sum(-1)
        plain = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, None, False)
        calls = {"flash_bwd_fused": lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta),
                 "flash_bwd_dq": lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta), None, None),
                 "flash_bwd_dkv": lambda: (None, *fa.flash_bwd_dkv(q, k, v, do, lse, delta))}
        errs = {name: check_bwd(f"{name}[{label}] vs plain", fn(), plain,
                                REL_TOL[name] if dtype == torch.float32 else BWD_BF16_TOL)
                for name, fn in calls.items()}
        if dtype != torch.float32:
            continue
        pairs = b * h * l * l
        io, rows = 4 * q.numel(), 4 * lse.numel()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        dot = do.transpose(1, 2)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True))
        records["flash_fwd[d16]"] = r = dict(
            max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v)),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v)), library_ms=lib_fwd,
            **split_tf32_bound(4 * io + rows, 4 * d * pairs))
        print(f"  flash_fwd[d16] (B={b} L={l} {h}x{d} f32, {pairs} pairs): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA {lib_fwd:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, delta, None, False))
        print(f"  library yardstick: SDPA backward (f32): {lib_bwd:.4f} ms; plain backward "
              f"{plain_ms:.4f} ms")
        for name, fn in calls.items():
            fl = {"flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
            nbytes = {"flash_bwd_fused": 7, "flash_bwd_dq": 5, "flash_bwd_dkv": 6}[name] * io
            # SDPA's backward computes the fused kernel's function; no call
            # computes dq or dk/dv alone.
            records[f"{name}[d16]"] = r = dict(
                max_abs_err=errs[name], ms=cuda_ms(fn), plain_ms=plain_ms,
                library_ms=lib_bwd if name == "flash_bwd_fused" else None,
                **split_tf32_bound(nbytes + 2 * rows, 2 * d * pairs * fl))
            print(f"  {name}[d16]: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']})")


def classifier_run(label, ds, rows, name, *, model=None, **kw):
    """One epoch of a classifier over the first ``rows`` training rows
    through ``launch.build_trainer`` (``DTF_MODEL=name``; ``model`` in its
    place when given) on the card: the launches of the run, its cost falling, the
    test accuracy from the trainer and from ``Predictor`` (one chunk of the
    whole test split: the eval's shapes) equal, examples/s from AvgTime."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.inference import Predictor
    from distributed_tensorflow_tpu_torch.launch import build_trainer, config_from_env
    from distributed_tensorflow_tpu_torch.ops import _build

    sub = Datasets(train=DataSet(ds.train.images[:rows], ds.train.labels[:rows], seed=1),
                   validation=ds.validation, test=ds.test)
    os.environ["DTF_MODEL"] = name
    try:
        cfg = config_from_env(TrainConfig(epochs=1, log_frequency=50, **kw))
    finally:
        del os.environ["DTF_MODEL"]
    lines = []
    tr = build_trainer(cfg, model=model, datasets=sub, print_fn=lines.append)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    steps = [ln for ln in lines if ln.startswith("Step:")]
    costs = [float(ln.split("Cost:")[1].split()[0].rstrip(",")) for ln in steps]
    avg_ms = float(steps[-1].split("AvgTime:")[1].strip().rstrip("ms"))
    test = ds.test
    served = Predictor.from_state(tr.model, tr.state, strategy=tr.strategy,
                                  batch_size=test.num_examples).accuracy(test.images, test.labels)
    print(f"  {label}: {res['global_step']} steps, cost {', '.join(f'{c:.4f}' for c in costs)}; "
          f"test accuracy {res['accuracy']:.4f} (Predictor {served:.4f}); {avg_ms:.3f} ms a "
          f"step, {100 / avg_ms * 1e3:.0f} examples/s; run {wall:.2f} s; launches {launches}")
    if not (np.isfinite(costs).all() and costs[-1] < costs[0]):
        raise AssertionError(f"{label}: the cost did not fall: {costs}")
    # The same count of right answers: the two means of 10,000 0/1 values
    # (on the card and on the host) may round 1 ulp apart.
    if abs(served - res["accuracy"]) * test.num_examples >= 0.5:
        raise AssertionError(f"{label}: Predictor accuracy {served} != eval {res['accuracy']}")
    if not res["accuracy"] > CLASSIFIER_ORACLE:
        raise AssertionError(f"{label}: test accuracy {res['accuracy']} <= {CLASSIFIER_ORACLE}")
    return res, launches


def phase_classifiers(records, ds):
    """Phase 21: the CNN, the LSTM and the transformer (dense) through
    ``DTF_MODEL`` and ``build_trainer``; then the flash transformer, whose
    launches must be B3 and B4a (then B3, B4b and B4c with the dq-partial
    cap at 0), none of the others; then the D=16 kernels against their
    plain versions and timed (:func:`d16_kernels`)."""
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerClassifier
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    steps = CLASSIFIER_ROWS // 100
    for name, kw in CLASSIFIER_RUNS.items():
        _, launches = classifier_run(name, ds, CLASSIFIER_ROWS, name, **kw)
        if launches:
            raise AssertionError(f"{name}: a kernel launched on the plain path: {launches}")
    flash = TransformerClassifier(attention_impl="flash", flash_min_len=0)
    kw = CLASSIFIER_RUNS["transformer"]
    _, launches = classifier_run("transformer, flash", ds, CLASSIFIER_ROWS, "transformer",
                                 model=flash, **kw)
    want = {"flash_fwd": steps + 1, "flash_bwd_fused": steps}  # + the epoch's eval
    if launches != want:
        raise AssertionError(f"transformer, flash: launches {launches}, expected {want}")
    cap = fa.FUSED_DQ_CAP_BYTES
    fa.FUSED_DQ_CAP_BYTES = 0
    try:
        _, pair = classifier_run("transformer, flash, dq cap 0", ds, CLASSIFIER_PAIR_ROWS,
                                 "transformer", model=flash, **kw)
    finally:
        fa.FUSED_DQ_CAP_BYTES = cap
    n = CLASSIFIER_PAIR_ROWS // 100
    if pair != {"flash_fwd": n + 1, "flash_bwd_dq": n, "flash_bwd_dkv": n}:
        raise AssertionError(f"transformer, flash, dq cap 0: launches {pair}")
    d16_kernels(records)
    records["flash_fwd[d16]"]["launches"] = launches["flash_fwd"] + pair["flash_fwd"]
    records["flash_bwd_fused[d16]"]["launches"] = launches["flash_bwd_fused"]
    for k in ("flash_bwd_dq", "flash_bwd_dkv"):
        records[f"{k}[d16]"]["launches"] = pair[k]


# Phase 20: the data-parallel modes. The reference's topologies run 2
# workers and 1 ps (BASELINE.md rows 3-5) at the reference's widths (784->100
# ->10, batch 100 a worker, lr 0.001); B2's composition runs 2 ranks at
# avg_every 50 with a per-rank lr of 0.002 (the JAX docstring's pre-scaled
# rate for 2 workers). Ranks sharing the one card take gloo over CUDA
# tensors; a world of one takes NCCL.
DP_EPOCHS = 100
# Cut: the async topology of (b) trains 75 epochs, not the reference's
# 100, and crosses the 0.72 oracle at epochs 64-66. The sync topology trains
# DP_SYNC_EPOCHS: a gloo all-reduce between two processes of the host
# (2.03 ms for 318 KB in (c), PERF.md section 6) is a step of it, and
# at 75 epochs it took 246-262 s of a 965-1013 s smoke (it crossed the
# oracle at epoch 65 there). Its gradient is the mean of two batches of 100,
# so its test accuracy follows the single-device run of phase 8 (its first
# 20 epochs on the card printed the same two decimals as the single-device
# kernel path's plain version on the CPU): it is held to that trajectory,
# epoch by epoch, within DP_SYNC_ACC_TOL. Cut (PR 20) from 20 epochs to 14:
# it runs beside the async topology (53.3 s in PR 19's smoke), which it
# outlasted at 20 (67.3 s).
DP_TOPOLOGY_EPOCHS = 75
DP_SYNC_EPOCHS = 14
# (a)'s runs over NCCL: cut (PR 20) from 2 epochs to 1 (the check is bit for
# bit against SingleDevice, whatever the depth).
DP_WORLD1_EPOCHS = 1
DP_SYNC_ACC_TOL = 0.02
DP_AVG_EVERY = 50
DP_LR = 0.002
DP_WORKERS = 2


def dp_logdir(name):
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "phase20", name)
    os.makedirs(d, exist_ok=True)
    return d


def dp_task(kind, epochs, port, argv) -> int:
    """One task of a phase-20 cluster (``--dp-task``), started by
    ``tools/launch_local.launch``: ``sync`` / ``async`` train the reference
    topology through ``launch.run``; ``fused`` runs B2's composition. A
    worker prints ``RESULT <json>`` last."""
    import torch
    from distributed_tensorflow_tpu_torch.config import ClusterConfig, TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets
    from distributed_tensorflow_tpu_torch.launch import run

    cluster = ClusterConfig.from_lists(
        [f"127.0.0.1:{port + i}" for i in range(DP_WORKERS)], [f"127.0.0.1:{port + 10}"])
    ds = read_data_sets("MNIST_data", one_hot=True)
    if kind == "fused":
        return dp_fused_task(cluster, ds, epochs, argv)
    cfg = (TrainConfig(epochs=epochs, per_worker_epoch=True) if kind == "sync"
           else TrainConfig(epochs=epochs, sync=False, async_avg_every=DP_AVG_EVERY))
    t0 = time.perf_counter()
    res = run(cluster, cfg, argv=argv, datasets=ds)
    if res is not None:
        torch.cuda.synchronize()
        print("RESULT " + json.dumps(dict(res, wall=time.perf_counter() - t0)))
    return 0


def dp_fused_task(cluster, ds, epochs, argv) -> int:
    """B2's data-parallel composition on this rank: one epoch against the
    plain composition, then ``epochs`` epochs to the oracle, timed; the
    kernel's and the exchange's share of an epoch timed apart."""
    import torch
    from distributed_tensorflow_tpu_torch.cluster import bootstrap_from_argv
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm
    from distributed_tensorflow_tpu_torch.ops.losses import accuracy
    from distributed_tensorflow_tpu_torch.parallel.mesh import batch_sharded, make_mesh

    ctx = bootstrap_from_argv(cluster, argv)
    world = make_mesh()
    dev = world.device
    B, steps = 100, ds.train.num_examples // 100  # each rank: 550 steps of 100 an epoch
    gb = B * world.size
    kw = dict(steps=steps, batch_size=B, learning_rate=DP_LR, avg_every=DP_AVG_EVERY,
              stream_dtype=torch.bfloat16)
    run, plain_run = (fm.make_fused_async_epoch_fn(world, **kw),
                      fm.make_fused_async_epoch_fn(world, plain=True, **kw))
    train_x = torch.from_numpy(ds.train.images).to(dev)
    train_y = torch.from_numpy(ds.train.labels).to(dev)
    tx, ty = torch.from_numpy(ds.test.images).to(dev), torch.from_numpy(ds.test.labels).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)  # the same stream on every rank

    def epoch_batches():
        # The per-worker epoch: steps x global batch rows over two permutations.
        perm = torch.cat([torch.randperm(ds.train.num_examples, generator=gen, device=dev)
                          for _ in range(-(-steps * gb // ds.train.num_examples))])
        idx = perm[: steps * gb]
        return (train_x.index_select(0, idx).reshape(steps, gb, -1).bfloat16(),
                train_y.index_select(0, idx).reshape(steps, gb, -1).bfloat16())

    base = fm.to_fused_stacked(MLP().init(seed=1, device=dev), world)
    xs, ys = epoch_batches()
    k, p = fm.FusedState(*(t.clone() for t in base)), fm.FusedState(*(t.clone() for t in base))
    _build.reset_launches()
    k, kc = run(k, xs, ys)
    one_epoch_launches = _build.LAUNCHES["fused_mlp_epoch_dp"]
    p, pc = plain_run(p, xs, ys)
    torch.cuda.synchronize()
    err = check_mlp("fused_mlp_epoch", (kc, pc), k, p, base)
    q = fm.FusedState(*(t.clone() for t in base))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_run(q, xs, ys)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    # The main path: epochs of the composition from the seed-1 start.
    state = fm.FusedState(*(t.clone() for t in base))
    _build.reset_launches()
    epoch_ms, accs = [], []
    t_run = time.perf_counter()
    for e in range(epochs):
        xs, ys = epoch_batches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, costs = run(state, xs, ys)
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        h = torch.sigmoid(tx @ state.w1 + state.b1)
        acc = float(accuracy(h @ state.w2 + state.b2, ty))
    wall = time.perf_counter() - t_run
    launches = _build.LAUNCHES["fused_mlp_epoch_dp"]

    # An epoch's split: its rounds' launches alone (the wrapper's launcher,
    # uncounted) and its exchanges alone (all-reduces of the four tensors).
    cols = batch_sharded(world, gb)
    mx, my = xs[:, cols].contiguous(), ys[:, cols].contiguous()
    lib = fm.kernels("fused_mlp")
    scratch = fm.FusedState(*(t.clone() for t in state))
    kernel_ms = cuda_ms(lambda: [fm.launch_epoch(lib, scratch, mx[lo:lo + DP_AVG_EVERY],
                                                 my[lo:lo + DP_AVG_EVERY], DP_LR)
                                 for lo in range(0, steps, DP_AVG_EVERY)], 5, 1)
    rounds = steps // DP_AVG_EVERY
    world.all_reduce_(torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5 * rounds):
        world.mean_(scratch)
    torch.cuda.synchronize()
    exchange_ms = (time.perf_counter() - t0) * 1e3 / 5
    ar = torch.zeros(79510, device=dev)
    t0 = time.perf_counter()
    for _ in range(50):
        world.all_reduce_(ar)
    torch.cuda.synchronize()
    ar_us = (time.perf_counter() - t0) * 1e6 / 50
    ctx.close()
    print("RESULT " + json.dumps(dict(
        rank=world.rank, backend=world.backend, one_epoch_launches=one_epoch_launches,
        launches=launches, epochs=epochs, accuracy=acc, wall=wall,
        epoch_ms=sorted(epoch_ms)[len(epoch_ms) // 2], plain_ms=plain_ms, kernel_ms=kernel_ms,
        exchange_ms=exchange_ms, all_reduce_us=ar_us, max_abs_err=err,
        final_cost=float(costs[-1]))))
    return 0


def dp_launch(name, command, workers, ps, env=None):
    """Start a cluster through the port's launcher; returns (rc, logs)."""
    from distributed_tensorflow_tpu_torch.tools.launch_local import launch

    logdir = dp_logdir(name)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(env or {}, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    rc = launch(command, workers, ps, logdir, env=env, print_fn=lambda s: print(f"  {s}"))
    wall = time.perf_counter() - t0
    logs = {}
    for fn in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, fn)) as f:
            logs[fn[:-4]] = f.read()
    if rc != 0:
        for n, text in logs.items():
            print(f"  --- {n}.log ---\n" + "\n".join(text.splitlines()[-30:]))
        raise AssertionError(f"{name}: a worker failed (launcher exit {rc})")
    print(f"  {name}: {workers} workers + {ps} ps in {wall:.1f} s (logs in {logdir})")
    return logs


def dp_result(log):
    return json.loads(log.split("RESULT ", 1)[1].splitlines()[0])


def dp_check_reference_lines(name, logs, epochs):
    """The chief prints the reference's lines (steps, an accuracy and a
    time an epoch, the final cost, Done); the other workers step lines only;
    every ps task its two lines."""
    chief = logs["worker0"].splitlines()
    need = ("worker setting up ...", "Ready to go")
    for n in [k for k in logs if k.startswith("worker")]:
        lines = logs[n].splitlines()
        if not all(x in lines for x in need) or not any(x.startswith("Step: ") for x in lines):
            raise AssertionError(f"{name}: {n} lacks the worker lines")
        joined = [x for x in lines if x.startswith("data parallel: rank ")]
        if len(joined) != 1 or not joined[0].endswith(" over gloo"):
            raise AssertionError(f"{name}: {n} did not join the group over gloo: {joined}")
        print(f"  | {n}: {joined[0]}")
        if n != "worker0" and any(x.startswith(("Test-Accuracy", "Final Cost", "Done"))
                                  for x in lines):
            raise AssertionError(f"{name}: {n} printed the chief's lines")
    if (sum(x.startswith("Test-Accuracy: ") for x in chief) != epochs
            or sum(x.startswith("Total Time: ") for x in chief) != epochs
            or not any(x.startswith("Final Cost: ") for x in chief) or "Done" not in chief):
        raise AssertionError(f"{name}: the chief did not print the reference's lines")
    for n in [k for k in logs if k.startswith("ps")]:
        if logs[n].splitlines()[:1] != ["ps setting up ..."]:
            raise AssertionError(f"{name}: {n} did not print the ps lines")
    for x in [x for x in chief if x.startswith("Step: ")][-1:] + chief[-4:]:
        print(f"  | {x}")


def phase_dp(records, ds, smi):
    """20: (a) a world of one over NCCL, sync and async against
    SingleDevice; (b) the reference's topologies through the launcher;
    (c) B2's data-parallel composition on 2 ranks."""
    import socket

    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.parallel.mesh import init_world
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        AsyncDataParallel,
        SingleDevice,
        SyncDataParallel,
    )

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # (a) World size 1 over NCCL.
    world = init_world(f"tcp://127.0.0.1:{free_port()}", 1, 0, device="cuda")
    print(f"  (a) world {world.size} on {world.device}, backend {world.backend} [{smi}]")
    if world.backend != "nccl":
        raise AssertionError(f"a world of one on the card took {world.backend}")
    finals = {}
    for label, strategy in (("single", SingleDevice()), ("sync", SyncDataParallel(world)),
                            ("async", AsyncDataParallel(world, avg_every=DP_AVG_EVERY,
                                                        update_scale=1))):
        tr = build_trainer(TrainConfig(epochs=DP_WORLD1_EPOCHS, log_frequency=10**9),
                           datasets=ds, strategy=strategy, print_fn=lambda *a: None)
        _build.reset_launches()
        t0 = time.perf_counter()
        res = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if tr._indexed_fn is None or any(_build.LAUNCHES.values()):
            raise AssertionError(f"{label}: the default path on cuda is the scanned plain path")
        finals[label] = [t.clone() for t in tr.strategy.to_canonical(tr.state).params]
        print(f"  (a) {label}: {DP_WORLD1_EPOCHS} epoch(s), {res['global_step']} steps, "
              f"{1e3 * wall / res['global_step']:.4f} ms a step, accuracy {res['accuracy']:.4f}")
    for label in ("sync", "async"):
        if not all(torch.equal(a, b) for a, b in zip(finals[label], finals["single"])):
            raise AssertionError(f"(a) {label} over NCCL differs from SingleDevice")
    print("  (a) sync and async(update_scale=1) equal SingleDevice bit for bit")
    bucket = torch.zeros(784 * 100 + 100 + 100 * 10 + 10 + 1, device=world.device)
    ar_us = 1e3 * cuda_ms(lambda: world.all_reduce_(bucket), 200, 20)
    print(f"  (a) all_reduce of the sync bucket ({bucket.numel()} f32) over NCCL: "
          f"{ar_us:.2f} us [{smi}]")
    dist.destroy_process_group()

    # (c) B2's data-parallel composition, 2 ranks on the card, first and
    # alone: its times are the kernels line's.
    me = [sys.executable, os.path.abspath(__file__)]
    logs = dp_launch("fused-dp-async", me + ["--dp-task", "fused", "--dp-epochs", str(DP_EPOCHS),
                                             "--dp-port", str(free_port())], DP_WORKERS, 0)
    ranks = [dp_result(logs[f"worker{r}"]) for r in range(DP_WORKERS)]
    rounds = (ds.train.num_examples // 100) // DP_AVG_EVERY
    for r in ranks:
        print(f"  (c) rank {r['rank']}: one epoch against the plain composition, max_abs_err "
              f"{r['max_abs_err']:.3e} (phase 7's B2 tolerance, checked on the rank)")
        if r["one_epoch_launches"] != rounds or r["launches"] != rounds * DP_EPOCHS:
            raise AssertionError(f"rank {r['rank']}: {r['one_epoch_launches']} launches an "
                                 f"epoch, {r['launches']} in {DP_EPOCHS} (want {rounds} a rank)")
        if r["backend"] != "gloo":
            raise AssertionError(f"2 ranks on one card took {r['backend']}")
    r0 = ranks[0]
    print(f"  (c) {DP_EPOCHS} epochs, lr {DP_LR} a rank, avg_every {DP_AVG_EVERY}: accuracy "
          f"{r0['accuracy']:.4f} (oracle >= {ACCURACY_ORACLE}), {r0['launches']} launches a rank "
          f"({rounds} an epoch), {r0['wall']:.2f} s")
    print(f"  (c) an epoch a rank: {r0['epoch_ms']:.3f} ms (median), of which kernel "
          f"{r0['kernel_ms']:.3f} ms ({rounds} launches) and exchange {r0['exchange_ms']:.3f} ms "
          f"({rounds} all-reduces of the 4 tensors, {r0['all_reduce_us']:.1f} us each over gloo); "
          f"plain composition {r0['plain_ms']:.3f} ms [{smi}]")
    if not r0["accuracy"] >= ACCURACY_ORACLE:
        raise AssertionError(f"B2 data-parallel: accuracy {r0['accuracy']} below the oracle")

    # (b) The reference's topologies, 2 workers + 1 ps on the card (gloo).
    # Cut: the sync run (a gloo all-reduce a step, see DP_SYNC_EPOCHS)
    # runs beside the async run and the examples, not after them; each
    # run's s an epoch is printed whole and over its last 10 epochs.
    import threading

    single = records.get("mlp_train_single", {})
    topology = {}

    depth = {"sync": DP_SYNC_EPOCHS, "async": DP_TOPOLOGY_EPOCHS}

    # DTF_LOGS="": these clusters train without the chief's tfevents and
    # graph dump (phase 28(a) drives that path through launch.run): the
    # dump's first trace imports torch.fx's fake-tensor machinery, which
    # three clusters' chiefs starting together on the host took 14-19 s
    # longer to get through.
    def start(kind):
        topology[kind] = dp_launch(
            f"topology-{kind}", me + ["--dp-task", kind, "--dp-epochs", str(depth[kind]),
                                      "--dp-port", str(free_port())], DP_WORKERS, 1,
            env={"DTF_LOGS": ""})

    def sync_run():
        try:
            start("sync")
        except BaseException as exc:  # re-raised on the main thread below
            topology["error"] = exc

    behind = threading.Thread(target=sync_run)
    behind.start()
    # Cut (PR 20): the examples' one-epoch clusters run beside the async
    # topology too, not after it (they took ~25 s of the phase's ~110 s);
    # one after the other, since both take settings.py's ports.
    examples = {}

    def examples_run():
        try:
            for ex in ("between_sync", "between_async"):
                examples[ex] = dp_launch(
                    ex, [sys.executable, "-m", f"distributed_tensorflow_tpu_torch.examples.{ex}"],
                    DP_WORKERS, 1, env={"DTF_EPOCHS": "1", "DTF_LOGS": ""})
        except BaseException as exc:  # re-raised on the main thread below
            examples["error"] = exc

    beside = threading.Thread(target=examples_run)
    beside.start()
    start("async")
    beside.join()
    if "error" in examples:
        raise examples["error"]
    for ex in ("between_sync", "between_async"):
        dp_check_reference_lines(ex, examples[ex], 1)
    behind.join()
    if "error" in topology:
        raise topology["error"]
    for kind in ("sync", "async"):
        logs, epochs = topology[kind], depth[kind]
        dp_check_reference_lines(kind, logs, epochs)
        res = dp_result(logs["worker0"])
        chief = logs["worker0"].splitlines()
        times = [float(x.split()[-1].rstrip("s")) for x in chief if x.startswith("Total Time: ")]
        total, last = times[-1], (times[-1] - times[-11]) / 10
        steps_a_rank = res["global_step"] // (1 if kind == "sync" else DP_WORKERS)
        examples = steps_a_rank * 100 * DP_WORKERS
        if kind == "sync":
            accs = [float(x.split()[-1]) for x in chief if x.startswith("Test-Accuracy: ")]
            want = single["trajectory"][:epochs]
            gap = max(abs(a - b) for a, b in zip(accs + [res["accuracy"]], want + want[-1:]))
            check = (f"phase 8's single-device trajectory within {gap:.4f} at every epoch "
                     f"(tolerance {DP_SYNC_ACC_TOL})")
        else:
            check = f"oracle >= {ACCURACY_ORACLE}"
        print(f"  (b) {kind} ({'per_worker_epoch' if kind == 'sync' else f'avg_every {DP_AVG_EVERY}'}"
              f"), {epochs} epochs (cut from 100): accuracy {res['accuracy']:.4f} "
              f"({check}), final cost {res['final_cost']:.4f}, global step "
              f"{res['global_step']}, {total / epochs:.3f} s an epoch ({last:.3f} over the "
              f"last 10), {examples / total:.1f} examples/s over both ranks; single device "
              f"(phase 8, plain scanned path): {single.get('plain_ex_s', float('nan')):.1f} "
              f"examples/s [{smi}]")
        if kind == "sync" and not (len(want) == len(accs) == epochs and gap <= DP_SYNC_ACC_TOL):
            raise AssertionError(f"sync: test accuracies {accs} (final {res['accuracy']}) off "
                                 f"the single-device run's {want}")
        if kind == "async" and not res["accuracy"] >= ACCURACY_ORACLE:
            raise AssertionError(f"{kind}: accuracy {res['accuracy']} below the oracle")
    B, IN, H, OUT, steps = 100, 784, 100, 10, ds.train.num_examples // 100
    flops = 2 * B * (IN * H * 2 + H * OUT * 3)
    pbytes = 4 * (IN * H + H + H * OUT + OUT)
    records["fused_mlp_epoch[dp-async]"] = dict(
        launches=r0["launches"], max_abs_err=max(r["max_abs_err"] for r in ranks),
        ms=r0["epoch_ms"],
        plain_ms=r0["plain_ms"], library_ms=None,
        **bound(2 * steps * B * (IN + OUT) + 2 * pbytes * (1 + rounds) + 4 * steps,
                steps * flops, PEAK_F32),
    )
    r = records["fused_mlp_epoch[dp-async]"]
    print(f"  fused_mlp_epoch[dp-async]: {r['ms']:.4f} ms an epoch a rank, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


# Phase 23 (ROADMAP A5): MoE blocks, the quantized products and head dim 4.
# (a) gpt-m-L1024-flash with the JAX package's MoE knobs, 8 experts, top-2,
# capacity factor 2.0, trained on phase 12(a)'s corpus cut to 256 training
# sequences (16 steps an epoch at batch 16), MOE_EPOCHS epochs (cut from 3
# to keep the smoke's time with phase 24 added), and a top-1 (Switch)
# epoch; (b) that model served at the capacity factor E / k, at which no
# dispatch is ever dropped (so a served stream is the in-process decode's),
# MOE_REQUESTS of phase 4's requests.
MOE_KW = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=2.0)
MOE_CORPUS = dict(TRAIN_CORPUS, num=768)
MOE_EPOCHS = 2
MOE_LOG_EVERY = 4
MOE_REQUESTS = 8
# (b) and (d) decode MOE_MAX_NEW new tokens a request (cut from phase 4's
# MAX_NEW = 48 to pay for phase 28: every server of (b) and (d) decodes on
# "xla", ~20 ms a step).
MOE_MAX_NEW = 24
# (c) quantized_dot at gpt-m's up projection in training (16 x 1024 rows of
# 512 into 2048 columns): int8 bit for bit with its plain version (the
# exact product, in f64), fp8 within QDOT_FP8_TOL of the largest of its
# plain version's f32 sums of the same exact products (the H100's fp8
# products accumulate in less than f32's precision: 3.3e-4 of the largest
# at k=512 in a first run, PERF.md); gpt-m trained QUANT_EPOCHS epochs of
# that corpus (16 steps an epoch) per matmul dtype, held-out perplexity within
# QUANT_PPL_TOL of the bf16 run's (the JAX package's loss-parity contract,
# tests/test_quantized.py:208).
QDOT_SHAPE = (16 * 1024, 512, 2048)
QDOT_FP8_TOL = 1e-3
# Cut (PR 20) from 2 epochs to 1 (16 steps a matmul dtype).
QUANT_EPOCHS = 1
QUANT_PPL_TOL = 0.15
# (e) head dim 4: the JAX engine's GQA test model
# (tests/test_pallas_decode.py:171-176, tiny(num_heads=8, num_kv_heads=2):
# d=32 over 8 heads of 4, 2 KV heads, RoPE), bf16 and f32 compute, each over
# its own dtype's cache and int8 and e4m3 codes: <kernel>[dh4-<compute>-<cache>].
DH4_KNOBS = dict(model_dim=32, num_heads=8, num_kv_heads=2, pos_embedding="rope")
DH4_LABELS = tuple(f"dh4-{cd}-{kv}" for cd in ("bf16", "f32") for kv in (cd, "int8", "fp8"))


class InProcessGreedy:
    """The in-process reference of served greedy streams: ``generate``
    through ``model.greedy_decode`` a request (``compare_streams`` reruns
    its continuations the same way; ``_pick`` is there for ``PickLog``)."""

    def __init__(self, model, params):
        self.model, self.params = model, params

    def _pick(self, *args):
        raise AssertionError("the in-process reference decodes greedy requests only")

    def generate(self, prompts, configs):
        import torch

        out = []
        for p, c in zip(prompts, configs):
            if not c.greedy:
                raise AssertionError("the in-process reference decodes greedy requests only")
            t = torch.from_numpy(np.asarray(p, np.int32)).to(self.params.embed.device)[None]
            out.append(self.model.greedy_decode(self.params, t, c.max_new)[0, len(p):]
                       .cpu().numpy())
        return out


def step_costs(lines):
    """(costs, AvgTime ms) of a run's Step lines."""
    steps = [ln for ln in lines if ln.startswith("Step:")]
    return ([float(ln.split("Cost:")[1].split(",")[0]) for ln in steps],
            [float(ln.split("AvgTime:")[1].rstrip("ms")) for ln in steps])


def lm_run(label, model, ds, epochs, log_every=MOE_LOG_EVERY):
    """``LMTrainer.run()`` of ``model`` on ``ds`` for ``epochs`` (phase
    12(a)'s optimizer and batch), the launches counted from zero: (trainer,
    result, launches, costs, the last window's ms a step). The run must end
    in Done with finite costs and perplexities, and the cost fall."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    lines = []
    cfg = dict(TRAIN_CFG, epochs=epochs, log_frequency=log_every)
    tr = LMTrainer(model, ds, TrainConfig(**cfg), eval_batch=TRAIN_EVAL_BATCH,
                   print_fn=lines.append)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    costs, avg = step_costs(lines)
    ppls = [h["perplexity"] for h in tr.history]
    print(f"  {label}: {res['global_step']} steps in {wall:.2f} s, {avg[-1]:.2f} ms a step "
          f"(the last window), costs {costs[0]:.4f} -> {costs[-1]:.4f}, held-out perplexity "
          f"{', '.join(f'{p:.4f}' for p in ppls)}; launches {launches}")
    if lines[-1] != "Done" or not np.isfinite([res["final_cost"], *costs, *ppls]).all():
        raise AssertionError(f"{label}: the training run failed: {lines[-3:]}")
    if not costs[-1] < costs[0]:
        raise AssertionError(f"{label}: the cost did not fall: {costs}")
    return tr, res, launches, costs, avg[-1]


def phase_moe_train(records):
    """Phase 23(a): the MoE gpt-m trained through ``LMTrainer.run()``; B3
    and B4 must launch, the cost and the held-out perplexity fall; the
    router's drop fraction and largest expert share on a held-out batch are
    printed, and ms a step beside phase 12(a)'s dense step. Returns the
    top-2 model and its trained parameters."""
    import torch
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    ds = markov_corpus(**MOE_CORPUS)
    uni = unigram_perplexity(ds.train.tokens, MOE_CORPUS["vocab"])
    print(f"  {ds.train.num_examples} training sequences of {ds.train.seq_len} tokens, "
          f"{ds.train.num_examples // TRAIN_CFG['batch_size']} steps an epoch, unigram "
          f"perplexity {uni:.2f}; dense gpt-m (phase 12(a)) "
          f"{records['flash_bwd_fused']['step_ms']:.2f} ms a step")
    kept = None
    for k, epochs in ((MOE_KW["moe_top_k"], MOE_EPOCHS), (1, 1)):
        model = GPTLM(**SERVE_CFG, **dict(MOE_KW, moe_top_k=k), compute_dtype=torch.bfloat16)
        label = f"MoE E={model.moe_experts} top-{k}"
        tr, res, launches, _, ms = lm_run(label, model, ds, epochs)
        if launches.get("flash_fwd", 0) < 1 or (launches.get("flash_bwd_fused", 0)
                                                 + launches.get("flash_bwd_dq", 0)) < 1:
            raise AssertionError(f"{label}: B3 or B4 never launched: {launches}")
        ppls = [h["perplexity"] for h in tr.history]
        if len(ppls) > 1 and not ppls[-1] < ppls[0]:
            raise AssertionError(f"{label}: held-out perplexity did not fall: {ppls}")
        with torch.no_grad():
            toks = torch.from_numpy(ds.validation.tokens[: TRAIN_CFG["batch_size"]]).cuda()
            _, met = model.loss_and_metrics(tr.state.params, toks)
        frac = met["expert_fraction"].float().cpu().numpy()
        print(f"  {label}: held-out ce {float(met['ce']):.4f}, balance "
              f"{float(met['balance_loss']):.4f}, z {float(met['z_loss']):.4f}, drop fraction "
              f"{float(met['drop_fraction']):.4f}, largest expert fraction {frac.max():.4f} "
              f"(uniform {1 / model.moe_experts:.4f}); {ms:.2f} ms a step against the dense "
              f"{records['flash_bwd_fused']['step_ms']:.2f}")
        if kept is None:
            kept = (model, tr.state.params)
        del tr
    return kept


def phase_moe_serve(records, model, params):
    """Phase 23(b): the trained MoE model served at capacity factor E / k
    (no drops) on the slab and the pool: the engine resolves to "xla", the
    slab's prefill launches B3 and no decode kernel launches; the greedy
    streams are held against the in-process ``greedy_decode`` under
    ``compare_streams``' rule; tokens/s and ms a step."""
    import copy

    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import TextServer

    served = copy.copy(model)
    served.moe_capacity_factor = model.moe_experts / model.moe_top_k
    prompts, configs = (r[:MOE_REQUESTS] for r in serve_requests(model.vocab_size, 0,
                                                                   MOE_MAX_NEW))
    greedy = [i for i, c in enumerate(configs) if c.greedy]
    ref = InProcessGreedy(served, params)
    want = None
    for name, kw in (("slab", {}), ("paged", dict(paged=True, block_size=BLOCK))):
        make = functools.partial(TextServer, served, params, slots=8, chunk=32, **kw)
        srv = make()
        if srv.engine != "xla":
            raise AssertionError(f"MoE {name}: the server resolved {srv.engine!r}, not 'xla'")
        _build.reset_launches()
        t0 = time.perf_counter()
        outs = srv.generate(prompts, configs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        tm, ntok = srv.timing, sum(len(o) for o in outs)
        print(f"  MoE {name}: engine {srv.engine}, launches {launches}; {ntok} tokens in "
              f"{wall:.3f} s: {ntok / wall:.1f} tokens/s; decode "
              f"{1e3 * tm['decode_s'] / tm['decode_steps']:.3f} ms a step")
        if any(launches.get(k, 0) for k in DECODE_KERNELS):
            raise AssertionError(f"MoE {name}: a decode kernel launched: {launches}")
        if not kw and launches.get("flash_fwd", 0) < 1:
            raise AssertionError(f"MoE {name}: the prefill never launched B3")
        for o, c in zip(outs, configs):
            if len(o) != c.max_new or o.min() < 0 or o.max() >= model.vocab_size:
                raise AssertionError(f"MoE {name}: bad stream {o}")
        gp, gc = [prompts[i] for i in greedy], [configs[i] for i in greedy]
        if want is None:
            want = ref.generate(gp, gc)
        compare_streams(f"MoE {name} vs greedy_decode", served, srv.params, gp, gc,
                        [outs[i] for i in greedy], want, (srv, ref), (make, lambda: ref))


def phase_quantized(records):
    """Phase 23(c): ``quantized_dot`` int8 and fp8 on the card against its
    plain version at gpt-m's training shape, timed beside the code product
    alone, the plain version and the bf16 product; then gpt-m trained
    QUANT_EPOCHS epochs with each matmul dtype, held-out perplexity within
    QUANT_PPL_TOL of the bf16 run's."""
    import torch
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import quantized as tq

    m, k, n = QDOT_SHAPE
    g = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = torch.randn(k, n, device="cuda", generator=g) / k ** 0.5
    xb, wb = x.bfloat16(), w.bfloat16()
    bf16_ms = cuda_ms(lambda: xb @ wb)
    flops = 2 * m * k * n
    print(f"  [{m}x{k}]·[{k}x{n}]: bf16 product {bf16_ms:.4f} ms "
          f"({flops / bf16_ms / 1e9:.1f} TFLOP/s)")
    for dt in ("int8", "fp8"):
        got = tq.quantized_dot(dt, x, w)
        ref = tq.quantized_dot_plain(dt, x, w)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if dt == "int8" and not torch.equal(got, ref):
            raise AssertionError(f"quantized_dot int8 differs from its exact plain version: {err}")
        if not err <= QDOT_FP8_TOL * scale:
            raise AssertionError(f"quantized_dot {dt}: {err} > {QDOT_FP8_TOL} * {scale}")
        qmax = tq._QMAX[dt]
        xq = tq._quantize(x / tq._amax_scale(x, -1, qmax), dt, qmax)
        wq = tq._quantize(w / tq._amax_scale(w, 0, qmax), dt, qmax)
        ms = cuda_ms(lambda: tq.quantized_dot(dt, x, w))
        prod_ms = cuda_ms(lambda: tq.code_product(xq, wq))
        plain_ms = cuda_ms(lambda: tq.quantized_dot_plain(dt, x, w), 5)
        print(f"  quantized_dot {dt}: max_abs_err {err:.3e} of {scale:.3e} "
              f"({'bit for bit' if dt == 'int8' else f'tolerance {QDOT_FP8_TOL}'}); "
              f"{ms:.4f} ms (the code product alone {prod_ms:.4f} ms, "
              f"{flops / prod_ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, bf16 {bf16_ms:.4f}")
    ds = markov_corpus(**MOE_CORPUS)
    ppl = {}
    for dt in (None, "int8", "fp8"):
        model = GPTLM(**SERVE_CFG, matmul_dtype=dt, compute_dtype=torch.bfloat16)
        tr, _, launches, _, ms = lm_run(f"gpt-m matmul_dtype={dt}", model, ds, QUANT_EPOCHS)
        if launches.get("flash_fwd", 0) < 1:
            raise AssertionError(f"matmul_dtype={dt}: B3 never launched: {launches}")
        ppl[dt] = tr.history[-1]["perplexity"]
        del tr
    for dt in ("int8", "fp8"):
        rel = abs(ppl[dt] - ppl[None]) / ppl[None]
        print(f"  held-out perplexity {dt} {ppl[dt]:.4f} vs bf16 {ppl[None]:.4f}: "
              f"{100 * rel:.2f}% apart (limit {100 * QUANT_PPL_TOL:.0f}%)")
        if not rel < QUANT_PPL_TOL:
            raise AssertionError(f"matmul_dtype={dt}: perplexity {rel:.3f} from bf16's")


def phase_weight_only_serve(records):
    """Phase 23(d): gpt-m served with ``decode_matmul_dtype`` int8 and fp8
    on the slab and the pool, and int8 with an int8 cache and
    ``spec_draft=2``: the engine resolves to "xla", no decode kernel
    launches, and the greedy streams are held against the in-process decode
    of ``decode_weights`` (``greedy_decode``; the int8-cache server against
    the same server without speculation) under ``compare_streams``' rule;
    ms a step beside the bf16 weights' on "xla"."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import TextServer

    model = GPTLM(**SERVE_CFG, compute_dtype=torch.bfloat16)
    params = perturbed_params(model, 0, "cuda")
    prompts, configs = (r[:MOE_REQUESTS] for r in serve_requests(model.vocab_size, 0,
                                                                   MOE_MAX_NEW))
    greedy = [i for i, c in enumerate(configs) if c.greedy]
    gp, gc = [prompts[i] for i in greedy], [configs[i] for i in greedy]
    pool = dict(paged=True, block_size=BLOCK)

    def serve(label, **kw):
        make = functools.partial(TextServer, model, params, slots=8, chunk=32, **kw)
        srv = make()
        _build.reset_launches()
        outs = srv.generate(prompts, configs)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        tm = srv.timing
        ms = 1e3 * tm["decode_s"] / max(tm["decode_steps"], 1)
        line = f"  {label}: engine {srv.engine}, decode {ms:.3f} ms a step"
        if tm["verify_ticks"]:
            line += (f", verify {1e3 * tm['verify_s'] / tm['verify_ticks']:.3f} ms a tick, "
                     f"{srv.counters['spec_tokens_accepted'] / tm['verify_ticks']:.3f} accepted")
        print(line + f"; launches {launches}")
        if srv.engine != "xla" or any(launches.get(k, 0) for k in DECODE_KERNELS):
            raise AssertionError(f"{label}: engine {srv.engine}, launches {launches}")
        return srv, make, [outs[i] for i in greedy]

    serve("bf16 weights, xla", decode_engine="xla")
    for dt in ("int8", "fp8"):
        qp = model.decode_weights(params, dt)
        ref = InProcessGreedy(model, qp)
        want = ref.generate(gp, gc)
        cases = [("slab", {}), ("paged", pool)]
        if dt == "int8":
            cases.append(("paged int8-kv spec_draft=2", dict(pool, kv_dtype="int8", spec_draft=2)))
        for name, kw in cases:
            srv, make, outs = serve(f"{dt} weights {name}", decode_matmul_dtype=dt, **kw)
            if "spec_draft" in kw:
                base = functools.partial(TextServer, model, qp, slots=8, chunk=32, paged=True,
                                         block_size=BLOCK, kv_dtype="int8")
                bsrv = base()
                bouts = bsrv.generate(gp, gc)
                compare_streams(f"{dt} weights {name} vs the same without speculation", model,
                                srv.params, gp, gc, outs, bouts, (srv, bsrv), (make, base),
                                "int8")
            else:
                compare_streams(f"{dt} weights {name} vs greedy_decode(decode_weights)", model,
                                srv.params, gp, gc, outs, want, (srv, ref), (make, lambda: ref))


def phase_dh4(records):
    """Phase 23(e): head dim 4 on B5, B6 and B7. Each of ``DH4_LABELS``
    (the JAX engine's GQA model's shapes: 2 layers, 8 slots at lengths
    NARROW_PROMPT..NARROW_PROMPT + NARROW_NEW of a cache of 64, one
    inactive) through :func:`kernel_variants` (the checks of
    ``narrow_kernels``: B5 slab/paged, B6 slab/paged and B7 against their
    plain versions, paged == slab and B5 layer by layer == B6 bit for bit,
    timed beside the plain version and the bound); then the model in bf16
    and f32 served over each cache through phase 13's five servers, each
    held against "xla" (``phase_kv_serve``, ``narrow_requests``)."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    n, S, C = NARROW_CFG["num_layers"], 8, NARROW_CFG["max_len"]
    d, hq, hkv = DH4_KNOBS["model_dim"], DH4_KNOBS["num_heads"], DH4_KNOBS["num_kv_heads"]
    dh = d // hq
    lengths = torch.randint(NARROW_PROMPT, NARROW_PROMPT + NARROW_NEW + 1, (S,), device=dev,
                            generator=g, dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    active[S - 1] = False
    h = torch.randn(S, d, device=dev, generator=g)
    for cd, cdn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        w = layer_weights(n, d, hq, hkv, dh, 4 * d, g, dev, cd)
        ck, cv = (torch.randn(n, S, C, hkv, dh, device=dev, generator=g).to(cd)
                  for _ in range(2))
        for kv in ("bf16", "int8", "fp8"):
            label = f"dh4-{cdn}-{cdn if kv == 'bf16' else kv}"
            kernel_variants(records, (label, True, kv), w, ck, cv, lengths, active, h, hq=hq,
                            compute_dtype=cd)
    for cd, cdn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        model = GPTLM(**NARROW_CFG, **DH4_KNOBS, compute_dtype=cd)
        print(f"  dh4 ({cdn}): {DH4_KNOBS}, head_dim {model.head_dim}")
        phase_kv_serve(records, f"dh4-{cdn}", model, perturbed_params(model, 5, "cuda"),
                       ("bf16", "int8", "fp8"), paged_traffic=False,
                       requests=narrow_requests(model.vocab_size, 6))


def phase_moe_quantized(records):
    """Phase 23: (a) MoE training, (b) MoE serving, (c) the quantized
    products, (d) weight-only decode, (e) head dim 4."""
    t = time.perf_counter()

    def part(title):
        nonlocal t
        now = time.perf_counter()
        print(f"  ({title}) [{now - t:.1f} s since the last part]")
        t = now

    part("a: MoE training")
    model, params = phase_moe_train(records)
    part("b: MoE serving")
    phase_moe_serve(records, model, params)
    del model, params
    part("c: quantized products")
    phase_quantized(records)
    part("d: weight-only decode")
    phase_weight_only_serve(records)
    part("e: head dim 4")
    phase_dh4(records)
    part("end")


# Phase 24 (ROADMAP A7a): sequence-parallel GPT training over the ring-flash
# path. Two ranks share the card over gloo (as phase 20's), a ("data",
# "seq") mesh of 1 x 2, and train the long-context presets of
# tools/lm_bench.py (:69-89; gpt-s widths, batch 8, bf16, Adam 1e-3) under
# dp_mode="sp" on phase 18's corpus recipe at their lengths: each run as
# (label, model knobs, L, steps, sp_attention, the offset records its
# launches fill). At L=2048 over 2 ranks a windowed model's past hop is
# the kernels' offset variant at L_loc 1024, W 512, offset 1024 (rows
# 511-1023 see no key); the same model at L=1024 gives a 4-rank hop's
# shape at L=2048 (L_loc 512, offset 512: every row but the last sees
# keys). GPT training feeds the flash kernels f32 q/k/v (the projections
# accumulate in f32), so the path runs the f32 offset builds; the bf16 ones
# are held to their plain versions in (a) and timed, and launched by no
# path. Cut: the steps (SP_STEPS on the W512 preset, one on the others).
SP_RANKS = 2
SP_BATCH = 8
SP_STEPS = 4
SP_RUNS = (
    ("gpt-s-L2048-flash-W512", {"window": 512}, 2048, SP_STEPS, "ring_flash",
     {"flash_fwd": "flash_fwd[offset]", "flash_bwd_fused": "flash_bwd_fused[offset]"}),
    ("gpt-s-L2048-flash-W512 flash_fused=False", {"window": 512, "flash_fused": False}, 2048, 1,
     "ring_flash", {"flash_bwd_dq": "flash_bwd_dq[offset]",
                    "flash_bwd_dkv": "flash_bwd_dkv[offset]"}),
    ("gpt-s-L2048-flash-W512 gqa2", {"window": 512, "num_kv_heads": 2}, 2048, 1, "ring_flash",
     {"flash_fwd": "flash_fwd[offset-gqa2]", "flash_bwd_fused": "flash_bwd_fused[offset-gqa2]"}),
    ("gpt-s-L1024-flash-W512", {"window": 512}, 1024, 1, "ring_flash",
     {"flash_fwd": "flash_fwd[offset-4rank]",
      "flash_bwd_fused": "flash_bwd_fused[offset-4rank]"}),
    ("gpt-s-L2048-flash", {}, 2048, 1, "ring_flash", {}),
    ("gpt-s-L2048-flash-gqa2", {"num_kv_heads": 2}, 2048, 1, "ring_flash", {}),
    ("gpt-s-L2048-flash-W512 ulysses", {"window": 512}, 2048, 1, "ulysses", {}),
)
# The offset records: record -> (kernel, path).
FLASH_OFFSET = {rec: (k, f"lm-train-sp {label}") for label, _, _, _, _, fills in SP_RUNS
                for k, rec in fills.items()}
# (a)'s cases: (label, dtype, B, L_loc, query heads, KV heads, D, W, offset).
OFFSET_CASES = (("offset", "float32", 8, 1024, 8, 8, 32, 512, 1024),
                ("offset-bf16", "bfloat16", 8, 1024, 8, 8, 32, 512, 1024),
                ("offset-gqa2", "float32", 8, 1024, 8, 2, 32, 512, 1024),
                ("offset-4rank", "float32", 8, 512, 8, 8, 32, 512, 512))
# Tolerances of the sp runs against the single-device runs of the same
# preset, seed and batches (CHANGES.md): every step's loss within
# SP_LOSS_RTOL of max(1, |loss|) (measured up to 3.2e-6; with the offset
# hop's result weighted 0, 3.7e-5), and the final parameters' distance
# from the single-device ones within SP_PARAM_REL of how far the
# single-device run moved them (the norms over all the parameters). Adam
# moves an element by about lr in the sign of its gradient whatever the
# gradient's size, so elements whose gradients are at the two runs'
# rounding level (sums over the ring's hops and ranks against one pass) may
# move opposite ways: a small leaf (a bias) can sit 8% of its movement
# apart after 3 steps while the losses agree to 1e-5.
SP_LOSS_RTOL = 2e-5
SP_PARAM_REL = 0.05
# The ring-flash attention check of 24(b): the window and the seed of its
# inputs (sp_attention_inputs).
SP_ATTN_WINDOW = 512
SP_ATTN_SEED = 24


def offset_band(l, w, f, device):
    """[L, L] bool: query row i (at position i + f) keeps key j iff
    i + f - w < j <= i + f."""
    import torch

    pos = torch.arange(l, device=device)
    d = pos[:, None] + f - pos[None, :]
    return (d >= 0) & (d < w)


def offset_kernels(records, smi):
    """24(a): B3, B4a, B4b and B4c with the ring offset at the hops' shapes
    (``OFFSET_CASES``), each against its plain version (f32: REL_TOL; bf16:
    2^-7 of the largest output forward, BWD_BF16_TOL backward); rows that
    see no key must give out 0, lse -1e30 and zero dq exactly. Timed with
    CUDA events beside the plain version, the bound of the band's (q, k)
    pairs and of the bytes the band touches, and SDPA with the shifted band
    as a boolean mask (forward, and its backward beside B4a). Records
    ``[offset]`` (B4b and B4c too), ``[offset-gqa2]`` and ``[offset-4rank]``
    (f32: the inputs the training path gives them); the bf16 case is
    printed."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    for label, dtype, b, l, hq, hkv, d, w, f in OFFSET_CASES:
        dt = getattr(torch, dtype)
        q, do = (torch.randn(b, l, hq, d, device=dev, generator=g).to(dt) for _ in range(2))
        k, v = (torch.randn(b, l, hkv, d, device=dev, generator=g).to(dt) for _ in range(2))
        kw = dict(causal=True, window=w, offset=f)
        band = offset_band(l, w, f, dev)
        empty = ~band.any(-1)  # rows that see no key
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1) - 0.1  # an lse cotangent of 0.1
        torch.cuda.synchronize()
        scale = max(1.0, ref.float().abs().max().item())
        live = ~empty
        err = max((out.float() - ref.float()).abs().max().item(),
                  (lse[:, live] - ref_lse[:, live]).abs().max().item())
        tol = REL_TOL["flash_fwd"] * scale if dt == torch.float32 else 2 ** -7 * scale
        rows = int(empty.sum().item())
        print(f"  {label} (B={b} L_loc={l} {hq}/{hkv}x{d} {dtype}, W={w}, offset {f}; rows "
              f"{'%d-%d' % (int(empty.nonzero()[0]), l - 1) if rows else 'none'} see no key): "
              f"flash_fwd max_abs_err {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"flash_fwd[{label}] disagrees with its plain version")
        if rows and not (out[:, empty].abs().max().item() == 0
                         and lse[:, empty].max().item() <= -1e29):
            raise AssertionError(f"flash_fwd[{label}]: a row that sees no key is not 0 / -1e30")
        ref_b = fa.flash_bwd_plain(q, k, v, out, lse, do, delta, None, True, w, offset=f)
        calls = {"flash_bwd_fused": lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw),
                 "flash_bwd_dq": lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw), None,
                                          None),
                 "flash_bwd_dkv": lambda: (None, *fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                                   **kw))}
        rel = REL_TOL["flash_bwd_fused"] if dt == torch.float32 else BWD_BF16_TOL
        errs = {}
        for name, call in calls.items():
            got = call()
            errs[name] = check_bwd(f"{name}[{label}] vs plain", got, ref_b, rel)
            if rows and got[0] is not None and got[0][:, empty].abs().max().item() != 0:
                raise AssertionError(f"{name}[{label}]: a row that sees no key has a dq")
        del ref_b
        # The bound's bytes are those the band touches: the query rows that
        # see a key (q and dO, with their lse and delta), the keys some row
        # keeps (k and v), and every output written whole.
        pairs = b * hq * int(band.sum().item())
        el, nq, nk = q.element_size(), int(live.sum().item()), int(band.any(0).sum().item())
        q_in, rows_in = el * b * hq * nq * d, 4 * b * hq * nq
        kv_in = 2 * el * b * hkv * nk * d
        q_out, kv_out, lse_out = el * q.numel(), el * (k.numel() + v.numel()), 4 * lse.numel()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        if hkv != hq:
            kt, vt = (x.repeat_interleave(hq // hkv, 1).detach().requires_grad_(True)
                      for x in (kt, vt))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
        dot = do.transpose(1, 2)
        lib = {"flash_fwd": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                           attn_mask=band)),
               "flash_bwd_fused": cuda_ms(lambda: torch.autograd.grad(
                   sdpa_out, (qt, kt, vt), dot, retain_graph=True), 10)}
        bnd = split_tf32_bound if dt == torch.float32 else (
            lambda nb, fl: bound(nb, fl, PEAK_BF16))
        fwd_plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 3)
        bwd_plain = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, delta, None, True,
                                                       w, offset=f), 2)
        work = {"flash_fwd": (q_in + kv_in + q_out + lse_out, 4 * d * pairs),
                "flash_bwd_fused": (2 * q_in + 2 * rows_in + kv_in + q_out + kv_out,
                                    10 * d * pairs),
                "flash_bwd_dq": (2 * q_in + 2 * rows_in + kv_in + q_out, 6 * d * pairs),
                "flash_bwd_dkv": (2 * q_in + 2 * rows_in + kv_in + kv_out, 8 * d * pairs)}
        timed = {"flash_fwd": lambda: fa.flash_attention_with_lse(q, k, v, **kw), **calls}
        for name in (("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
                     if label == "offset" else ("flash_fwd", "flash_bwd_fused")):
            r = dict(max_abs_err=err if name == "flash_fwd" else errs[name],
                     ms=cuda_ms(timed[name], 10),
                     plain_ms=fwd_plain if name == "flash_fwd" else bwd_plain,
                     library_ms=lib.get(name), **bnd(*work[name]))
            print(f"  {name}[{label}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"SDPA with the shifted band {r['library_ms']}, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}, {pairs} pairs) [{smi}]")
            if dt == torch.float32:
                records[f"{name}[{label}]"] = dict(r, launches=0)
        del q, k, v, do, out, lse, delta, qt, kt, vt, sdpa_out


def leaf_names(tree, prefix=""):
    """The dotted field names of a NamedTuple tree's leaves, in
    ``tree_leaves`` order."""
    out = []
    for k, v in tree._asdict().items():
        out += leaf_names(v, f"{prefix}{k}.") if hasattr(v, "_fields") else [prefix + k]
    return out


def sp_corpus(l, steps, batch=SP_BATCH):
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus

    return markov_corpus(**{**TRAIN_CORPUS, "seq_len": l, "num": batch * steps + 16,
                            "n_val": 8, "n_test": 8})


def sp_trainer(label, knobs, l, steps, attention, mesh=None, print_fn=None, batch=SP_BATCH,
               dp_mode="sp", **trainer_kw):
    """The LMTrainer of one of ``SP_RUNS`` (on ``mesh`` under ``dp_mode``,
    or on one device; phases 25 and 26 take their own ``batch``, mode and
    trainer keywords), with its steps' costs and times recorded."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    model = GPTLM(**{**S_CFG, "max_len": l, **knobs}, attention_impl="flash", flash_min_len=0,
                  compute_dtype=torch.bfloat16)
    cfg = TrainConfig(epochs=1, batch_size=batch, optimizer="adam", learning_rate=1e-3,
                      log_frequency=steps, dp_mode=dp_mode if mesh is not None else "replicated")
    tr = LMTrainer(model, sp_corpus(l, steps, batch), cfg, mesh=mesh, sp_attention=attention,
                   eval_batch=8, print_fn=print_fn or (lambda *a: None), **trainer_kw)
    tr.costs, tr.step_ms = [], []
    step = tr._train_step

    def timed(toks, lens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = step(toks, lens)
        tr.costs.append(float(cost))  # waits for the step
        tr.step_ms.append((time.perf_counter() - t0) * 1e3)
        return cost

    tr._train_step = timed
    return tr


def sp_attention_inputs(device):
    """q, k, v [SP_BATCH, 2048, 8, 32] f32 from a seed: the inputs of
    phase 24(b)'s ring-flash attention check."""
    import torch

    g = torch.Generator(device=device).manual_seed(SP_ATTN_SEED)
    return [torch.randn(SP_BATCH, 2048, 8, 32, device=device, generator=g) for _ in range(3)]


def sp_task(port, argv) -> int:
    """One rank of phase 24's world (``--sp-task``, started by the
    launcher): every run of ``SP_RUNS`` through LMTrainer under
    dp_mode="sp" on a (1, SP_RANKS) mesh, its costs, step times, launches
    and hops, rank 0's final parameters saved to ``$DTF_SP_PARAMS``; then
    one ring-flash attention call (its rows saved there too) and one hop's
    exchange timed. Prints ``RESULT <json>`` last."""
    import torch
    from distributed_tensorflow_tpu_torch.cluster import bootstrap_from_argv
    from distributed_tensorflow_tpu_torch.config import ClusterConfig
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import ring_attention as ra
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    cluster = ClusterConfig.from_lists([f"127.0.0.1:{port + i}" for i in range(SP_RANKS)])
    ctx = bootstrap_from_argv(cluster, argv)
    mesh = make_mesh((1, SP_RANKS), ("data", "seq"))
    runs = []
    for label, knobs, l, steps, attention, _ in SP_RUNS:
        tr = sp_trainer(label, knobs, l, steps, attention, mesh, print_fn=print)
        _build.reset_launches()
        ra.reset_hops()
        res = tr.run()
        torch.cuda.synchronize()
        runs.append(dict(label=label, costs=tr.costs, step_ms=tr.step_ms, mode=tr.mode,
                         launches={k: v for k, v in _build.LAUNCHES.items() if v},
                         hops=dict(ra.HOPS), final_cost=res["final_cost"],
                         perplexity=res["perplexity"]))
        if mesh.rank == 0:
            torch.save([t.detach().cpu() for t in tree_leaves(tr.state.params)],
                       os.path.join(os.environ["DTF_SP_PARAMS"], f"{len(runs)}.pt"))
        del tr
    # One ring-flash attention call at the W512 run's shape in f32, on
    # inputs made from a seed: this rank's rows, saved for phase_sp to hold
    # against one card's plain attention (a hop or offset that is wrong
    # moves them far past f32's rounding, where the training runs' bf16
    # products can hide it).
    q, k, v = sp_attention_inputs(mesh.device)
    l_loc, my = q.shape[1] // SP_RANKS, mesh.axis_index("seq")
    rows = slice(my * l_loc, (my + 1) * l_loc)
    out = ra.ring_flash_attention(*(t[:, rows].contiguous() for t in (q, k, v)), mesh, "seq",
                                  causal=True, window=SP_ATTN_WINDOW)
    torch.save(out.cpu(), os.path.join(os.environ["DTF_SP_PARAMS"], f"attn{my}.pt"))
    del q, k, v, out
    # One hop's exchange at the main run's shapes: the k/v pair of a layer,
    # [8, 1024, 8, 32] each, as the ring moves it (bf16 and the f32 the
    # training path holds).
    hop = {}
    for dt in (torch.bfloat16, torch.float32):
        kv = [torch.randn(SP_BATCH, 1024, 8, 32, device=mesh.device).to(dt) for _ in range(2)]
        for _ in range(3):
            mesh.ring_permute(kv, "seq")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            mesh.ring_permute(kv, "seq")
        torch.cuda.synchronize()
        hop[str(dt).split(".")[1]] = dict(ms=(time.perf_counter() - t0) / 20 * 1e3,
                                          bytes=2 * kv[0].numel() * kv[0].element_size())
    ctx.close()
    print("RESULT " + json.dumps(dict(rank=mesh.rank, backend=mesh.backend, runs=runs, hop=hop,
                                      device=str(mesh.device))))
    return 0


def phase_sp(records, smi):
    """24: (a) the offset kernels (``offset_kernels``); (b) SP_RANKS ranks
    on the card train each of ``SP_RUNS`` through LMTrainer(dp_mode="sp"),
    each held to a single-device LMTrainer run of the same preset, seed
    and batches (SP_LOSS_RTOL on every step's loss, SP_PARAM_REL on the
    final parameters), every rank's launches and hops checked against its
    place on the ring, and one ring-flash attention call over the ranks in
    f32 against one card's plain attention; (c) ms a step for sp and for
    one device, the backend and one hop's exchange."""
    import socket
    import tempfile

    import torch
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    offset_kernels(records, smi)

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    pdir = tempfile.mkdtemp(prefix="sp-params-")
    me = [sys.executable, os.path.abspath(__file__)]
    logs = dp_launch("sp-ring", me + ["--sp-task", "--dp-port", str(free_port())], SP_RANKS, 0,
                     env={"DTF_SP_PARAMS": pdir})
    ranks = sorted((dp_result(logs[f"worker{r}"]) for r in range(SP_RANKS)),
                   key=lambda r: r["rank"])
    for r in ranks:
        if r["backend"] != "gloo":
            raise AssertionError(f"{SP_RANKS} ranks on one card took {r['backend']}")
    n = S_CFG["num_layers"]
    for i, (label, knobs, l, steps, attention, fills) in enumerate(SP_RUNS):
        got = [r["runs"][i] for r in ranks]
        ref_tr = sp_trainer(label, knobs, l, steps, None)
        ini = [t.detach().cpu().clone() for t in tree_leaves(ref_tr.state.params)]
        ref_tr.run()
        torch.cuda.synchronize()
        # Per-step losses, every rank, against one device (relative to
        # max(1, |loss|)).
        gap = max(abs(a - b) / max(1.0, abs(b)) for r in got
                  for a, b in zip(r["costs"], ref_tr.costs))
        sp_params = torch.load(os.path.join(pdir, f"{i + 1}.pt"))
        ref = tree_leaves(ref_tr.state.params)
        # |sp - one device| / |one device - initial| over all the parameters
        # (and per leaf, printed).
        diff = [(a.float() - b.float().cpu()) for a, b in zip(sp_params, ref)]
        step = [(b.float().cpu() - c.float().cpu()) for b, c in zip(ref, ini)]
        moved = (torch.cat([d.reshape(-1) for d in diff]).norm()
                 / torch.cat([d.reshape(-1) for d in step]).norm()).item()
        gaps = [(d.norm() / max(m.norm(), 1e-12)).item() for d, m in zip(diff, step)]
        worst = f"{leaf_names(ref_tr.state.params)[gaps.index(max(gaps))]} {max(gaps):.2e}"
        far = max(d.abs().max().item() for d in diff)
        # The ring's place of each rank: rank 0's past block wraps round from
        # the future (skipped); rank 1's is its past (the offset hop under a
        # window, else the full block).
        hops0, hops1 = got[0]["hops"], got[1]["hops"]
        calls = n * steps
        want0 = want1 = {"diag": 0, "full": 0, "offset": 0, "skip": 0}
        if attention == "ring_flash":
            want0 = {"diag": calls, "full": 0, "offset": 0, "skip": calls}
            want1 = {"diag": calls, "full": 0 if "window" in knobs else calls,
                     "offset": calls if "window" in knobs else 0, "skip": 0}
        off = [{k: v for k, v in r["launches"].items() if k.endswith("[offset]")} for r in got]
        want_off = {}
        if attention == "ring_flash" and "window" in knobs:  # B3, then B4a or B4b + B4c
            bwd = (("flash_bwd_dq", "flash_bwd_dkv") if knobs.get("flash_fused") is False
                   else ("flash_bwd_fused",))
            want_off = {f"{k}[offset]": calls for k in ("flash_fwd", *bwd)}
        sp_ms = float(np.median(got[0]["step_ms"][1:] or got[0]["step_ms"]))
        one_ms = float(np.median(ref_tr.step_ms[1:] or ref_tr.step_ms))
        print(f"  (b) {label} ({steps} steps of {SP_BATCH} x {l}, sp_attention={attention}): "
              f"losses {', '.join(f'{c:.4f}' for c in got[0]['costs'])} (one device "
              f"{', '.join(f'{c:.4f}' for c in ref_tr.costs)}; largest gap "
              f"{max(abs(a - b) for a, b in zip(got[0]['costs'], ref_tr.costs)):.2e}, relative "
              f"{gap:.2e} (tolerance {SP_LOSS_RTOL})); final parameters {moved:.2e} of the "
              f"single-device run's movement from the initial ones apart (tolerance "
              f"{SP_PARAM_REL}; the leaf furthest apart {worst}; largest element gap "
              f"{far:.2e}); hops rank 0 {hops0}, rank 1 {hops1}; offset launches rank 1 "
              f"{off[1]}")
        print(f"  (c) {label}: {sp_ms:.2f} ms a step over {SP_RANKS} ranks on one card "
              f"({ranks[0]['backend']}), {one_ms:.2f} ms on one device [{smi}]")
        if any(len(r["costs"]) != steps for r in got) or not gap <= SP_LOSS_RTOL:
            raise AssertionError(f"{label}: sp losses {[r['costs'] for r in got]} against one "
                                 f"device's {ref_tr.costs} (relative gap {gap})")
        if hops0 != want0 or hops1 != want1:
            raise AssertionError(f"{label}: hops {hops0} / {hops1}, want {want0} / {want1}")
        if off[0] or off[1] != want_off:
            raise AssertionError(f"{label}: offset launches {off}, want none on rank 0 and "
                                 f"{want_off} on rank 1")
        if not moved <= SP_PARAM_REL:
            raise AssertionError(f"{label}: final parameters {moved} of the movement apart")
        for k, rec in fills.items():
            records[rec]["launches"] = off[1][f"{k}[offset]"]
        del ref_tr, sp_params, ref, ini
    # The ranks' ring-flash attention against one card's plain attention,
    # in f32 (flash_fwd's tolerance of the output's scale).
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_plain

    q, k, v = sp_attention_inputs(torch.device("cuda"))
    ref = flash_attention_plain(q, k, v, causal=True, window=SP_ATTN_WINDOW)[0].cpu()
    del q, k, v
    got = torch.cat([torch.load(os.path.join(pdir, f"attn{r}.pt")) for r in range(SP_RANKS)], 1)
    err, tol = (got - ref).abs().max().item(), REL_TOL["flash_fwd"] * ref.abs().max().item()
    print(f"  (b) ring_flash_attention over {SP_RANKS} ranks ({SP_BATCH} x 2048, 8x32, f32, "
          f"W={SP_ATTN_WINDOW}) against one card's plain attention: max_abs_err {err:.3e} "
          f"(tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"ring_flash_attention over {SP_RANKS} ranks disagrees: {err}")
    for r in ranks:
        for dt, h in r["hop"].items():
            print(f"  (c) rank {r['rank']}: one hop's exchange of a k/v pair ({h['bytes']} bytes "
                  f"{dt}, staged through the host under {r['backend']}): {h['ms']:.2f} ms [{smi}]")


# Phase 25: tensor parallelism (ROADMAP A7b) on TP_RANKS ranks sharing the
# card over gloo. The GPT runs: (label, mesh shape, mesh axes, preset knobs,
# L, global batch, steps, how it runs) of tools/lm_bench.py's gpt-s-L512-flash
# (:69-75 at L=512), gpt-s-L2048-flash-gqa2 (:83-89) and
# gpt-s-L2048-flash-W512 (:76-82); "trainer" is LMTrainer(dp_mode="tp"),
# "step" make_lm_train_step(mesh, tp_axis="model", seq_axis="seq").
TP_RANKS = 4
TP_RUNS = (
    ("gpt-s-L512-flash dp2 x tp2", (2, 2), ("data", "model"), {}, 512, 32, 4, "trainer"),
    ("gpt-s-L2048-flash-gqa2 tp4", (1, 4), ("data", "model"), {"num_kv_heads": 2}, 2048, 8, 2,
     "trainer"),
    ("gpt-s-L2048-flash-W512 tp2 x sp2", (2, 2), ("model", "seq"), {"window": 512}, 2048, 8, 2,
     "step"),
)
# (d): the classifiers at their registry widths, f32, SyncDataParallel with
# their partition_specs on a (2, 2) mesh: (family, SGD rate of the JAX
# tests), TP_CLS_STEPS steps of TP_CLS_BATCH rows from a seed. Each step is
# held to one card's step from the same state (the tp run's, gathered), not
# the whole run to one card's run: the CNN's run at 0.05 is chaotic (one
# device's own run, its initial parameters scaled by 1 + 1e-7 noise, ends
# 4.5e-3 apart in cost), so two runs that differ only in the order of their
# sums part by more than any tolerance a fault would fail.
TP_CLASSIFIERS = (("mlp", 0.001), ("cnn", 0.05), ("lstm", 0.5))
TP_CLS_STEPS, TP_CLS_BATCH = 24, 100
# The local shape of (a)'s attention (B=16 of 32 over "data", 4 of the 8
# heads over "model"), where B3 and B4a are timed: record -> (kernel, path).
TP_LOCAL = (16, 512, 4, 32)
FLASH_TP = {"flash_fwd[tp-4x32]": ("flash_fwd", "lm-train-tp gpt-s-L512 dp2 x tp2"),
            "flash_bwd_fused[tp-4x32]": ("flash_bwd_fused", "lm-train-tp gpt-s-L512 dp2 x tp2")}


def tp_kernels(records, smi):
    """25: B3 and B4a at (a)'s local attention shape (``TP_LOCAL``, f32 as
    training gives them, causal) against their plain versions at REL_TOL,
    timed beside the plain version, the bound of the causal pairs and SDPA
    (forward, and its backward beside B4a). Recorded under ``FLASH_TP``."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    b, l, h, d = TP_LOCAL
    q, k, v, do, o, lse, delta, _ = bwd_inputs(b, l, h, h, d, torch.float32, False, False, g, dev)
    if not fa.resolve_fused(None, b * h, l, d):
        raise AssertionError("the auto rule does not take B4a at (a)'s local shape")
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
    err_f = max((o - ref_o).abs().max().item(), (lse - ref_lse).abs().max().item())
    tol = REL_TOL["flash_fwd"] * max(1.0, ref_o.abs().max().item())
    print(f"  flash_fwd[tp-4x32] (B={b} L={l} {h}x{d} f32 causal) vs plain: max_abs_err "
          f"{err_f:.3e} (tolerance {tol:.3e})")
    if not err_f <= tol:
        raise AssertionError("flash_fwd[tp-4x32] disagrees with its plain version")
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True)
    err_b = check_bwd("flash_bwd_fused[tp-4x32] vs plain",
                      fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True), ref,
                      REL_TOL["flash_bwd_fused"])
    del ref
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    pairs, io, rows = b * h * band_pairs(l, l), 4 * q.numel(), 4 * lse.numel()
    work = {"flash_fwd": (4 * io + rows, 4 * d * pairs),
            "flash_bwd_fused": (7 * io + 2 * rows, 10 * d * pairs)}
    timed = {"flash_fwd": (lambda: fa.flash_attention_with_lse(q, k, v, causal=True),
                           lambda: fa.flash_attention_plain(q, k, v, causal=True),
                           lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                           err_f),
             "flash_bwd_fused": (lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True),
                                 lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None,
                                                            True),
                                 lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                             retain_graph=True), err_b)}
    for rec, (base, _) in FLASH_TP.items():
        kernel, plain, lib, err = timed[base]
        records[rec] = r = dict(max_abs_err=err, ms=cuda_ms(kernel, 10),
                                plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(lib, 10),
                                launches=0, **split_tf32_bound(*work[base]))
        print(f"  {rec}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['bound_peak']}) [{smi}]")
    del q, k, v, do, o, lse, delta, qt, kt, vt, out


def tp_gpt(label, knobs, l, batch, steps, how, mesh=None):
    """One of ``TP_RUNS`` (on ``mesh``, or on one device: LMTrainer in the
    single mode, or the single-device step): its costs, step times, the
    launches of its training steps and the canonical parameters (a
    collective under tp)."""
    import torch
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.specs import gather_tree, shard_tree

    if how == "trainer":
        tr = sp_trainer(label, knobs, l, steps, None, mesh, batch=batch, dp_mode="tp")
        init = [t.detach().cpu().clone() for t in tree_leaves(tr.to_canonical().params)]
        _build.reset_launches()
        tr.run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        return dict(costs=tr.costs, step_ms=tr.step_ms, launches=launches,
                    params=tr.to_canonical().params, init=init)
    model = GPTLM(**{**S_CFG, "max_len": l, **knobs}, attention_impl="flash", flash_min_len=0,
                  compute_dtype=torch.bfloat16)
    ds = sp_corpus(l, steps, batch)
    params = model.init(1, device="cuda")
    init = [t.detach().cpu().clone() for t in tree_leaves(params)]
    opt = optim_lib.adam(1e-3)
    specs = None
    if mesh is None:
        step = make_lm_train_step(model, opt)
    else:
        specs = model.partition_specs("model")
        step = make_lm_train_step(model, opt, mesh, tp_axis="model", seq_axis="seq")
        params = shard_tree(params, specs, mesh)
    o, costs, step_ms = opt.init(params), [], []
    _build.reset_launches()
    for i in range(steps):
        toks = torch.from_numpy(ds.train.tokens[i * batch:(i + 1) * batch]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, o, loss = step(params, o, toks)
        costs.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if specs is not None:
        params = gather_tree(params, specs, mesh)
    return dict(costs=costs, step_ms=step_ms, launches=launches, params=params, init=init)


def tp_cls_batches():
    """(d)'s TP_CLS_STEPS global batches of TP_CLS_BATCH rows, from a seed."""
    import torch

    g = torch.Generator().manual_seed(25)
    xs = torch.rand(TP_CLS_STEPS, TP_CLS_BATCH, 784, generator=g).numpy()
    ys = torch.eye(10)[torch.randint(0, 10, (TP_CLS_STEPS, TP_CLS_BATCH), generator=g)].numpy()
    return xs, ys


def tp_classifier(family, lr, mesh):
    """(d) on a rank: ``family`` at its registry width in f32 under
    SyncDataParallel(mesh, param_specs=partition_specs()), TP_CLS_STEPS SGD
    steps on ``tp_cls_batches``: the costs, ms a step, and the canonical
    parameters before every step and after the last (a collective)."""
    import torch
    from distributed_tensorflow_tpu_torch.models import build_model
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.strategy import SyncDataParallel

    model = build_model(family, compute_dtype=torch.float32)
    strat = SyncDataParallel(mesh, param_specs=model.partition_specs())
    opt = optim_lib.sgd(lr)
    state = strat.init_state(model, opt, seed=1)
    step = strat.make_train_step(model, cross_entropy, opt)

    def canonical():
        return [t.detach().cpu().clone() for t in tree_leaves(strat.to_canonical(state).params)]

    costs, states, spent = [], [canonical()], 0.0
    for x, y in zip(*tp_cls_batches()):
        batch = strat.prepare_batch(x, y)
        t0 = time.perf_counter()
        state, c = step(state, *batch)
        costs.append(float(c))
        spent += time.perf_counter() - t0
        states.append(canonical())
    return dict(costs=costs, ms=spent / TP_CLS_STEPS * 1e3, states=states)


def tp_classifier_replay(family, lr, states, device="cuda"):
    """(d) on one card: from each of a tp run's canonical ``states``, one
    SingleDevice SGD step on the same global batch: its cost, the
    parameters it reaches and ms a step."""
    import torch
    from distributed_tensorflow_tpu_torch.models import build_model
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_unflatten
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice, TrainState

    model = build_model(family, compute_dtype=torch.float32)
    strat = SingleDevice(device=device)
    opt = optim_lib.sgd(lr)
    like = model.init(1, device=device)
    step = strat.make_train_step(model, cross_entropy, opt)
    costs, reached, spent = [], [], 0.0
    for i, (leaves, x, y) in enumerate(zip(states, *tp_cls_batches())):
        params = tree_unflatten(like, [t.to(strat.device) for t in leaves])
        state, batch = TrainState(params, opt.init(params), i), strat.prepare_batch(x, y)
        t0 = time.perf_counter()
        state, c = step(state, *batch)
        costs.append(float(c))
        spent += time.perf_counter() - t0
        reached.append([t.detach().cpu() for t in tree_leaves(state.params)])
    return dict(costs=costs, ms=spent / TP_CLS_STEPS * 1e3, reached=reached)


def tp_task(port, argv) -> int:
    """One rank of phase 25's world (``--tp-task``, started by the
    launcher): every run of ``TP_RUNS`` on its mesh of the TP_RANKS ranks,
    its costs, step times and launches (and hops), rank 0's canonical
    parameters saved to ``$DTF_TP_PARAMS``; one tp all-reduce of (a)'s
    activation timed; then the classifiers of (d). Prints ``RESULT
    <json>`` last."""
    import torch
    from distributed_tensorflow_tpu_torch.cluster import bootstrap_from_argv
    from distributed_tensorflow_tpu_torch.config import ClusterConfig
    from distributed_tensorflow_tpu_torch.ops import ring_attention as ra
    from distributed_tensorflow_tpu_torch.ops.collectives import all_reduce_raw
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cluster = ClusterConfig.from_lists([f"127.0.0.1:{port + i}" for i in range(TP_RANKS)])
    ctx = bootstrap_from_argv(cluster, argv)
    out_dir = os.environ["DTF_TP_PARAMS"]
    meshes, runs = {}, []
    for label, shape, axes, knobs, l, batch, steps, how in TP_RUNS:
        if (shape, axes) not in meshes:  # a collective: every rank makes every mesh
            meshes[shape, axes] = make_mesh(shape, axes)
        mesh = meshes[shape, axes]
        ra.reset_hops()
        r = tp_gpt(label, knobs, l, batch, steps, how, mesh)
        if mesh.rank == 0:
            torch.save([t.detach().cpu() for t in tree_leaves(r["params"])],
                       os.path.join(out_dir, f"gpt{len(runs)}.pt"))
        runs.append(dict(label=label, costs=r["costs"], step_ms=r["step_ms"],
                         launches=r["launches"], hops=dict(ra.HOPS),
                         coords=mesh.coords))
        r.clear()
    # One tp all-reduce of (a)'s activation: [16, 512, 256] f32, the output
    # of a row-parallel product on a rank, summed over "model".
    mesh = meshes[(TP_RUNS[0][1], TP_RUNS[0][2])]
    x = torch.randn(16, 512, S_CFG["model_dim"], device=mesh.device)
    for _ in range(3):
        all_reduce_raw(x, mesh, "model")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        all_reduce_raw(x, mesh, "model")
    torch.cuda.synchronize()
    reduce = dict(ms=(time.perf_counter() - t0) / 20 * 1e3, bytes=x.numel() * x.element_size())
    cls = []
    for family, lr in TP_CLASSIFIERS:
        r = tp_classifier(family, lr, mesh)
        if mesh.rank == 0:
            torch.save(r["states"], os.path.join(out_dir, f"{family}.pt"))
        cls.append(dict(family=family, costs=r["costs"], ms=r["ms"]))
    ctx.close()
    print("RESULT " + json.dumps(dict(rank=mesh.rank, backend=mesh.backend, runs=runs,
                                      reduce=reduce, classifiers=cls, device=str(mesh.device))))
    return 0


def param_gap(got, ref, init):
    """|got - ref| / |ref - init| over all the leaves (phase 24's rule), and
    the largest element gap."""
    import torch

    diff = [a.float() - b.float().cpu() for a, b in zip(got, ref)]
    step = [b.float().cpu() - c.float().cpu() for b, c in zip(ref, init)]
    moved = (torch.cat([d.reshape(-1) for d in diff]).norm()
             / torch.cat([d.reshape(-1) for d in step]).norm()).item()
    return moved, max(d.abs().max().item() for d in diff)


def phase_tp(records, smi):
    """25: (a)-(c) the GPT runs of ``TP_RUNS`` and (d) the classifiers on
    TP_RANKS ranks sharing the card (gloo, each tensor-parallel collective
    staged through the host), each GPT run held to one card's run of the
    same preset, seed and batches (SP_LOSS_RTOL on every step's loss,
    SP_PARAM_REL on the final parameters), each classifier step to one
    card's step from the same state (the same two bounds); every rank's B3/B4 launches
    checked at its local head count (the offset builds on the ranks of the
    later sequence shard in (c)); ms a step beside one card's and one tp
    all-reduce's bytes and ms. B3 and B4a at (a)'s local shape first
    (``tp_kernels``)."""
    import socket
    import tempfile

    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    tp_kernels(records, smi)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pdir = tempfile.mkdtemp(prefix="tp-params-")
    me = [sys.executable, os.path.abspath(__file__)]
    logs = dp_launch("tp", me + ["--tp-task", "--dp-port", str(port)], TP_RANKS, 0,
                     env={"DTF_TP_PARAMS": pdir})
    ranks = sorted((dp_result(logs[f"worker{r}"]) for r in range(TP_RANKS)),
                   key=lambda r: r["rank"])
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"{TP_RANKS} ranks on one card took {[r['backend'] for r in ranks]}")
    n, d = S_CFG["num_layers"], S_CFG["model_dim"] // S_CFG["num_heads"]
    for i, (label, shape, axes, knobs, l, batch, steps, how) in enumerate(TP_RUNS):
        got = [r["runs"][i] for r in ranks]
        ref = tp_gpt(label, knobs, l, batch, steps, how)
        gap = max(abs(a - b) / max(1.0, abs(b)) for r in got for a, b in zip(r["costs"],
                                                                            ref["costs"]))
        moved, far = param_gap(torch.load(os.path.join(pdir, f"gpt{i}.pt")),
                               tree_leaves(ref["params"]), ref["init"])
        mesh = dict(zip(axes, shape))
        tp, dp = mesh["model"], mesh.get("data", 1)
        h_loc, b_loc = S_CFG["num_heads"] // tp, batch // dp
        tp_ms = float(np.median(got[0]["step_ms"][1:] or got[0]["step_ms"]))
        one_ms = float(np.median(ref["step_ms"][1:] or ref["step_ms"]))
        print(f"  ({'abc'[i]}) {label} ({steps} steps of {batch} x {l}, mesh {mesh}; {h_loc} "
              f"of {S_CFG['num_heads']} heads a rank): losses "
              f"{', '.join(f'{c:.4f}' for c in got[0]['costs'])} (one card "
              f"{', '.join(f'{c:.4f}' for c in ref['costs'])}; relative gap {gap:.2e}, "
              f"tolerance {SP_LOSS_RTOL}); final parameters {moved:.2e} of one card's movement "
              f"apart (tolerance {SP_PARAM_REL}; largest element gap {far:.2e})")
        print(f"  ({'abc'[i]}) {label}: {tp_ms:.2f} ms a step over {TP_RANKS} ranks on one card "
              f"(gloo), {one_ms:.2f} ms on one card [{smi}]")
        for r, g in zip(ranks, got):
            print(f"  | rank {r['rank']} {g['coords']}: launches {g['launches']}, hops {g['hops']}")
        if any(len(g["costs"]) != steps for g in got) or not gap <= SP_LOSS_RTOL:
            raise AssertionError(f"{label}: tp losses {[g['costs'] for g in got]} against one "
                                 f"card's {ref['costs']} (relative gap {gap})")
        if not moved <= SP_PARAM_REL:
            raise AssertionError(f"{label}: final parameters {moved} of the movement apart")
        calls = n * steps
        for g in got:
            if how == "trainer":
                evals = 1  # sp_corpus's 8 held-out rows: one eval_batch of 8
                fused = fa.resolve_fused(None, b_loc * h_loc, l, d, knobs.get("window"))
                bwd = ("flash_bwd_fused",) if fused else ("flash_bwd_dq", "flash_bwd_dkv")
                want = {"flash_fwd": n * (steps + evals), **{k: calls for k in bwd}}
                have = g["launches"]
            else:  # ring-flash over "seq": the later shard's past hop is the offset one
                later = g["coords"]["seq"] == 1
                l_loc = l // mesh["seq"]
                fused = fa.resolve_fused(None, b_loc * h_loc, l_loc, d, knobs.get("window"))
                bwd = ("flash_bwd_fused",) if fused else ("flash_bwd_dq", "flash_bwd_dkv")
                want = {f"{k}[offset]": calls for k in ("flash_fwd", *bwd)} if later else {}
                have = {k: v for k, v in g["launches"].items() if k.endswith("[offset]")}
                hops = {"diag": calls, "full": 0, "offset": calls if later else 0,
                        "skip": 0 if later else calls}
                if g["hops"] != hops:
                    raise AssertionError(f"{label}: hops {g['hops']}, want {hops}")
            if have != want:
                raise AssertionError(f"{label}: launches {have}, want {want}")
        if i == 0:
            for rec, (base, _) in FLASH_TP.items():
                records[rec]["launches"] = got[0]["launches"][base]
        del ref
    for r in ranks:
        red = r["reduce"]
        print(f"  (a) rank {r['rank']}: one tp all-reduce of a [16, 512, 256] f32 activation "
              f"({red['bytes']} bytes, over 'model', staged through the host under "
              f"{r['backend']}): {red['ms']:.2f} ms [{smi}]")
    for j, (family, lr) in enumerate(TP_CLASSIFIERS):
        got = [r["classifiers"][j] for r in ranks]
        states = torch.load(os.path.join(pdir, f"{family}.pt"))
        ref = tp_classifier_replay(family, lr, states)
        gap = max(abs(a - b) / max(1.0, abs(b)) for g in got for a, b in zip(g["costs"],
                                                                            ref["costs"]))
        apart = [param_gap(states[i + 1], ref["reached"][i], states[i])
                 for i in range(TP_CLS_STEPS)]
        moved, far = max(a for a, _ in apart), max(f for _, f in apart)
        print(f"  (d) {family}: {TP_CLS_STEPS} SGD steps of {TP_CLS_BATCH} rows on (2, 2), "
              f"cost {got[0]['costs'][0]:.4f} -> {got[0]['costs'][-1]:.4f}; one card's step "
              f"from each tp state: relative cost gap {gap:.2e} (tolerance {SP_LOSS_RTOL}), "
              f"parameters at most {moved:.2e} of that step's movement apart (tolerance "
              f"{SP_PARAM_REL}; largest element gap {far:.2e}); {got[0]['ms']:.2f} ms a step "
              f"over {TP_RANKS} ranks, {ref['ms']:.2f} on one card [{smi}]")
        if (any(len(g["costs"]) != TP_CLS_STEPS for g in got) or not gap <= SP_LOSS_RTOL
                or not moved <= SP_PARAM_REL):
            raise AssertionError(f"(d) {family}: tp disagrees with one card")


# Phase 26: expert and pipeline parallelism (ROADMAP A7c) on EPP_RANKS ranks
# sharing the card over gloo, every run through LMTrainer on tools/lm_bench.py's
# gpt-s-L512-flash (:57; S_CFG at L=512, batch 32, bf16): (key,
# label, mesh shape, mesh axes, model knobs, steps). (a) and (b) are MoE forms
# of the preset at a capacity factor of E/k, where no dispatch drops; (d)
# runs remat, so the stage's checkpoint recomputes its layer group a tick.
# Every run steps by SGD at EPP_LR, on the card and on one card alike. A
# gradient of bf16 weights is rounded to bf16 where it is formed: one card
# rounds the whole batch's, ep each shard's part of an expert's before the
# exchange sums them, pp each microbatch's; and Adam's first step is the
# sign of the gradient, so an element whose parts nearly cancel takes a
# whole step one way or the other. On the CPU at L=64 (bf16) Adam put (a)'s
# first step 3.6e-2 of its movement from one card's, and (c) and (d)
# 4.58e-2 and 6.39e-2 over their runs, against phase 24's 5e-2; SGD's step
# is the gradient itself (2.17e-3 for (a)).
# The pp runs take EPP_MICROBATCHES microbatches of 8 rows.
EPP_RANKS = 4
EPP_L, EPP_BATCH, EPP_MICROBATCHES = 512, 32, 4
EPP_LR = 0.1
EPP_RUNS = (
    ("a", "gpt-s-L512-flash, 4 experts top-2, ep 4", (4,), ("expert",),
     dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=2.0), 4),
    ("b", "gpt-s-L512-flash, 2 experts top-1, dp 2 x ep 2", (2, 2), ("data", "expert"),
     dict(moe_experts=2, moe_top_k=1, moe_capacity_factor=2.0), 2),
    ("c", "gpt-s-L512-flash, pp 4", (4,), ("stage",), {}, 4),
    ("d", "gpt-s-L512-flash, dp 2 x pp 2, remat", (2, 2), ("data", "stage"), {"remat": True}, 2),
)
# The local attention shape of (a)-(c) (8 of the 32 rows: an expert rank's
# batch shard, or a microbatch; 8 heads of 32), where B3 and B4a are timed:
# record -> (kernel, path). Their launches are rank 0's in (a)-(c).
EPP_LOCAL = (8, EPP_L, 8, 32)
EPP_PATH = "lm-train-ep/pp gpt-s-L512 ep4, dp2 x ep2, pp4"
FLASH_EPP = {"flash_fwd[ep-pp-8x512]": ("flash_fwd", EPP_PATH),
             "flash_bwd_fused[ep-pp-8x512]": ("flash_bwd_fused", EPP_PATH)}
EPP_KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")


def epp_kernels(records, smi):
    """26: B3 and B4a at the local attention shape of (a)-(c) (``EPP_LOCAL``,
    f32 as training gives them, causal) against their plain versions at
    REL_TOL, timed beside the plain version, the bound of the causal pairs
    and SDPA. Recorded under ``FLASH_EPP``."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    b, l, h, d = EPP_LOCAL
    q, k, v, do, o, lse, delta, _ = bwd_inputs(b, l, h, h, d, torch.float32, False, False, g, dev)
    if not fa.resolve_fused(None, b * h, l, d):
        raise AssertionError("the auto rule does not take B4a at the local shape")
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
    err_f = max((o - ref_o).abs().max().item(), (lse - ref_lse).abs().max().item())
    tol = REL_TOL["flash_fwd"] * max(1.0, ref_o.abs().max().item())
    print(f"  flash_fwd[ep-pp-8x512] (B={b} L={l} {h}x{d} f32 causal) vs plain: max_abs_err "
          f"{err_f:.3e} (tolerance {tol:.3e})")
    if not err_f <= tol:
        raise AssertionError("flash_fwd[ep-pp-8x512] disagrees with its plain version")
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None, True)
    err_b = check_bwd("flash_bwd_fused[ep-pp-8x512] vs plain",
                      fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True), ref,
                      REL_TOL["flash_bwd_fused"])
    del ref
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    pairs, io, rows = b * h * band_pairs(l, l), 4 * q.numel(), 4 * lse.numel()
    work = {"flash_fwd": (4 * io + rows, 4 * d * pairs),
            "flash_bwd_fused": (7 * io + 2 * rows, 10 * d * pairs)}
    timed = {"flash_fwd": (lambda: fa.flash_attention_with_lse(q, k, v, causal=True),
                           lambda: fa.flash_attention_plain(q, k, v, causal=True),
                           lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                           err_f),
             "flash_bwd_fused": (lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True),
                                 lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, delta, None,
                                                            True),
                                 lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                             retain_graph=True), err_b)}
    for rec, (base, _) in FLASH_EPP.items():
        kernel, plain, lib, err = timed[base]
        records[rec] = r = dict(max_abs_err=err, ms=cuda_ms(kernel, 10),
                                plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(lib, 10),
                                launches=0, **split_tf32_bound(*work[base]))
        print(f"  {rec}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['bound_peak']}) [{smi}]")
    del q, k, v, do, o, lse, delta, qt, kt, vt, out


def epp_trainer(knobs, steps, mesh=None):
    """The LMTrainer of one of ``EPP_RUNS`` (dp_mode "ep" when the mesh has
    an expert axis, "pp" when a stage axis; on one card without a mesh; SGD
    at EPP_LR),
    each step's cost, ms and B3/B4 launches recorded (the step alone: no
    eval, no check); under ep each step's canonical state before it (rank
    0 keeps it, for one card's step from it) and each rank's drop fraction
    on its shard."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    mode = "replicated" if mesh is None else ("ep" if "expert" in mesh.shape else "pp")
    tr = sp_trainer("", knobs, EPP_L, steps, None, mesh, batch=EPP_BATCH, dp_mode=mode,
                    pp_microbatches=EPP_MICROBATCHES, optimizer=optim_lib.sgd(EPP_LR))
    tr.launches, tr.drops, tr.states, tr.batches = {k: 0 for k in EPP_KERNELS}, [], [], []
    if mesh is None:  # one card's initial parameters, for phase 24's rule
        tr.init = [t.detach().cpu().clone() for t in tree_leaves(tr.state.params)]
    step = tr._train_step

    def checked(toks, lens):
        if mode == "ep":
            c = tr.to_canonical()  # a collective
            if mesh.rank == 0:
                tr.states.append(c)
                tr.batches.append(toks.clone())
            b, i = toks.shape[0] // mesh.size, mesh.axis_index(mesh.axis_names)  # data-major
            with torch.no_grad():
                _, aux = tr.model.apply_expert_parallel(tr.state.params, toks[i * b:(i + 1) * b],
                                                        mesh, with_aux=True)
            tr.drops.append(float(aux.drop_fraction.max()))
        before = {k: _build.LAUNCHES.get(k, 0) for k in EPP_KERNELS}
        cost = step(toks, lens)
        for k in EPP_KERNELS:
            tr.launches[k] += _build.LAUNCHES.get(k, 0) - before[k]
        return cost

    tr._train_step = checked
    return tr


def epp_reference_steps(tr):
    """(a)/(b) on one card, on rank 0: from each canonical state the ep
    run held before a step, one step of JAX's ep semantics (the mean over
    the shards, data-major, of each shard's ``model.loss``: CE and router
    terms over its rows) on the same global batch and optimizer: its loss, and
    how far the ep run's next state lies from where it lands (phase 24's
    rule on that step's movement)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_unflatten

    mesh = tr.mesh
    shards = mesh.size
    final = tr.to_canonical()  # every rank calls it: a collective
    if mesh.rank != 0:
        return None
    states = tr.states + [final]
    out = []
    for i, (c, toks) in enumerate(zip(tr.states, tr.batches)):
        b = toks.shape[0] // shards
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(c.params)]
        with torch.enable_grad():
            p = tree_unflatten(c.params, leaves)
            loss = sum(tr.model.loss(p, toks[s * b:(s + 1) * b]) for s in range(shards)) / shards
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            reached, _ = tr.optimizer.update(tree_unflatten(c.params, list(grads)), c.opt_state,
                                             c.params)
        got, want, init = ([t.cpu() for t in tree_leaves(x)]
                           for x in (states[i + 1].params, reached, c.params))
        moved, far = param_gap(got, want, init)
        leaf = [param_gap([a], [b], [c])[0] for a, b, c in zip(got, want, init)]
        worst = f"{leaf_names(c.params)[leaf.index(max(leaf))]} {max(leaf):.2e}"
        out.append(dict(loss=float(loss), moved=moved, far=far, worst=worst))
    return out


def epp_task(port, argv) -> int:
    """One rank of phase 26's world (``--epp-task``, started by the
    launcher): every run of ``EPP_RUNS`` on its mesh of the EPP_RANKS ranks,
    its costs, step times, launches and (ep) drop fractions; rank 0's
    canonical parameters of the pp runs saved to ``$DTF_EPP_PARAMS``, and
    its one-card steps from the ep runs' states; one all-to-all of (a)'s
    dispatch buffer and one hop of (c)'s microbatch timed. Prints ``RESULT
    <json>`` last."""
    import torch
    from distributed_tensorflow_tpu_torch.cluster import bootstrap_from_argv
    from distributed_tensorflow_tpu_torch.config import ClusterConfig
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cluster = ClusterConfig.from_lists([f"127.0.0.1:{port + i}" for i in range(EPP_RANKS)])
    ctx = bootstrap_from_argv(cluster, argv)
    out_dir = os.environ["DTF_EPP_PARAMS"]
    meshes, runs, refs = {}, [], {}
    for key, label, shape, axes, knobs, steps in EPP_RUNS:
        if (shape, axes) not in meshes:  # a collective: every rank makes every mesh
            meshes[shape, axes] = make_mesh(shape, axes)
        mesh = meshes[shape, axes]
        tr = epp_trainer(knobs, steps, mesh)
        res = tr.run()
        torch.cuda.synchronize()
        runs.append(dict(key=key, costs=tr.costs, step_ms=tr.step_ms, mode=tr.mode,
                         launches=tr.launches, drops=tr.drops, coords=mesh.coords,
                         perplexity=res["perplexity"],
                         local_w=list(tr.state.params.blocks.w_up.shape)))
        if tr.mode == "ep":
            refs[key] = epp_reference_steps(tr)
        else:
            params = tr.to_canonical().params  # a collective
            if mesh.rank == 0:
                torch.save([t.detach().cpu() for t in tree_leaves(params)],
                           os.path.join(out_dir, f"{key}.pt"))
        del tr
    # One all-to-all of (a)'s dispatch buffer: [4 experts, capacity, 256] bf16
    # (a rank's 8 x 512 tokens at factor 2.0, top-2: a capacity of 4096), and
    # one pipeline hop of (c)'s microbatch activation [8, 512, 256] f32.
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    ep = meshes[(4,), ("expert",)]
    pp = meshes[(4,), ("stage",)]
    cap = GPTLM(**S_CFG, **EPP_RUNS[0][4])._moe_capacity(EPP_BATCH // 4 * EPP_L)
    x = torch.randn(4, cap, S_CFG["model_dim"], device=ep.device).to(torch.bfloat16)
    h = torch.randn(8, EPP_L, S_CFG["model_dim"], device=pp.device)
    timed = {}
    for what, fn, nbytes in (("all_to_all", lambda: ep.all_to_all(x, "expert", 0, 0),
                              x.numel() * x.element_size()),
                             ("hop", lambda: pp.ring_permute([h], "stage"),
                              h.numel() * h.element_size())):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        timed[what] = dict(ms=(time.perf_counter() - t0) / 20 * 1e3, bytes=nbytes)
    ctx.close()
    print("RESULT " + json.dumps(dict(rank=ep.rank, backend=ep.backend, runs=runs, refs=refs,
                                      timed=timed, device=str(ep.device))))
    return 0


def phase_epp(records, smi):
    """26: B3 and B4a at the local shape (``epp_kernels``); then EPP_RANKS
    ranks sharing the card (gloo, every collective staged through the host)
    run ``EPP_RUNS`` through LMTrainer: (a) and (b) each step held to one
    card's step of JAX's ep semantics from the same gathered state (routing
    makes a whole run chaotic; SP_LOSS_RTOL on the loss, SP_PARAM_REL on
    that step's movement), every step's drop fraction 0 on every rank; (c)
    and (d) the whole run held to one card's LMTrainer run of the same
    preset, seed and batches (every step's loss, the final parameters by
    phase 24's rule). Every rank's B3/B4 launches against the count its
    schedule implies; ms a step beside one card's; one all-to-all's and one
    hop's bytes and ms."""
    import socket
    import tempfile

    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    epp_kernels(records, smi)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pdir = tempfile.mkdtemp(prefix="epp-params-")
    me = [sys.executable, os.path.abspath(__file__)]
    logs = dp_launch("epp", me + ["--epp-task", "--dp-port", str(port)], EPP_RANKS, 0,
                     env={"DTF_EPP_PARAMS": pdir})
    ranks = sorted((dp_result(logs[f"worker{r}"]) for r in range(EPP_RANKS)),
                   key=lambda r: r["rank"])
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"{EPP_RANKS} ranks on one card took {[r['backend'] for r in ranks]}")
    n, h, d = S_CFG["num_layers"], S_CFG["num_heads"], S_CFG["model_dim"] // S_CFG["num_heads"]
    local_launches = {k: 0 for k in EPP_KERNELS}
    for i, (key, label, shape, axes, knobs, steps) in enumerate(EPP_RUNS):
        got = [r["runs"][i] for r in ranks]
        mesh = dict(zip(axes, shape))
        ms = float(np.median(got[0]["step_ms"][1:] or got[0]["step_ms"]))
        one = epp_trainer(knobs, steps)  # one card: LMTrainer in the single mode
        one.run()
        torch.cuda.synchronize()
        one_ms = float(np.median(one.step_ms[1:] or one.step_ms))
        if "expert" in mesh:
            ref = ranks[0]["refs"][key]
            gap = max(abs(c - r["loss"]) / max(1.0, abs(r["loss"]))
                      for c, r in zip(got[0]["costs"], ref))
            moved, far = max(r["moved"] for r in ref), max(r["far"] for r in ref)
            worst = [r["worst"] for r in ref]
            drops = [g["drops"] for g in got]
            ref_losses = ", ".join(f"{r['loss']:.4f}" for r in ref)
            print(f"  ({key}) {label} ({steps} steps of {EPP_BATCH} x {EPP_L}, mesh {mesh}): "
                  f"losses {', '.join(f'{c:.4f}' for c in got[0]['costs'])}; one card's step "
                  f"from each gathered state: losses {ref_losses}, relative gap {gap:.2e} "
                  f"(tolerance {SP_LOSS_RTOL}), parameters at most "
                  f"{moved:.2e} of that step's movement apart (tolerance {SP_PARAM_REL}; "
                  f"largest element gap {far:.2e}; the leaf furthest apart a step {worst}); "
                  f"drop fraction a step, every rank {drops}")
            if any(x != 0.0 for dr in drops for x in dr):
                raise AssertionError(f"({key}) dispatches dropped at factor E/k: {drops}")
            b_loc = EPP_BATCH // (mesh["expert"] * mesh.get("data", 1))
            want_n, ticks = n, 1
        else:
            gap = max(abs(a - b) / max(1.0, abs(b)) for g in got
                      for a, b in zip(g["costs"], one.costs))
            moved, far = param_gap(torch.load(os.path.join(pdir, f"{key}.pt")),
                                   tree_leaves(one.state.params), one.init)
            print(f"  ({key}) {label} ({steps} steps of {EPP_BATCH} x {EPP_L}, mesh {mesh}, "
                  f"{EPP_MICROBATCHES} microbatches): losses "
                  f"{', '.join(f'{c:.4f}' for c in got[0]['costs'])} (one card "
                  f"{', '.join(f'{c:.4f}' for c in one.costs)}; relative gap {gap:.2e}, "
                  f"tolerance {SP_LOSS_RTOL}); final parameters {moved:.2e} of one card's "
                  f"movement apart (tolerance {SP_PARAM_REL}; largest element gap {far:.2e})")
            b_loc = EPP_BATCH // EPP_MICROBATCHES // mesh.get("data", 1)
            want_n, ticks = n // mesh["stage"], EPP_MICROBATCHES
        print(f"  ({key}) {label}: {ms:.2f} ms a step over {EPP_RANKS} ranks on one card "
              f"(gloo), {one_ms:.2f} ms on one card [{smi}]")
        if any(len(g["costs"]) != steps for g in got) or not gap <= SP_LOSS_RTOL:
            raise AssertionError(f"({key}) losses {[g['costs'] for g in got]}: relative gap {gap}")
        if not moved <= SP_PARAM_REL:
            raise AssertionError(f"({key}) parameters {moved} of the movement apart")
        # Each rank's schedule: under ep every layer once a step on its shard;
        # under pp its stage's layers once a microbatch (the ticks it
        # computes), the forward twice under remat.
        fused = fa.resolve_fused(None, b_loc * h, EPP_L, d)
        bwd = ("flash_bwd_fused",) if fused else ("flash_bwd_dq", "flash_bwd_dkv")
        calls = want_n * ticks * steps
        want = {k: 0 for k in EPP_KERNELS}
        want.update({"flash_fwd": calls * (2 if knobs.get("remat") else 1),
                     **{k: calls for k in bwd}})
        for r, g in zip(ranks, got):
            print(f"  | rank {r['rank']} {g['coords']}: launches {g['launches']} (the schedule: "
                  f"{want_n} layers x {ticks} ticks x {steps} steps"
                  f"{' x 2 forwards (remat)' if knobs.get('remat') else ''} = {want}), "
                  f"local w_up {g['local_w']}")
            if g["launches"] != want:
                raise AssertionError(f"({key}) rank {r['rank']}: launches {g['launches']}, "
                                     f"want {want}")
        if b_loc == EPP_LOCAL[0]:
            for k in EPP_KERNELS:
                local_launches[k] += got[0]["launches"][k]
        del one
    for rec, (base, _) in FLASH_EPP.items():
        records[rec]["launches"] = local_launches[base]
    for r in ranks:
        a2a, hop = r["timed"]["all_to_all"], r["timed"]["hop"]
        print(f"  rank {r['rank']}: one all-to-all of (a)'s dispatch buffer ({a2a['bytes']} bytes "
              f"bf16 over 'expert', through gloo): {a2a['ms']:.2f} ms; one pipeline hop of (c)'s "
              f"microbatch ({hop['bytes']} bytes f32 over 'stage', staged through the host): "
              f"{hop['ms']:.2f} ms [{smi}]")


# Phase 27 (ROADMAP A7d): the LM's async and ZeRO modes and the DiLoCo outer
# loop, 4 ranks sharing the card over gloo (--lsgd-task), gpt-s-L512-flash at
# a global batch of 32 (8 rows a rank), bf16, 4 steps a run through
# LMTrainer. SGD steps where a run is held to another (Adam's first step is
# the gradient's sign; phase 26's note); (b) and the ZeRO pair step by AdamW.
# Each rank's local attention is EPP_LOCAL's shape, where phase 26 timed B3
# and B4a: this phase records their launches only.
LSGD_RANKS = 4
LSGD_L, LSGD_BATCH, LSGD_STEPS = 512, 32, 4
LSGD_DILOCO = dict(sync_every=2, outer_lr=0.7, outer_momentum=0.9, delta_dtype="int8")
# key -> (label, TrainConfig keywords, LMTrainer keywords, optimizer)
LSGD_RUNS = {
    "a": ("async, avg_every 1, update_scale 1", dict(sync=False, async_avg_every=1),
          dict(async_update_scale=1.0), "sgd"),
    "b": ("async, avg_every 2, update_scale N", dict(sync=False, async_avg_every=2), {},
          "adamw"),
    "dp": ("dp 4 (the ZeRO run's reference)", {}, {}, "adamw"),
    "c": ("zero, dp 4", dict(dp_mode="zero"), {}, "adamw"),
    "d": ("diloco, H=2, outer_lr 0.7, mu 0.9, int8 deltas", dict(dp_mode="diloco",
                                                                 **LSGD_DILOCO), {}, "sgd"),
    "e": ("diloco as (d), overlapped", dict(dp_mode="diloco", delta_overlap=True,
                                            **LSGD_DILOCO), {}, "sgd"),
}
LSGD_PATH = "lm-train-async/zero/diloco gpt-s-L512 4 ranks"
# The residuals' norms of the two DiLoCo engines may differ by this share
# (each element is the quantizer's sawtooth, at most half a code).
LSGD_RESID_NORM = 0.1
FLASH_LSGD = {"flash_fwd[local-sgd-8x512]": ("flash_fwd", LSGD_PATH),
              "flash_bwd_fused[local-sgd-8x512]": ("flash_bwd_fused", LSGD_PATH)}


def lsgd_trainer(cfg_kw, opt, mesh=None, **trainer_kw):
    """The gpt-s-L512-flash LMTrainer of a phase-27 run (on ``mesh``, or on
    one card), each step's cost (the rank's own), ms, B3/B4 launches and the
    mesh's all-reduces recorded (the step alone: the log line's and the
    eval's collectives are not a step's)."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    model = GPTLM(**{**S_CFG, "max_len": LSGD_L}, attention_impl="flash", flash_min_len=0,
                  compute_dtype=torch.bfloat16)
    cfg = TrainConfig(epochs=1, batch_size=LSGD_BATCH, log_frequency=LSGD_STEPS, **cfg_kw)
    optimizer = optim_lib.sgd(EPP_LR) if opt == "sgd" else optim_lib.adamw(1e-3)
    tr = LMTrainer(model, sp_corpus(LSGD_L, LSGD_STEPS, LSGD_BATCH), cfg, mesh=mesh,
                   eval_batch=8, print_fn=lambda *a: None, optimizer=optimizer, **trainer_kw)
    tr.costs, tr.step_ms, tr.reduces = [], [], []
    tr.launches = {k: 0 for k in EPP_KERNELS}
    step = tr._train_step

    def timed(toks, lens):
        calls = []
        if mesh is not None:
            orig = mesh.all_reduce_
            mesh.all_reduce_ = lambda t, axes=None, op="sum": (calls.append(t.numel()),
                                                               orig(t, axes, op))[1]
        before = {k: _build.LAUNCHES.get(k, 0) for k in EPP_KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = step(toks, lens)
        tr.costs.append(float(cost))  # waits for the step
        tr.step_ms.append((time.perf_counter() - t0) * 1e3)
        if mesh is not None:
            del mesh.all_reduce_
        tr.reduces.append(calls)
        for k in EPP_KERNELS:
            tr.launches[k] += _build.LAUNCHES.get(k, 0) - before[k]
        return cost

    tr._train_step = timed
    tr.save_s = []
    if tr.supervisor is not None:  # each save's seconds at the boundary (gather + snapshot)
        save = tr._save

        def timed_save():
            t0 = time.perf_counter()
            save()
            tr.save_s.append(time.perf_counter() - t0)

        tr._save = timed_save
    return tr


def params_hash(params) -> str:
    """sha256 of a parameter tree's bytes (bit-for-bit equality across
    ranks)."""
    import hashlib

    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tree_bytes(tree) -> int:
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "element_size"))


def lsgd_task(port, argv) -> int:
    """One rank of phase 27's world (``--lsgd-task``): every run of
    LSGD_RUNS on a (4,) ("data",) mesh. (a) rank 0 keeps its copy before
    each step (every copy is the mean there) and the batch, and takes one
    card's step on the whole batch from each; (b) every rank's parameter
    hash after each step and the float64 sums of the exchange's input and
    output, rank 0 its first step against one card's on its 8 rows; (c)
    rank 0 holds the ZeRO run's gathered parameters and slots against the dp
    run's; (d), (e) rank 0 saves the gang's outer state to
    ``$DTF_LSGD_STATES``; one exchange all-reduce of the parameters timed.
    Prints ``RESULT <json>`` last."""
    import torch
    from distributed_tensorflow_tpu_torch.cluster import bootstrap_from_argv
    from distributed_tensorflow_tpu_torch.config import ClusterConfig
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from distributed_tensorflow_tpu_torch.train.local_sgd import (
        delta_payload_nbytes,
        params_nbytes,
    )

    walls = {"start": time.time() - float(os.environ["DTF_LSGD_T0"])}  # from the launch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cluster = ClusterConfig.from_lists([f"127.0.0.1:{port + i}" for i in range(LSGD_RANKS)])
    t0 = time.perf_counter()
    ctx = bootstrap_from_argv(cluster, argv)
    out_dir = os.environ["DTF_LSGD_STATES"]
    mesh = make_mesh((LSGD_RANKS,), ("data",))
    walls["join"] = time.perf_counter() - t0
    me, runs, canon = mesh.rank, {}, {}
    for key, (label, cfg_kw, tr_kw, opt) in LSGD_RUNS.items():
        t0 = time.perf_counter()
        if key == "c":  # the ZeRO run checkpoints: every rank gathers, rank 0 writes
            cfg_kw = dict(cfg_kw, checkpoint_dir=os.path.join(out_dir, "zero-ckpt"))
        tr = lsgd_trainer(cfg_kw, opt, mesh, **tr_kw)
        kept, hashes, sums = [], [], []
        step = tr._train_step

        def watched(toks, lens, tr=tr, step=step, kept=kept, hashes=hashes, sums=sums):
            if key == "a" and me == 0:
                kept.append((tree_map(torch.clone, tr.state.params), toks.clone()))
            if key == "b":
                if me == 0 and not kept:
                    kept.append((tree_map(torch.clone, tr.state.params), toks.clone()))
                orig, seen = mesh.mean_, []

                def mean_(tensors, axes=None):  # kept, summed outside the timed step
                    tensors = list(tensors)
                    res = orig(tensors, axes)
                    seen.append((tensors, res))
                    return res

                mesh.mean_ = mean_
            cost = step(toks, lens)
            if key == "b":
                del mesh.mean_
                for tensors, res in seen:
                    sums.append([float(sum(t.double().sum() for t in x)) for x in (tensors, res)]
                                + [float(sum(t.double().abs().sum() for t in tensors))])
                hashes.append(params_hash(tr.state.params))
                if me == 0 and len(kept) == 1:
                    kept.append(tree_map(torch.clone, tr.state.params))
            return cost

        tr._train_step = watched
        res = tr.run()
        torch.cuda.synchronize()
        run = dict(costs=tr.costs, step_ms=tr.step_ms, mode=tr.mode, launches=tr.launches,
                   reduces=[len(c) for c in tr.reduces], reduce_sizes=tr.reduces,
                   perplexity=res["perplexity"], hashes=hashes, sums=sums,
                   param_bytes=tree_bytes(tr.state.params),
                   slot_bytes=tree_bytes(tr.state.opt_state),
                   local_embed=list(tr.state.params.embed.shape))
        if key == "a" and me == 0:  # one card's step from each kept state
            single = make_lm_train_step(tr.model, optim_lib.sgd(EPP_LR))
            states = [p for p, _ in kept] + [tr.state.params]
            run["refs"] = []
            for i, (p, toks) in enumerate(kept):
                reached, _, loss = single(p, (), toks)
                got, want, init = ([t.float().cpu() for t in tree_leaves(x)]
                                   for x in (states[i + 1], reached, p))
                moved, far = param_gap(got, want, init)
                run["refs"].append(dict(loss=float(loss), moved=moved, far=far))
        if key == "b" and me == 0:  # one card's first step on rank 0's 8 rows
            init, toks = kept[0]
            o = tr.optimizer
            rows = toks[:LSGD_BATCH // LSGD_RANKS]
            new, _, _ = make_lm_train_step(tr.model, o)(init, o.init(init), rows)
            ref = tree_map(lambda p, q: p + (q - p) * LSGD_RANKS, init, new)
            got, want, start = ([t.float().cpu() for t in tree_leaves(x)]
                                for x in (kept[1], ref, init))
            run["first_step"] = dict(bitwise=all(torch.equal(a, b) for a, b in zip(got, want)),
                                     gap=param_gap(got, want, start))
        if key in ("dp", "c"):
            c = tr.to_canonical()  # a collective
            canon[key] = c
            if key == "c" and me == 0:  # the gang's gathered state, for the restore on one card
                torch.save({"params": [t.cpu() for t in tree_leaves(c.params)],
                            "opt": [t.cpu() for t in tree_leaves(c.opt_state)], "step": c.step,
                            "save_s": tr.save_s}, os.path.join(out_dir, "zero-canon.pt"))
            if key == "c" and me == 0:
                dp = canon["dp"]
                pairs = list(zip(tree_leaves(c.params) + tree_leaves(c.opt_state),
                                 tree_leaves(dp.params) + tree_leaves(dp.opt_state)))
                run["vs_dp"] = dict(
                    bitwise=all(torch.equal(a, b) for a, b in pairs),
                    max_abs=max((a.float() - b.float()).abs().max().item() for a, b in pairs
                                if a.is_floating_point()))
        if key in ("d", "e") and me == 0:
            d = tr.state.opt_state
            f = d.inflight
            torch.save({"theta": [t.cpu() for t in tree_leaves(d.theta)],
                        "momentum": [t.cpu() for t in tree_leaves(d.momentum)],
                        "residual": [t.cpu() for t in tree_leaves(d.residual)],
                        "delta": None if f is None else [t.cpu() for t in tree_leaves(f.delta)],
                        "landing": None if f is None else [t.cpu() for t in
                                                           tree_leaves(f.landing)]},
                       os.path.join(out_dir, f"{key}.pt"))
        runs[key] = run
        del tr
        walls[key] = time.perf_counter() - t0
    canon.clear()
    # One exchange: the mean of the ~21 MB f32 parameter set, staged through
    # the host under gloo.
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    params = tuple(tree_leaves(GPTLM(**{**S_CFG, "max_len": LSGD_L}).init(seed=1,
                                                                          device=mesh.device)))
    for _ in range(2):
        mesh.mean_(params, "data")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        mesh.mean_(params, "data")
    torch.cuda.synchronize()
    exchange = dict(ms=(time.perf_counter() - t0) / 10 * 1e3, bytes=params_nbytes(params),
                    int8_bytes=delta_payload_nbytes(params, "int8"))
    ctx.close()
    print("RESULT " + json.dumps(dict(rank=me, backend=mesh.backend, runs=runs,
                                      exchange=exchange, walls=walls)))
    return 0


def owed_gap(saved, dst, key):
    """The residual's check: what the gang still owes, with nothing rounded
    away, is continuous in the mean, so it is held by phase 24's rule
    relative to its norm, where the residual itself (the quantizer's
    sawtooth of it) is not: a code flipped where the two means' last bits
    straddle a rounding midpoint moves an element's residual by a whole
    code, and in bf16 the next round's steps then scatter every residual
    within its code. Without overlap the momentum plus the residual (μ·Δ̂₁
    + Δ₂ + r₁, the last round's delta as it was before it was rounded); with
    overlap the delta in flight plus the residual (that round's delta).
    Returns (that gap, the residuals' norm ratio)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    first = saved["momentum"] if key == "d" else saved["delta"]
    other = dst.momentum if key == "d" else dst.inflight.delta
    got = [a + r for a, r in zip(first, saved["residual"])]
    want = [a.cpu() + r.cpu() for a, r in zip(tree_leaves(other), tree_leaves(dst.residual))]
    gap, _ = param_gap(got, want, [torch.zeros_like(t) for t in want])
    norm = lambda ts: torch.cat([t.float().reshape(-1) for t in ts]).norm().item()  # noqa: E731
    return gap, norm(saved["residual"]) / norm([t.cpu() for t in tree_leaves(dst.residual)])


def lsgd_zero_restore(sdir, smi):
    """27 (ROADMAP A8a): the ZeRO run's checkpoint (every rank gathered its
    slices, rank 0 wrote the canonical state) restored into a one-card
    LMTrainer: its parameters and Adam slots equal the gang's gathered
    canonical state bit for bit, at the gang's step."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    saved = torch.load(os.path.join(sdir, "zero-canon.pt"))
    t0 = time.perf_counter()
    tr = lsgd_trainer({"checkpoint_dir": os.path.join(sdir, "zero-ckpt")}, "adamw")
    restore_s = time.perf_counter() - t0
    got_p = [t.cpu() for t in tree_leaves(tr.state.params)]
    got_o = [t.cpu() for t in tree_leaves(tr.state.opt_state)]
    same = (len(got_p) == len(saved["params"]) and len(got_o) == len(saved["opt"])
            and all(torch.equal(a, b) for a, b in zip(got_p + got_o,
                                                      saved["params"] + saved["opt"])))
    print(f"  (c) the ZeRO run's checkpoint ({tr.supervisor.saved_layout(tr.start_step)}; rank 0's "
          f"save at the boundary {', '.join(f'{x * 1e3:.1f}' for x in saved['save_s'])} ms, the "
          f"gather included) restored into one card's LMTrainer (mode {tr.mode!r}) at step "
          f"{tr.start_step}: parameters and Adam slots against the gang's gathered canonical "
          f"state bit for bit: {same} (trainer with its restore {restore_s:.2f} s) [{smi}]")
    if not same or tr.start_step != saved["step"] or tr.mode != "single":
        raise AssertionError(f"27(c) the ZeRO checkpoint on one card: {same}, step "
                             f"{tr.start_step} against {saved['step']}")


# Phase 27's per-rank journals: the communication accounting a rank's
# LMTrainer journals for dp and DiLoCo (phase 27's exchange figures:
# 21,534,720 bytes a dense parameter set, 5,383,744 an int8 delta).
LSGD_DENSE_BYTES, LSGD_INT8_BYTES = 21_534_720, 5_383_744


def lsgd_journals(jdir):
    """27: each rank's journal (``DTF_JOURNAL_DIR``, armed by
    ``cluster.bootstrap``) holds the dp run's ``comm_stats`` (a round a
    step, a dense parameter set a round) and the DiLoCo runs' (H=2: 2
    rounds over 4 steps, an int8 delta's payload a round), the figures
    ``local_sgd.params_nbytes`` / ``delta_payload_nbytes`` give for the
    model; the four journals merge into one timeline whose chrome trace
    has a lane a rank."""
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.observability import aggregate
    from distributed_tensorflow_tpu_torch.train.local_sgd import (
        delta_payload_nbytes,
        params_nbytes,
    )

    shapes = GPTLM(**{**S_CFG, "max_len": LSGD_L}).init(seed=0, device="meta")
    dense, int8 = params_nbytes(shapes), delta_payload_nbytes(shapes, "int8")
    if (dense, int8) != (LSGD_DENSE_BYTES, LSGD_INT8_BYTES):
        print(f"  the model's own byte counts ({dense} dense, {int8} int8) differ from the "
              f"recorded ({LSGD_DENSE_BYTES}, {LSGD_INT8_BYTES}); the code's decide")
    want = {"dp": (LSGD_STEPS, LSGD_STEPS * dense, LSGD_STEPS * dense),
            "d": (LSGD_STEPS // 2, LSGD_STEPS // 2 * dense, LSGD_STEPS // 2 * int8),
            "e": (LSGD_STEPS // 2, LSGD_STEPS // 2 * dense, LSGD_STEPS // 2 * int8)}
    for r in range(LSGD_RANKS):
        evs = obs.read_events(obs.rank_journal_path(jdir, r))
        comm = [e for e in evs if e["kind"] == "comm_stats"]
        got = {("dp" if c["mode"] == "dp" else "e" if c["overlap"] else "d"):
               (c["sync_rounds"], c["allreduce_bytes"], c["payload_bytes"]) for c in comm}
        ok = (got == want and len(comm) == 3 and all(c["workers"] == LSGD_RANKS for c in comm)
              and all(e.get("rank") == r for e in evs) and evs[0]["kind"] == "worker_start")
        print(f"  rank {r}'s journal: {len(evs)} events; comm_stats (rounds, all-reduce bytes, "
              f"payload bytes) {got}")
        if not ok:
            raise AssertionError(f"27: rank {r}'s comm_stats {comm}, want {want}")
    merged = aggregate.merge(jdir)
    trace = aggregate.gang_chrome_trace(merged)
    path = os.path.join(dp_logdir("lsgd"), "gang-trace.json")
    with open(path, "w") as f:
        json.dump(trace, f)
    with open(path) as f:
        lanes = [e["args"]["name"] for e in json.load(f)["traceEvents"] if e["ph"] == "M"]
    spans = sum(e["ph"] == "X" for e in trace["traceEvents"])
    print(f"  merged: {len(merged['events'])} events, lanes {lanes}, skew {merged['skew_s']}; "
          f"the gang's chrome trace ({len(trace['traceEvents'])} events, {spans} spans) in "
          f"{os.path.relpath(path)}")
    if lanes != [f"rank{r}" for r in range(LSGD_RANKS)]:
        raise AssertionError(f"27: merged trace lanes {lanes}")


def phase_lsgd(records, smi):
    """27: LSGD_RANKS ranks sharing the card (gloo, every collective staged
    through the host) run LSGD_RUNS through LMTrainer: (a) each step held to
    one card's step on the whole batch from the same state (SP_LOSS_RTOL on
    the loss, SP_PARAM_REL on that step's movement); (b) the copies differ
    after steps 1 and 3, every rank holds the mean bit for bit after steps 2
    and 4, exactly 2 parameter all-reduces, rank 0's first step bit for bit
    one card's on its 8 rows; (c) ZeRO against dp on the same ranks and
    batches, bit for bit, with each rank's parameter and slot bytes; (d), (e)
    the mesh gang against the one-device gang on the card with the same
    batches: θ and momentum by SP_PARAM_REL, the residual through what the
    gang owes (``owed_gap``).
    Every rank's B3/B4 launches against the schedule (4 layers a step on its
    8 rows), ms a step beside one card's dp step, one exchange's ms and the
    payload bytes, dense and int8."""
    import socket
    import tempfile

    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    sdir = tempfile.mkdtemp(prefix="lsgd-states-")
    jdir = tempfile.mkdtemp(prefix="lsgd-journals-")  # each rank's journal (cluster.bootstrap)
    me = [sys.executable, os.path.abspath(__file__)]
    logs = dp_launch("lsgd", me + ["--lsgd-task", "--dp-port", str(port)], LSGD_RANKS, 0,
                     env={"DTF_LSGD_STATES": sdir, "DTF_LSGD_T0": repr(time.time()),
                          "DTF_JOURNAL_DIR": jdir})
    ranks = sorted((dp_result(logs[f"worker{r}"]) for r in range(LSGD_RANKS)),
                   key=lambda r: r["rank"])
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"{LSGD_RANKS} ranks on one card took {[r['backend'] for r in ranks]}")
    one = lsgd_trainer({}, "adamw")  # one card's dp step: the whole batch
    one.run()
    torch.cuda.synchronize()
    one_ms = float(np.median(one.step_ms[1:]))
    del one
    n, h, d = S_CFG["num_layers"], S_CFG["num_heads"], S_CFG["model_dim"] // S_CFG["num_heads"]
    b_loc = LSGD_BATCH // LSGD_RANKS
    bwd = ("flash_bwd_fused",) if fa.resolve_fused(None, b_loc * h, LSGD_L, d) else (
        "flash_bwd_dq", "flash_bwd_dkv")
    want = {k: 0 for k in EPP_KERNELS}
    want.update({"flash_fwd": n * LSGD_STEPS, **{k: n * LSGD_STEPS for k in bwd}})
    total = {k: 0 for k in EPP_KERNELS}
    for key, (label, cfg_kw, _, opt) in LSGD_RUNS.items():
        got = [r["runs"][key] for r in ranks]
        g0 = got[0]
        ms = float(np.median(g0["step_ms"][1:]))
        mean_costs = [float(np.mean(c)) for c in zip(*(g["costs"] for g in got))]
        head = (f"  ({key}) {label} ({LSGD_STEPS} steps of {LSGD_BATCH} x {LSGD_L}, {opt}, "
                f"mode {g0['mode']}): costs, the mean over the ranks, "
                f"{', '.join(f'{c:.4f}' for c in mean_costs)}")
        if any(len(g["costs"]) != LSGD_STEPS or not np.all(np.isfinite(g["costs"]))
               for g in got):
            raise AssertionError(f"({key}) costs {[g['costs'] for g in got]}")
        if key == "a":
            refs = g0["refs"]
            gap = max(abs(c - r["loss"]) / max(1.0, abs(r["loss"]))
                      for c, r in zip(mean_costs, refs))
            moved = max(r["moved"] for r in refs)
            print(f"{head}; one card's step from each state: losses "
                  f"{', '.join(f'{r['loss']:.4f}' for r in refs)}, relative gap {gap:.2e} "
                  f"(tolerance {SP_LOSS_RTOL}), parameters at most {moved:.2e} of that step's "
                  f"movement apart (tolerance {SP_PARAM_REL}; largest element gap "
                  f"{max(r['far'] for r in refs):.2e})")
            if not (gap <= SP_LOSS_RTOL and moved <= SP_PARAM_REL):
                raise AssertionError(f"(a) async avg_every=1 parts from one card's step: "
                                     f"loss gap {gap}, parameters {moved}")
        if key == "b":
            same = [len({g["hashes"][i] for g in got}) == 1 for i in range(LSGD_STEPS)]
            # Σ of the exchange's output against the mean of the ranks' Σ of
            # its input, in f64: within 1e-6 of Σ|input| (an f32 mean's
            # rounding is ~6e-8 of an element).
            mean_ok = all(abs(np.mean([g["sums"][j][0] for g in got]) - g0["sums"][j][1])
                          <= 1e-6 * np.mean([g["sums"][j][2] for g in got])
                          for j in range(len(g0["sums"])))
            fs = g0["first_step"]
            print(f"{head}; every rank's copy the same after steps 1-4: {same} (the exchange "
                  f"after steps 2 and 4, its output the mean of the inputs: {mean_ok}); "
                  f"parameter all-reduces a step {g0['reduces']}; rank 0's first step against "
                  f"one card's on its {b_loc} rows: bit for bit {fs['bitwise']} (gap "
                  f"{fs['gap'][0]:.2e} of the step)")
            if same != [False, True, False, True] or not mean_ok or not fs["bitwise"]:
                raise AssertionError(f"(b) copies {same}, mean {mean_ok}, first step {fs}")
            if any(g["reduces"] != [0, 1, 0, 1] or len(g["sums"]) != 2 for g in got):
                raise AssertionError(f"(b) all-reduces {[g['reduces'] for g in got]}")
        if key == "c":
            vs = g0["vs_dp"]
            dp = ranks[0]["runs"]["dp"]
            print(f"{head}; against dp on the same ranks and batches: parameters and slots "
                  f"bit for bit {vs['bitwise']} (max abs gap {vs['max_abs']:.3e}); a rank "
                  f"holds {g0['param_bytes']} parameter and {g0['slot_bytes']} slot bytes "
                  f"(dp {dp['param_bytes']} and {dp['slot_bytes']}), embed {g0['local_embed']}; "
                  f"all-reduces a step {g0['reduces']} (dp {dp['reduces']})")
            if not vs["bitwise"] or not g0["param_bytes"] * LSGD_RANKS <= dp["param_bytes"] * 1.01:
                raise AssertionError(f"(c) zero against dp: {vs}, bytes {g0['param_bytes']}")
        if key in ("d", "e"):
            # The one-device gang on the card, the same batches.
            ref = lsgd_trainer(dict(cfg_kw, diloco_workers=LSGD_RANKS), opt)
            start = [t.cpu() for t in tree_leaves(ref.state.opt_state.theta)]
            ref.run()
            torch.cuda.synchronize()
            saved = torch.load(os.path.join(sdir, f"{key}.pt"))
            dst = ref.state.opt_state
            init = [torch.zeros_like(t) for t in start]
            t_moved, t_far = param_gap(saved["theta"], tree_leaves(dst.theta), start)
            m_moved, _ = param_gap(saved["momentum"], tree_leaves(dst.momentum), init)
            owed, ratio = owed_gap(saved, dst, key)
            ref_costs = ref.costs
            print(f"{head}; the one-device gang on the card ({LSGD_RANKS} workers, the same "
                  f"batches, costs {', '.join(f'{c:.4f}' for c in ref_costs)}): θ "
                  f"{t_moved:.2e} of its movement apart (largest element gap {t_far:.2e}), "
                  f"momentum {m_moved:.2e} of its norm apart, {'momentum' if key == 'd' else 'delta in flight'} "
                  f"plus residual {owed:.2e} of its norm apart (tolerance {SP_PARAM_REL}); the "
                  f"residuals' norms {ratio:.4f} of each other (limit 1 ± {LSGD_RESID_NORM}); "
                  f"all-reduces a step {g0['reduces']}")
            if saved["landing"] is not None:
                l_moved, _ = param_gap(saved["landing"], tree_leaves(dst.inflight.landing),
                                       start)
                print(f"  ({key}) in-flight landing {l_moved:.2e} of its movement apart")
                if not l_moved <= SP_PARAM_REL:
                    raise AssertionError(f"({key}) landing {l_moved}")
            if not (t_moved <= SP_PARAM_REL and m_moved <= SP_PARAM_REL and owed <= SP_PARAM_REL
                    and abs(ratio - 1) <= LSGD_RESID_NORM):
                raise AssertionError(f"({key}) mesh gang against the one-device gang: θ "
                                     f"{t_moved}, momentum {m_moved}, owed {owed}, residual "
                                     f"norms {ratio}")
            if any(g["reduces"] != [0, 1, 0, 1] for g in got):
                raise AssertionError(f"({key}) all-reduces {[g['reduces'] for g in got]}")
            del ref
        print(f"  ({key}) {ms:.2f} ms a step over {LSGD_RANKS} ranks on one card (gloo), one "
              f"card's dp step {one_ms:.2f} ms [{smi}]")
        for r, g in zip(ranks, got):
            if g["launches"] != want:
                raise AssertionError(f"({key}) rank {r['rank']}: launches {g['launches']}, "
                                     f"want {want}")
        print(f"  ({key}) every rank's launches {g0['launches']} = the schedule ({n} layers x "
              f"{LSGD_STEPS} steps on its {b_loc} rows)")
        if key != "dp":
            for k in EPP_KERNELS:
                total[k] += g0["launches"][k]
    for rec, (base, _) in FLASH_LSGD.items():
        records[rec] = dict(records[rec.replace("local-sgd", "ep-pp")], launches=total[base])
    lsgd_zero_restore(sdir, smi)
    lsgd_journals(jdir)
    w = ranks[0]["walls"]
    print("  rank 0's seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in w.items())
          + " (start: the launch to the task's first line; join: the group and the mesh; "
            "a run: its trainer, steps, eval and checks)")
    for r in ranks:
        x = r["exchange"]
        print(f"  rank {r['rank']}: one exchange all-reduce of the f32 parameters "
              f"({x['bytes']} bytes, staged through the host under gloo): {x['ms']:.2f} ms; a "
              f"delta's payload {x['bytes']} bytes dense, {x['int8_bytes']} int8 [{smi}]")


# Phase 28 (ROADMAP A8b): the telemetry on the card. (a) The MNIST MLP
# through launch.run (784->100->10, batch 100, OBS_MLP_EPOCHS epochs on the
# fused path: compiled_run on engine="pallas", one B2 launch an epoch) with
# DTF_LOGS and DTF_JOURNAL_DIR set, against the same run with neither.
# (b) gpt-m-L1024-flash (phase 12(a)'s model and chain) through LMTrainer
# with a journal, a metrics registry, a summary writer and profile_dir,
# OBS_STEPS steps an epoch, run() then run_compiled() over OBS_EPOCHS epochs
# each, against the same runs with none.
OBS_MLP_EPOCHS = 2
OBS_EPOCHS, OBS_STEPS = 2, 4
OBS_CORPUS = dict(TRAIN_CORPUS, num=OBS_STEPS * TRAIN_CFG["batch_size"] + 64, n_val=32,
                  n_test=32)
OBS_PATH = "lm-train-telemetry gpt-m-L1024 (journal, metrics, tfevents, profile)"
FLASH_OBS = {"flash_fwd[obs-gpt-m]": ("flash_fwd", OBS_PATH),
             "flash_bwd_fused[obs-gpt-m]": ("flash_bwd_fused", OBS_PATH)}
MLP_OBS = {"fused_mlp_epoch[obs-mlp]": ("fused_mlp_epoch", "mlp-train launch.run telemetry")}
# The device kernels each flash wrapper launches (names in the profile) for
# each count of ops/_build.LAUNCHES.
OBS_KERNELS = {"flash_fwd_kernel": ("flash_fwd",),
               "kv_kernel": ("flash_bwd_fused", "flash_bwd_dkv"),
               "dq_reduce_kernel": ("flash_bwd_fused",)}


def tfevents(path):
    """The records of a tfevents file, each masked CRC checked (raises on
    a bad one), decoded to (kind, tag or None, step)."""
    import struct

    from distributed_tensorflow_tpu_torch.utils.summary import _masked_crc

    def varint(b, i):
        out = shift = 0
        while True:
            out |= (b[i] & 0x7F) << shift
            shift += 7
            i += 1
            if not b[i - 1] & 0x80:
                return out, i

    def fields(b):
        i, out = 0, {}
        while i < len(b):
            key, i = varint(b, i)
            wire = key & 7
            if wire == 0:
                v, i = varint(b, i)
            elif wire == 1:
                v, i = b[i:i + 8], i + 8
            elif wire == 5:
                v, i = b[i:i + 4], i + 4
            else:
                n, i = varint(b, i)
                v, i = b[i:i + n], i + n
            out[key >> 3] = v
        return out

    out = []
    with open(path, "rb") as f:
        blob = f.read()
    i = 0
    while i < len(blob):
        header = blob[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", blob[i + 8:i + 12])
        data = blob[i + 12:i + 12 + n]
        (dcrc,) = struct.unpack("<I", blob[i + 12 + n:i + 16 + n])
        if hcrc != _masked_crc(header) or dcrc != _masked_crc(data):
            raise AssertionError(f"{path}: a record at byte {i} fails its masked CRC")
        i += 16 + n
        ev = fields(data)
        if 3 in ev:
            out.append(("version", None, None))
        elif 4 in ev:
            out.append(("graph", ev[4], None))
        elif 5 in ev:
            value = fields(fields(ev[5])[1])
            out.append(("scalar", value[1].decode(), ev.get(2, 0),
                        struct.unpack("<f", value[2])[0]))
    return out


def obs_mlp(records, ds):
    """28(a): launch.run with DTF_LOGS and DTF_JOURNAL_DIR, against a run
    with neither. Returns the seconds it took."""
    import tempfile

    import torch
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import run
    from distributed_tensorflow_tpu_torch.observability import format as obs_format
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="obs-mlp-")
    cfg = TrainConfig(epochs=OBS_MLP_EPOCHS, compiled_run=True, engine="pallas")
    orig = trainer_mod.Trainer._emit_step_logs
    out = {}
    for on in (True, False):
        saved = {k: os.environ.get(k) for k in ("DTF_LOGS", "DTF_JOURNAL_DIR")}
        os.environ["DTF_LOGS"] = os.path.join(root, "tb") if on else ""
        if on:
            os.environ["DTF_JOURNAL_DIR"] = os.path.join(root, "journal")
        else:
            os.environ.pop("DTF_JOURNAL_DIR", None)
        costs, lines = [], []

        def emit(self, c, *a, **kw):  # every fetched cost, full precision
            costs.append(np.array(c, copy=True))
            return orig(self, c, *a, **kw)

        trainer_mod.Trainer._emit_step_logs = emit
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            res = run(config=cfg, argv=[], datasets=ds, print_fn=lines.append)
            torch.cuda.synchronize()
        finally:
            trainer_mod.Trainer._emit_step_logs = orig
            obs.configure()  # closes the journal bootstrap armed
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        out[on] = (res, np.concatenate(costs), lines, launches, time.perf_counter() - t0)
    (res, costs, lines, launches, wall), (res0, costs0, lines0, launches0, wall0) = (
        out[True], out[False])
    if launches != {"fused_mlp_epoch": OBS_MLP_EPOCHS} or launches0 != launches:
        raise AssertionError(f"28(a) launches {launches} (without telemetry {launches0})")
    records["fused_mlp_epoch[obs-mlp]"] = dict(records["fused_mlp_epoch"],
                                               launches=launches["fused_mlp_epoch"])
    bitwise = costs.shape == costs0.shape and np.array_equal(costs, costs0) and res == res0
    print(f"  (a) launch.run, {OBS_MLP_EPOCHS} epochs of {costs.size // OBS_MLP_EPOCHS} steps on "
          f"the fused path ({launches}): {wall:.2f} s with DTF_LOGS and DTF_JOURNAL_DIR, "
          f"{wall0:.2f} s without; the {costs.size} costs bit for bit: {bitwise} (final cost "
          f"{res['final_cost']!r}, accuracy {res['accuracy']!r})")
    if not bitwise:
        raise AssertionError(f"28(a) telemetry changed the run: {res} against {res0}")
    (tb,) = [os.path.join(root, "tb", f) for f in os.listdir(os.path.join(root, "tb"))]
    recs = tfevents(tb)
    graphs = [r for r in recs if r[0] == "graph"]
    cost_tags = [r for r in recs if r[0] == "scalar" and r[1] == "cost"]
    accs = [r for r in recs if r[0] == "scalar" and r[1] == "accuracy"]
    logged = [ln for ln in lines if ln.startswith("Step:")]
    printed = [float(re.search(r"Cost: ([0-9.]+)", ln).group(1)) for ln in logged]
    if (recs[0][0] != "version" or len(graphs) != 1 or b"mlp_epoch_kernel" not in graphs[0][1]
            or len(cost_tags) != len(logged) or len(accs) != OBS_MLP_EPOCHS
            or [round(r[3], 4) for r in cost_tags] != printed):
        raise AssertionError(f"28(a) tfevents: {len(recs)} records, {len(graphs)} graphs, "
                             f"{len(cost_tags)} costs against {len(logged)} step lines, "
                             f"{len(accs)} accuracies")
    print(f"  (a) tfevents {os.path.basename(tb)}: {len(recs)} records, every masked CRC valid; "
          f"1 graph event (the epoch kernel's node), {len(cost_tags)} cost scalars (one a "
          f"logged step, equal to the printed costs), {len(accs)} accuracy scalars")
    jpath = obs.rank_journal_path(os.path.join(root, "journal"), 0)
    evs = obs.read_events(jpath)
    kinds = [e["kind"] for e in evs]
    shown = [ln for e in evs if e["kind"] in ("step", "epoch", "final")
             for ln in obs_format.render(e["kind"], e)]
    if (not {"worker_start", "step", "epoch", "final", "metrics"} <= set(kinds)
            or shown != lines):
        raise AssertionError(f"28(a) journal: kinds {sorted(set(kinds))}; lines equal to the "
                             f"events' renderings: {shown == lines}")
    counts = {k: kinds.count(k) for k in dict.fromkeys(kinds)}
    print(f"  (a) journal {os.path.basename(jpath)}: {counts}; each of the {len(lines)} "
          f"printed lines is its event's rendering")
    return time.perf_counter() - t_phase


def obs_trainer(on, root):
    """28(b)'s gpt-m LMTrainer, with every sink when ``on``; each step's
    cost tensor kept (fetched once at the end), each epoch of run() timed
    and its flash launches counted."""
    import torch
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

    sinks = {}
    cfg = dict(TRAIN_CFG, epochs=OBS_EPOCHS, log_frequency=2)
    if on:
        sinks = dict(journal=obs.EventJournal.in_dir(os.path.join(root, "journal")),
                     metrics=obs.MetricsRegistry(),
                     summary_writer=SummaryWriter(os.path.join(root, "tb")))
        cfg["profile_dir"] = os.path.join(root, "profile")
    lines = []
    tr = LMTrainer(GPTLM(**SERVE_CFG, compute_dtype=torch.bfloat16), markov_corpus(**OBS_CORPUS),
                   TrainConfig(**cfg), eval_batch=TRAIN_EVAL_BATCH, print_fn=lines.append, **sinks)
    tr.sinks, tr.lines, tr.costs, tr.epochs = sinks, lines, [], []
    step, run_epoch = tr._train_step, tr.run_epoch

    def kept(toks, lens):
        cost = step(toks, lens)
        tr.costs.append(cost.detach())
        return cost

    def timed(epoch, logger):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        run_epoch(epoch, logger)  # ends in a fetch of the last cost
        tr.epochs.append((time.perf_counter() - t0,
                          {k: _build.LAUNCHES[k] - before[k] for k in before}))

    tr._train_step, tr.run_epoch = kept, timed
    return tr


def obs_lm(records, smi):
    """28(b): gpt-m through LMTrainer with a journal, metrics, tfevents and
    a profile of epoch 0, against the same runs with none. Returns the
    seconds it took."""
    import tempfile

    import torch
    from distributed_tensorflow_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="obs-lm-")
    out = {}
    for on in (False, True):
        tr = obs_trainer(on, root)
        _build.reset_launches()
        t0 = time.perf_counter()
        a = tr.run()
        t1 = time.perf_counter()
        b = tr.run_compiled(OBS_EPOCHS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        out[on] = dict(tr=tr, res=(a, b), launches=launches, run_s=t1 - t0, compiled_s=t2 - t1,
                       costs=torch.stack(tr.costs).float().cpu(), hash=params_hash(tr.state.params))
    on, off = out[True], out[False]
    tr, steps = on["tr"], OBS_STEPS
    n = SERVE_CFG["num_layers"]
    bitwise = (torch.equal(on["costs"], off["costs"]) and on["res"] == off["res"]
               and on["hash"] == off["hash"])
    print(f"  (b) gpt-m-L1024-flash, {steps} steps an epoch: run() {OBS_EPOCHS} epochs then "
          f"run_compiled() {OBS_EPOCHS}; the {on['costs'].numel()} step losses, results and "
          f"parameters with telemetry equal those without, bit for bit: {bitwise} (last loss "
          f"{float(on['costs'][-1])!r})")
    if not bitwise:
        raise AssertionError(f"28(b) telemetry changed the run: {on['res']} against {off['res']}")
    if on["launches"] != off["launches"]:
        raise AssertionError(f"28(b) launches with telemetry {on['launches']}, without "
                             f"{off['launches']}: the graph trace launched a kernel")
    for name, (base, _) in FLASH_OBS.items():
        src = records["flash_fwd"]["train_shape"] if base == "flash_fwd" else records[base]
        extra = dict(library_ms=src["sdpa_ms"]) if base == "flash_fwd" else {}
        records[name] = dict(src, launches=on["launches"].get(base, 0), **extra)
    ms = {k: [1e3 * s / steps for s, _ in out[k]["tr"].epochs] for k in (True, False)}
    cms = {k: 1e3 * out[k]["compiled_s"] / (OBS_EPOCHS * steps) for k in (True, False)}
    print(f"  (b) ms a step, telemetry on / off: run() epoch 1 (profiled on) {ms[True][0]:.2f} / "
          f"{ms[False][0]:.2f}, epoch 2 {ms[True][1]:.2f} / {ms[False][1]:.2f}; run_compiled() "
          f"{cms[True]:.2f} / {cms[False]:.2f}; run() {on['run_s']:.2f} s / {off['run_s']:.2f} s "
          f"with the graph trace and the profile export [{smi}]")
    # The profile of epoch 0 against the wrappers' counts over that epoch.
    pdir = tr.config.profile_dir
    (pfile,) = os.listdir(pdir)
    with open(os.path.join(pdir, pfile)) as f:
        pev = json.load(f)["traceEvents"]
    from distributed_tensorflow_tpu_torch.utils.profiler import LEAD_IN

    kernels = sorted((e for e in pev if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    lead = [e for e in kernels if "spin_kernel" in e.get("name", "")]
    names = [e.get("name", "") for e in kernels if e not in lead]
    seen = {k: sum(k in nm for nm in names) for k in OBS_KERNELS}
    delta = tr.epochs[0][1]
    want = {k: sum(delta[w] for w in ws) for k, ws in OBS_KERNELS.items()}
    print(f"  (b) profile of epoch 0 ({pfile}, {len(pev)} events, {len(names)} device kernels "
          f"of the epoch, the first {names[0][:48]!r}; {len(lead)} of the window's {LEAD_IN} "
          f"lead-in launches): by name {seen}, the wrappers' counts over the epoch {want}")
    if seen != want or want["flash_fwd_kernel"] != n * steps:
        raise AssertionError(f"28(b) the profile's kernels {seen} against LAUNCHES {want}")
    snap = tr.sinks["metrics"].snapshot()
    hist, epochs_total = snap["step_time_ms"][0], snap["epochs_total"][0]["value"]
    if hist["count"] != OBS_EPOCHS + 1 or epochs_total != OBS_EPOCHS:
        raise AssertionError(f"28(b) step_time_ms count {hist['count']}, epochs_total "
                             f"{epochs_total}")
    spans_path = os.path.join(root, "spans.json")
    tr.spans.export_chrome_trace(spans_path)
    with open(spans_path) as f:
        spans = [e["name"] for e in json.load(f)["traceEvents"]]
    tr.sinks["journal"].close()
    tr.sinks["summary_writer"].close()
    from distributed_tensorflow_tpu_torch import observability as obs

    kinds = [e["kind"] for e in obs.read_events(os.path.join(root, "journal"))]
    (tb,) = [os.path.join(root, "tb", f) for f in os.listdir(os.path.join(root, "tb"))]
    recs = tfevents(tb)
    graph = [r[1] for r in recs if r[0] == "graph"]
    tags = [r[1] for r in recs if r[0] == "scalar"]
    op = b"dtf.FlashAttention"  # a NodeDef's op field: key 0x12, length, the name
    fwd_nodes = graph[0].count(b"\x12" + bytes([len(op)]) + op) if graph else 0
    print(f"  (b) step_time_ms: {hist['count']} observations (2 epochs of run(), 1 compiled "
          f"run), epochs_total {epochs_total}; spans {spans} (chrome trace loads); journal "
          f"kinds {dict((k, kinds.count(k)) for k in dict.fromkeys(kinds))}; tfevents "
          f"{len(graph)} graph ({len(graph[0]) if graph else 0} bytes, {fwd_nodes} flash "
          f"forward nodes), {tags.count('cost')} cost and {tags.count('perplexity')} "
          f"perplexity scalars")
    if (spans != ["torch_profiler_trace", "lm_compiled_run"] or len(graph) != 1 or fwd_nodes != n
            or tags.count("perplexity") != 2 * OBS_EPOCHS
            or not {"step", "epoch", "final", "metrics", "span"} <= set(kinds)):
        raise AssertionError(f"28(b) spans {spans}, graphs {len(graph)} ({fwd_nodes} flash "
                             f"nodes), tags {sorted(set(tags))}, kinds {sorted(set(kinds))}")
    return time.perf_counter() - t_phase


def phase_obs(records, ds, smi):
    """28: the telemetry on the card (the MLP through launch.run, gpt-m
    through LMTrainer); each part's seconds."""
    a = obs_mlp(records, ds)
    b = obs_lm(records, smi)
    print(f"  phase 28: (a) {a:.1f} s, (b) {b:.1f} s")


# Phase 29 (ROADMAP A8a): checkpoints and recovery on the card. (a) gpt-m-
# L1024-flash (28(b)'s model and corpus, CKPT_STEPS steps an epoch, AdamW)
# through LMTrainer with checkpoint_dir and async saves: 2 epochs straight
# against 1 + a restoring trainer + 1, bit for bit; one state saved sync and
# async; a byte flipped in step 8's file; the chunked tier against one
# run_compiled(2). (b) the MLP on the fused path (B2): launch.run in a
# process of its own SIGTERMed after its first save, resumed here and held to
# an uninterrupted run, and one NaN rollback. (c) the DiLoCo mailbox gang: two
# gpt-s-L512 members one after the other on one DeltaExchange, and a torn post.
CKPT_EPOCHS, CKPT_STEPS = 2, 4
CKPT_PATH = "lm-train-checkpoint gpt-m-L1024 (save, restore, resume, chunked)"
FLASH_CKPT = {"flash_fwd[ckpt-gpt-m]": ("flash_fwd", CKPT_PATH),
              "flash_bwd_fused[ckpt-gpt-m]": ("flash_bwd_fused", CKPT_PATH)}
MLP_CKPT = {"fused_mlp_epoch[ckpt-mlp]": ("fused_mlp_epoch",
                                          "mlp-train launch.run resumed from a preempted run")}
# The preempted MLP run: epochs of one dispatch each on the fused path
# (epochs_per_dispatch=1: each dispatch's shuffle seeded by its first step,
# so a resume draws what the uninterrupted run draws), at most 2 kept steps.
CKPT_MLP_EPOCHS = 40


def ckpt_lm_trainer(ckpt=None, journal=None, **kw):
    """29(a)'s gpt-m LMTrainer (AdamW, async saves into ``ckpt``), each
    step's cost tensor kept."""
    import torch
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import markov_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    cfg = dict(TRAIN_CFG, epochs=CKPT_EPOCHS, log_frequency=2, optimizer="adamw", logs_path="",
               checkpoint_dir=ckpt, async_checkpoint=True, **kw)
    tr = LMTrainer(GPTLM(**SERVE_CFG, compute_dtype=torch.bfloat16), markov_corpus(**OBS_CORPUS),
                   TrainConfig(**cfg), eval_batch=TRAIN_EVAL_BATCH, print_fn=lambda *a: None,
                   journal=journal)
    tr.costs, step = [], tr._train_step

    def kept(toks, lens):
        cost = step(toks, lens)
        tr.costs.append(cost.detach())
        return cost

    tr._train_step = kept
    return tr


def same_tree(a, b) -> bool:
    """Every leaf of two trees equal bit for bit (host ints equal)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def ckpt_lm(records, smi):
    """29(a): resume, sync against async, the fallback past a flipped
    byte, the chunked tier; the state's bytes, the save boundary's stall,
    the CRC's rate and a restore's ms. Returns the seconds it took."""
    import shutil
    import tempfile
    import warnings

    import torch
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.runtime import native
    from distributed_tensorflow_tpu_torch.train import resilience
    from distributed_tensorflow_tpu_torch.train.supervisor import (
        Supervisor,
        checkpoint_steps,
        flatten_state,
    )

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt-lm-")
    d = {k: os.path.join(root, k) for k in ("a", "b", "c", "sync", "async")}
    steps = CKPT_STEPS
    # The straight run: 2 epochs, an async save an epoch (each save's stall
    # timed at the boundary).
    a = ckpt_lm_trainer(d["a"])
    stalls, save = [], a._save

    def timed_save():
        t0 = time.perf_counter()
        save()
        stalls.append((time.perf_counter() - t0) * 1e3)

    a._save = timed_save
    _build.reset_launches()
    res_a = a.run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    n = SERVE_CFG["num_layers"]
    evals = -(-OBS_CORPUS["n_val"] // TRAIN_EVAL_BATCH)  # each epoch's held-out chunks
    want = {"flash_fwd": n * CKPT_EPOCHS * (steps + evals),
            "flash_bwd_fused": n * CKPT_EPOCHS * steps}
    if launches != want:
        raise AssertionError(f"29(a) launches {launches}, want {want}")
    for name, (base, _) in FLASH_CKPT.items():
        src = records["flash_fwd"]["train_shape"] if base == "flash_fwd" else records[base]
        extra = dict(library_ms=src["sdpa_ms"]) if base == "flash_fwd" else {}
        records[name] = dict(src, launches=launches[base], **extra)
    if checkpoint_steps(d["a"]) != [steps, 2 * steps]:
        raise AssertionError(f"29(a) saved steps {checkpoint_steps(d['a'])}")
    # The split run: 1 epoch, a new trainer restoring step 4, 1 epoch.
    b1 = ckpt_lm_trainer(d["b"])
    b1.run(epochs=1)
    b2 = ckpt_lm_trainer(d["b"])
    if b2.start_step != steps:
        raise AssertionError(f"29(a) the second trainer restored step {b2.start_step}")
    b2.run(epochs=1)
    torch.cuda.synchronize()
    costs_a, costs_b = torch.stack(a.costs), torch.stack(b1.costs + b2.costs)
    resume = (torch.equal(costs_a, costs_b) and same_tree(a.state.params, b2.state.params)
              and same_tree(a.state.opt_state, b2.state.opt_state))
    print(f"  (a) gpt-m-L1024-flash, AdamW, {steps} steps an epoch, async saves: 2 epochs straight "
          f"(launches {launches}) against 1 epoch + a new trainer restoring step {steps} + 1 "
          f"epoch: the {costs_a.numel()} losses, the parameters and the Adam slots bit for bit: "
          f"{resume} (last loss {float(costs_a[-1])!r})")
    if not resume:
        raise AssertionError("29(a) the resumed run parts from the straight one")
    # One state saved sync and async: leaf and file records.
    disk = a._disk_state()
    flat = flatten_state(disk)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    t0 = time.perf_counter()
    resilience.leaf_checksums(flat)
    crc_s = time.perf_counter() - t0
    sups = {k: Supervisor(checkpoint_dir=d[k], async_checkpoint=k == "async")
            for k in ("sync", "async")}
    stall = {}
    for k, sup in sups.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sup.save(disk, a.global_step, layout=a._layout_meta())
        stall[k] = (time.perf_counter() - t0) * 1e3
        sup.wait_pending()
    m = {k: resilience.load_manifest(d[k], a.global_step) for k in sups}
    leaves_eq = m["sync"]["leaves"] == m["async"]["leaves"]
    files_eq = m["sync"]["files"] == m["async"]["files"]
    print(f"  (a) the state: {len(flat)} leaves, {nbytes} bytes; saved sync and async: leaf CRCs "
          f"equal {leaves_eq}, file CRCs equal {files_eq} ({m['sync']['files']['state.pt']['size']}"
          f" bytes on disk); the save's stall {stall['async']:.2f} ms async against "
          f"{stall['sync']:.2f} ms sync, in the run's boundaries "
          f"{', '.join(f'{x:.2f}' for x in stalls)} ms (async); CRC backend "
          f"{native.backend()!r}, {nbytes / crc_s / 1e6:.1f} MB/s over the state [{smi}]")
    if not (leaves_eq and files_eq) or native.backend() != "native":
        raise AssertionError(f"29(a) sync against async: leaves {leaves_eq}, files {files_eq}; "
                             f"CRC backend {native.backend()}")
    # A restore of step 8 onto the card, timed.
    template = a._disk_template(a._layout_meta())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, rstep = Supervisor(checkpoint_dir=d["a"]).prepare_or_restore(template,
                                                                          device="cuda")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if rstep != 2 * steps or not same_tree(restored.params, a.state.params):
        raise AssertionError(f"29(a) restore of step {rstep}")
    # A byte flipped in step 8's file: a fresh trainer falls back to step 4.
    path = os.path.join(d["a"], f"step_{2 * steps}", "state.pt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(os.path.getsize(path) // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    jdir = os.path.join(root, "journal")
    j = obs.EventJournal.in_dir(jdir)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fb = ckpt_lm_trainer(d["a"], journal=j)
    j.close()
    warned = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    events = [(e["step"], e["fallback"]) for e in obs.read_events(jdir)
              if e["kind"] == "checkpoint_restore"]
    print(f"  (a) a byte flipped in step_{2 * steps}/state.pt: a fresh trainer restores step "
          f"{fb.start_step} ({len(warned)} warning: {warned[0][:60]!r}...), journaled "
          f"checkpoint_restore {events}; a restore of step {rstep} (verify, load, leaf CRCs, "
          f"onto the card) {restore_ms:.1f} ms")
    if fb.start_step != steps or not any(f"step_{2 * steps}" in w for w in warned) or events != [
            (steps, True)]:
        raise AssertionError(f"29(a) fallback: step {fb.start_step}, warnings {warned}, "
                             f"events {events}")
    del fb, b1, b2
    # The chunked tier against one run_compiled(2).
    c = ckpt_lm_trainer(d["c"], epochs_per_dispatch=1)
    c.run()
    ref = ckpt_lm_trainer()
    ref.run_compiled(CKPT_EPOCHS)
    torch.cuda.synchronize()
    chunked = (torch.equal(torch.stack(c.costs), torch.stack(ref.costs))
               and same_tree(c.state.params, ref.state.params))
    print(f"  (a) epochs_per_dispatch=1 over {CKPT_EPOCHS} epochs: saved steps "
          f"{checkpoint_steps(d['c'])}; its {len(c.costs)} losses and parameters against one "
          f"run_compiled({CKPT_EPOCHS}) bit for bit: {chunked}")
    if not chunked or checkpoint_steps(d["c"]) != [steps, 2 * steps]:
        raise AssertionError("29(a) the chunked tier")
    del a, c, ref
    shutil.rmtree(root, ignore_errors=True)
    return time.perf_counter() - t_phase


def ckpt_task(argv) -> int:
    """29(b)'s preempted run (``--ckpt-task``): the MLP through launch.run
    on the fused path, ``DTF_CHECKPOINT`` / ``DTF_KEEP_LAST`` /
    ``DTF_JOURNAL_DIR`` from the environment. Prints ``RESULT <json>``."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import run

    cfg = TrainConfig(epochs=CKPT_MLP_EPOCHS, engine="pallas", epochs_per_dispatch=1,
                      logs_path="", log_frequency=550)
    out = run(config=cfg, argv=argv)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def ckpt_mlp(records, ds):
    """29(b): the preempted run, its resume against an uninterrupted run,
    and a NaN rollback, all on the fused path. Returns the seconds."""
    import signal
    import tempfile

    import torch
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.train import trainer as trainer_mod
    from distributed_tensorflow_tpu_torch.train.supervisor import checkpoint_steps

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt-mlp-")
    ck, jdir = os.path.join(root, "ckpt"), os.path.join(root, "journal")
    logdir = dp_logdir("ckpt")
    log_path = os.path.join(logdir, "preempted.log")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DTF_CHECKPOINT=ck, DTF_KEEP_LAST="2", DTF_JOURNAL_DIR=jdir, DTF_LOGS="",
               PYTHONPATH=os.pathsep.join([here] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ckpt-task"],
                                stdout=log, stderr=subprocess.STDOUT, env=env)
        jpath, first = obs.rank_journal_path(jdir, 0), None
        try:
            while time.perf_counter() - t0 < 300 and proc.poll() is None:
                if os.path.exists(jpath):
                    with open(jpath) as f:
                        saves = [e for e in (json.loads(ln) for ln in f if ln.endswith("\n"))
                                 if e["kind"] == "checkpoint_save"]
                    if saves:
                        first = saves[0]["step"]
                        proc.send_signal(signal.SIGTERM)
                        break
                time.sleep(0.01)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        out = f.read()
    pre = [ln for ln in out.splitlines() if ln.startswith("Preemption:")]
    if rc != 0 or first is None or "RESULT " not in out:
        print("\n".join(out.splitlines()[-30:]))
        raise AssertionError(f"29(b) the preempted run: exit {rc}, first save {first}")
    res = dp_result(out)
    kept = checkpoint_steps(ck)
    saved = int(re.search(r"saved_step=(\d+)", pre[0]).group(1)) if pre else None
    print(f"  (b) launch.run on the fused path ({CKPT_MLP_EPOCHS} epochs, epochs_per_dispatch=1, "
          f"DTF_CHECKPOINT, DTF_KEEP_LAST=2) in its own process, SIGTERM after its first "
          f"checkpoint_save (step {first}): exit {rc} in {wall:.1f} s at global step "
          f"{res['global_step']}; {pre[0] if pre else 'no Preemption line'!r}; steps on disk "
          f"{kept}")
    if len(pre) != 1 or saved is None or saved < first or len(kept) > 2 or kept[-1] != res[
            "global_step"]:
        raise AssertionError(f"29(b) preemption: lines {pre}, kept {kept}, result {res}")
    cfg = TrainConfig(epochs=CKPT_MLP_EPOCHS, engine="pallas", epochs_per_dispatch=1,
                      logs_path="", log_frequency=550)
    tr = build_trainer(cfg.replace(checkpoint_dir=ck, keep_last_n=2), datasets=ds,
                       print_fn=lambda *a: None)
    if tr.start_step != kept[-1]:
        raise AssertionError(f"29(b) the resumed trainer restored step {tr.start_step}")
    _build.reset_launches()
    left = CKPT_MLP_EPOCHS - tr.epochs_completed
    tr.run(epochs=left)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launches != {"fused_mlp_epoch": left}:
        raise AssertionError(f"29(b) resumed run's launches {launches}, want {left} B2")
    for name, (base, _) in MLP_CKPT.items():
        records[name] = dict(records[base], launches=launches[base])
    full = build_trainer(cfg, datasets=ds, print_fn=lambda *a: None)
    full.run()
    torch.cuda.synchronize()
    bitwise = same_tree(tr.state.params, full.state.params) and tr.strategy.global_step(
        tr.state) == full.strategy.global_step(full.state)
    print(f"  (b) resumed at step {tr.start_step} ({tr.epochs_completed - left} epochs done), "
          f"{left} more ({launches}): the parameters against an uninterrupted "
          f"{CKPT_MLP_EPOCHS}-epoch run bit for bit: {bitwise}")
    if not bitwise:
        raise AssertionError("29(b) the resumed run parts from the uninterrupted one")
    # The NaN rollback: the second dispatch stages NaN images (the epoch's
    # data window poisoned), the chunk boundary restores epoch 1's step and
    # goes on with the next window.
    poisoned = Datasets(train=DataSet(np.full_like(ds.train.images, np.nan), ds.train.labels,
                                      seed=1), validation=ds.validation, test=ds.test)

    class Poisoned(trainer_mod.Trainer):
        def run_compiled(self, epochs=None, **kw):
            self.calls = getattr(self, "calls", 0) + 1
            self.datasets = poisoned if self.calls == 2 else ds
            return super().run_compiled(epochs, **kw)

    lines = []
    rb = build_trainer(TrainConfig(epochs=3, engine="pallas", epochs_per_dispatch=1,
                                   logs_path="", log_frequency=550, max_rollbacks=1,
                                   spike_threshold=0.0, checkpoint_dir=os.path.join(root, "rb")),
                       datasets=ds, print_fn=lines.append)
    rb.__class__ = Poisoned
    res_rb = rb.run()
    spe = ds.train.num_examples // 100
    roll = [ln for ln in lines if ln.startswith("Rollback:") and "restored_step=" in ln]
    compiled = [ln for ln in lines if ln.startswith("Rollback:") and "dispatch=compiled" in ln]
    print(f"  (b) a NaN data window in epoch 2 on the fused path (max_rollbacks=1): {roll} and "
          f"{len(compiled)} compiled-dispatch line; final cost {res_rb['final_cost']!r} at step "
          f"{res_rb['global_step']}")
    if (len(roll) != 1 or f"restored_step={spe}" not in roll[0] or "data_window=skipped"
            not in roll[0] or not np.isfinite(res_rb["final_cost"])
            or res_rb["global_step"] != 3 * spe):
        raise AssertionError(f"29(b) rollback: {lines[-8:]}")
    return time.perf_counter() - t_phase


def ckpt_mailbox(smi):
    """29(c): two gpt-s-L512 members of the DiLoCo mailbox gang one after
    the other (the contributors of each round, each post's payload), then a
    post torn through DTF_FAILPOINTS, skipped and counted. Returns the
    seconds."""
    import tempfile

    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.train import failpoints
    from distributed_tensorflow_tpu_torch.train.local_sgd import (
        DeltaExchange,
        delta_payload_nbytes,
    )

    class Journal:  # keeps the events a member emits
        def __init__(self):
            self.events = []

        def emit(self, kind, **fields):
            self.events.append({"kind": kind, **fields})
            return fields

        def flush(self):
            pass

    t_phase = time.perf_counter()
    box = tempfile.mkdtemp(prefix="ckpt-mailbox-")
    kw = dict(LSGD_DILOCO, dp_mode="diloco", diloco_workers=1, stale_limit=2, logs_path="")
    rounds, members = {}, []
    for rank in range(2):
        j = Journal()
        ex = DeltaExchange(box, rank, 2, stale_limit=2, delta_dtype="int8")
        tr = lsgd_trainer(kw, "sgd", delta_exchange=ex, journal=j)
        tr.run()
        rounds[rank] = [e for e in j.events if e["kind"] == "delta_exchange"]
        members.append((tr, ex))
    pattern = {r: [len(e["contributors"]) for e in ev] for r, ev in rounds.items()}
    shapes = GPTLM(**{**S_CFG, "max_len": LSGD_L}).init(seed=0, device="meta")
    want_payload = delta_payload_nbytes(shapes, "int8")
    payloads = []
    for name in sorted(os.listdir(box)):
        with np.load(os.path.join(box, name)) as z:
            payloads.append(sum(z[k].nbytes for k in z.files if k.startswith("a"))
                            + z["scales"].nbytes)
    files = [e["payload_nbytes"] for ev in rounds.values() for e in ev]
    print(f"  (c) two gpt-s-L512 members (diloco_workers=1, H=2, int8 deltas, stale_limit=2, "
          f"{LSGD_STEPS} steps each) one after the other: contributors a round {pattern}; each "
          f"post's payload {sorted(set(payloads))} bytes (delta_payload_nbytes "
          f"{want_payload}; phase 27's {LSGD_INT8_BYTES}), files {sorted(set(files))} bytes; "
          f"member 1's launches {members[1][0].launches}, ms a step "
          f"{', '.join(f'{x:.2f}' for x in members[1][0].step_ms)} [{smi}]")
    if pattern != {0: [1, 1], 1: [3, 1]} or set(payloads) != {want_payload}:
        raise AssertionError(f"29(c) contributors {pattern}, payloads {payloads}")
    # A post torn through DTF_FAILPOINTS: the peer skips it and counts it.
    (_, ex0), (_, ex1) = members
    leaves = [np.zeros(tuple(t.shape), np.float32) for t in tree_leaves(shapes)]
    os.environ["DTF_FAILPOINTS"] = "delta.post:torn@1"
    failpoints.reset()  # armed from the environment
    try:
        ex0.post(10, leaves)
    finally:
        del os.environ["DTF_FAILPOINTS"]
        failpoints.reset()
    got = ex1.gather(10)
    print(f"  (c) member 0's round-10 post torn through DTF_FAILPOINTS=delta.post:torn@1: member "
          f"1 takes {len(got)} contributions from it, corrupt_posts {ex1.corrupt_posts}")
    if got or ex1.corrupt_posts != 1:
        raise AssertionError(f"29(c) torn post: {len(got)} taken, {ex1.corrupt_posts} counted")
    return time.perf_counter() - t_phase


def phase_ckpt(records, ds, smi):
    """29: checkpoints and recovery on the card; each part's seconds."""
    a = ckpt_lm(records, smi)
    b = ckpt_mlp(records, ds)
    c = ckpt_mailbox(smi)
    print(f"  phase 29: (a) {a:.1f} s, (b) {b:.1f} s, (c) {c:.1f} s")


def phase_build():
    """Build every source and probe module (one ``nvcc`` each, started
    together); read ptxas's report of each: the kernels of
    NO_SPILL_KERNELS must not spill, the tensor-core ones must hold HMMA."""
    from distributed_tensorflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    ends = _build.build_all((*_build.SOURCES, *_build.PROBES))
    print(f"  built in {time.perf_counter() - t0:.1f} s (each build's end: "
          + ", ".join(f"{n} {t:.1f} s" for n, t in sorted(ends.items(), key=lambda e: e[1]))
          + ")")
    dumps = {src: start_sass(src) for src in TENSOR_CORE_KERNELS}
    for src in (*_build.SOURCES, *_build.PROBES):
        log = _build.BUILD_LOGS.get(src)
        if log is None:
            raise AssertionError(f"{src}: no ptxas report from its build")
        checked, fn, spills = NO_SPILL_KERNELS.get(src, ()), "", {}
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
            if m:
                fn = m.group(1)
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {src}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and any(k in fn for k in checked):
                spills[fn] = int(m.group(1)) + int(m.group(2))
        if checked:
            print(f"  {src}: {len(spills)} checked kernel builds, "
                  f"spill bytes {sum(spills.values())}")
            if not spills or any(spills.values()):
                raise AssertionError(f"{src}: register spills in {spills or 'no kernel found'}")
        if src in TENSOR_CORE_KERNELS:
            check_hmma(src, TENSOR_CORE_KERNELS[src], dumps[src])


def variant_times(ms, name, w, ck, cv, pk, pv, tables, lengths, active, h, hv, plens, slens,
                  hq):
    """``--kernel-times`` of the ``VARIANTS`` (a package that takes RoPE
    and 1-byte caches): B5, B6 and B7 as the bf16 ones, the caches
    quantized from the same values."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd
    from distributed_tensorflow_tpu_torch.ops.quantized import quantize_kv

    w0 = {k: t[0] for k, t in w.items()}
    for label, rope, kv in VARIANTS:
        if kv == "bf16":
            c, p = (ck, cv, None, None), (pk, pv, None, None)
        else:
            (a, sa), (b, sb) = quantize_kv(ck.float(), kv), quantize_kv(cv.float(), kv)
            (pa, psa), (pb, psb) = quantize_kv(pk.float(), kv), quantize_kv(pv.float(), kv)
            c, p = (a, b, sa, sb), (pa, pb, psa, psb)
        kw = dict(num_heads=hq, rope=rope, compute_dtype=torch.bfloat16)
        first = lambda t: None if t is None else t[0]  # noqa: E731
        ms[f"decode_block_slab {name} [{label}]"] = ab_ms(lambda: fd.decode_block_slab(
            h, w0, c[0][0], c[1][0], lengths, **kw, k_scale=first(c[2]), v_scale=first(c[3])))
        ms[f"decode_block_paged {name} [{label}]"] = ab_ms(lambda: fd.decode_block_paged(
            h, w0, p[0][0], p[1][0], tables, lengths, **kw, k_scale=first(p[2]),
            v_scale=first(p[3])))
        ms[f"decode_token_slab {name} [{label}]"] = ab_ms(lambda: fd.decode_token_slab(
            h, w, c[0], c[1], lengths, active, **kw, k_scale=c[2], v_scale=c[3]))
        ms[f"decode_token_paged {name} [{label}]"] = ab_ms(lambda: fd.decode_token_paged(
            h, w, p[0], p[1], tables, lengths, active, **kw, k_scale=p[2], v_scale=p[3]))
        ms[f"verify_tokens_paged {name} [{label}] L=5"] = ab_ms(
            lambda: fd.verify_tokens_paged(hv, w, p[0], p[1], tables, plens, slens, active,
                                           **kw, k_scale=p[2], v_scale=p[3]))
        del c, p


def kernel_times(label, smi):
    """``--kernel-times``: B5, B6, B7 and B4b through their wrappers (ms a
    call, :func:`cuda_ms`; the decode kernels the median of
    ``AB_BATCHES`` batches, :func:`ab_ms`: a B5 call is host-bound, and
    single batches of it varied by 25%) on seeded inputs:
    the decode kernels at S=8
    slots, cache lengths 256-768 in a cache of 1024 (paged: blocks of 16
    under scrambled tables), B7 at L=5, and B6 over the rolling slab of
    ``WINDOW`` rows, B6 paged and B7 with the window; B4b (and at gpt-m B4c,
    B4a) at B=16, L=1024, f32, causal; B3 at S=8, L=1023 (causal, and
    banded); B3 and B4a/B4b/B4c at head dim 16 at the classifier's shape
    (the median of ``AB_BATCHES`` batches: launch-bound). Every tree an A/B
    compares (from the one that added head dim 16 on) takes RoPE, 1-byte
    caches, the window and D=16."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    s, c, mb = 8, 1024, 1024 // BLOCK
    ms = {}

    def rw(*shape, scale):
        return torch.randn(shape, device=dev, generator=g) * scale

    for name, d, hq, f, nl in (("gpt-m", 512, 8, 2048, 8), ("gpt-xl", 2048, 16, 8192, 1)):
        dh = d // hq
        w = {"ln1_scale": 1 + rw(nl, d, scale=0.1), "ln1_bias": rw(nl, d, scale=0.05),
             "ln2_scale": 1 + rw(nl, d, scale=0.1), "ln2_bias": rw(nl, d, scale=0.05),
             "b_up": rw(nl, f, scale=0.05), "b_down": rw(nl, d, scale=0.05)}
        for nm, (k, n) in dict(wq=(d, d), wk=(d, d), wv=(d, d), wo=(d, d), w_up=(d, f),
                               w_down=(f, d)).items():
            w[nm] = rw(nl, k, n, scale=k ** -0.5).bfloat16()
        ck, cv = (rw(nl, s, c, hq, dh, scale=1.0).bfloat16() for _ in range(2))
        lengths = torch.randint(256, 769, (s,), device=dev, generator=g, dtype=torch.int32)
        h = rw(s, d, scale=1.0)
        tables = torch.randperm(s * mb, device=dev, generator=g).reshape(s, mb).int()
        pk = torch.empty(nl, s * mb, BLOCK, hq, dh, device=dev, dtype=torch.bfloat16)
        pv = torch.empty_like(pk)
        for i in range(s):
            pk[:, tables[i].long()] = ck[:, i].reshape(nl, mb, BLOCK, hq, dh)
            pv[:, tables[i].long()] = cv[:, i].reshape(nl, mb, BLOCK, hq, dh)
        w0 = {k: t[0] for k, t in w.items()}
        kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
        ms[f"decode_block_slab {name}"] = ab_ms(
            lambda: fd.decode_block_slab(h, w0, ck[0], cv[0], lengths, **kw))
        ms[f"decode_block_paged {name}"] = ab_ms(
            lambda: fd.decode_block_paged(h, w0, pk[0], pv[0], tables, lengths, **kw))
        if nl > 1:
            active = torch.ones(s, dtype=torch.bool, device=dev)
            plens = lengths + (lengths % BLOCK == 0).int()
            slens = torch.tensor([1, 2, 3, 4, 5, 5, 3, 2], device=dev, dtype=torch.int32)
            hv = rw(s, 5, d, scale=1.0)
            ms[f"decode_token_slab {name} {nl} layers"] = ab_ms(
                lambda: fd.decode_token_slab(h, w, ck, cv, lengths, active, **kw))
            ms[f"decode_token_paged {name} {nl} layers"] = ab_ms(
                lambda: fd.decode_token_paged(h, w, pk, pv, tables, lengths, active, **kw))
            ms[f"verify_tokens_paged {name} {nl} layers L=5"] = ab_ms(
                lambda: fd.verify_tokens_paged(hv, w, pk, pv, tables, plens, slens, active,
                                               **kw))
            variant_times(ms, name, w, ck, cv, pk, pv, tables, lengths, active, h, hv, plens,
                          slens, hq)
            # The window variants: B6 over the rolling slab, B6 paged, B7.
            from distributed_tensorflow_tpu_torch.models.gpt import rolling_layout

            wkw = dict(kw, window=WINDOW)
            rk, rv = (rolling_layout(t, lengths, WINDOW) for t in (ck, cv))
            ms[f"decode_token_slab[window] {name} {nl} layers"] = ab_ms(
                lambda: fd.decode_token_slab(h, w, rk, rv, lengths, active, **wkw))
            ms[f"decode_token_paged[window] {name} {nl} layers"] = ab_ms(
                lambda: fd.decode_token_paged(h, w, pk, pv, tables, lengths, active, **wkw))
            ms[f"verify_tokens_paged[window] {name} {nl} layers L=5"] = ab_ms(
                lambda: fd.verify_tokens_paged(hv, w, pk, pv, tables, plens, slens, active,
                                               **wkw))
            del rk, rv
        del w, w0, ck, cv, pk, pv
    for name, hq, dh in (("gpt-m B=16 L=1024 8x64", 8, 64),
                         ("gpt-xl B=16 L=1024 16x128", 16, 128)):
        q, k, v, do, _, lse, delta, _ = bwd_inputs(16, 1024, hq, hq, dh, torch.float32, False,
                                                   False, g, dev)
        ms[f"flash_bwd_dq {name}"] = cuda_ms(
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True), 10)
        if hq == 8:  # B4c and B4a at gpt-m (the window touched their loops)
            ms[f"flash_bwd_dkv {name}"] = cuda_ms(
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True), 10)
            ms[f"flash_bwd_fused {name}"] = cuda_ms(
                lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True), 10)
        del q, k, v, do, lse, delta
    # B3 at the serving shapes (S=8, L=1023, 8x64, f32, kv_lens 513..1023).
    q, k, v = (torch.randn(8, 1023, 8, 64, device=dev, generator=g) for _ in range(3))
    lens = torch.randint(513, 1024, (8,), device=dev, generator=g, dtype=torch.int32)
    ms["flash_fwd S=8 L=1023 8x64"] = cuda_ms(
        lambda: fa.flash_attention_with_lse(q, k, v, causal=True, kv_lens=lens))
    ms[f"flash_fwd[window] S=8 L=1023 8x64 W={WINDOW}"] = cuda_ms(
        lambda: fa.flash_attention_with_lse(q, k, v, causal=True, window=WINDOW, kv_lens=lens))
    # B3 and B4a/B4b/B4c at head dim 16, the classifier's attention shape
    # (CLS_ATTN, f32, non-causal): launch-bound, so the median of batches.
    b, l, hh, d = CLS_ATTN
    q, k, v, do = (torch.randn(b, l, hh, d, device=dev, generator=g) for _ in range(4))
    out, lse = fa.flash_attention_with_lse(q, k, v)
    delta = (do * out).sum(-1)
    shape = f"B={b} L={l} {hh}x{d}"
    ms[f"flash_fwd d16 {shape}"] = ab_ms(lambda: fa.flash_attention_with_lse(q, k, v))
    ms[f"flash_bwd_fused d16 {shape}"] = ab_ms(lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta))
    ms[f"flash_bwd_dq d16 {shape}"] = ab_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta))
    ms[f"flash_bwd_dkv d16 {shape}"] = ab_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta))
    print(json.dumps({"label": label, "card": smi, "ms": ms}))
    return 0


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time B5/B6/B7/B4b through their wrappers (no phase runs)")
    ap.add_argument("--root", help="with --kernel-times: the checkout whose package to time")
    ap.add_argument("--label", default="", help="with --kernel-times: a name for the line")
    ap.add_argument("--dp-task", choices=("sync", "async", "fused"),
                    help="run one task of a phase-20 cluster (started by the launcher)")
    ap.add_argument("--dp-epochs", type=int, default=DP_EPOCHS)
    ap.add_argument("--dp-port", type=int, default=0)
    ap.add_argument("--sp-task", action="store_true",
                    help="run one rank of phase 24's world (started by the launcher)")
    ap.add_argument("--tp-task", action="store_true",
                    help="run one rank of phase 25's world (started by the launcher)")
    ap.add_argument("--epp-task", action="store_true",
                    help="run one rank of phase 26's world (started by the launcher)")
    ap.add_argument("--lsgd-task", action="store_true",
                    help="run one rank of phase 27's world (started by the launcher)")
    ap.add_argument("--ckpt-task", action="store_true",
                    help="run phase 29(b)'s preempted MLP run (started by phase 29)")
    args, rest = ap.parse_known_args()
    if args.dp_task:
        return dp_task(args.dp_task, args.dp_epochs, args.dp_port, rest)
    if args.sp_task:
        return sp_task(args.dp_port, rest)
    if args.tp_task:
        return tp_task(args.dp_port, rest)
    if args.epp_task:
        return epp_task(args.dp_port, rest)
    if args.lsgd_task:
        return lsgd_task(args.dp_port, rest)
    if args.ckpt_task:
        return ckpt_task(rest)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.root:
        if not args.kernel_times:
            ap.error("--root goes with --kernel-times")
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

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
    if args.kernel_times:
        return kernel_times(args.label or os.path.abspath(args.root or "."), smi)

    t0 = time.perf_counter()

    def phase(title):  # the phase's header, with the run's time so far
        print(f"phase {title} (at {time.perf_counter() - t0:.1f} s)")

    phase("2: build")
    phase_build()

    records: dict[str, dict] = {}
    phase("3: kernels vs plain versions")
    phase_kernels(records)
    phase("4: serve gpt-m-L1024-flash")
    model, params, prompts, configs, outs = phase_serve(records)
    phase("5: per-layer kernel path")
    phase_fused_layer(records, model, params, prompts, configs, outs)
    phase("5(b): the per-layer kernel path at gpt-xl width")
    phase_fused_layer_xl(prompts)
    phase("6: small-input reference")
    phase_small_reference()
    phase("7: MLP kernels vs plain versions")
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets

    ds = read_data_sets("MNIST_data", one_hot=True)  # synthetic without IDX files
    phase_mlp_kernels(records, ds)
    phase(f"8: train the MNIST MLP, {MLP_EPOCHS} epochs")
    phase_mlp_train(records, ds)
    phase("9: bench")
    phase_mlp_bench(records, ds)
    phase("10: serve gpt-m-L1024 on the paged pool")
    phase_paged_serve(records, model, params)
    del model, params
    phase("11: flash-attention backward kernels vs plain versions")
    phase_bwd_kernels(records)
    phase("12: train gpt-m-L1024-flash through LMTrainer")
    print(f"  matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")
    phase_train(records)
    phase("12(b): the copy task through the backward kernels")
    phase_copy_task(records)
    phase("12(c): train gpt-xl-L1024-flash-remat through LMTrainer (the split backward)")
    phase_train_xl(records)
    phase(f"13: serve gpt-m-L1024 ({SERVED_LAYERS} layers) with RoPE, and with int8/fp8 KV "
          "caches")
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    cut = dict(SERVE_CFG, num_layers=SERVED_LAYERS)
    rope = GPTLM(**cut, pos_embedding="rope", compute_dtype=torch.bfloat16)
    phase_kv_serve(records, "rope", rope, perturbed_params(rope, 11, "cuda"),
                   ("bf16", "int8", "fp8"))
    learned = GPTLM(**cut, compute_dtype=torch.bfloat16)
    phase_kv_serve(records, "learned", learned, perturbed_params(learned, 0, "cuda"), ("int8",))
    del rope, learned
    phase("14: the single-sequence decode API (greedy_decode), and an f32 model")
    phase_single_sequence(records)
    phase(f"15: serve gpt-m-L1024-W{WINDOW} ({SERVED_LAYERS} layers; the sliding window)")
    phase_window_serve(records)
    phase(f"16: train gpt-m-L1024-W{WINDOW} through LMTrainer (the banded backward)")
    phase_window_train(records)
    phase("17: serve the decode-* models (head_dim 32), and C1 end to end")
    phase_s_serve(records)
    phase("18: train gpt-s-L512-flash and gpt-s-L2048-flash-W512 through LMTrainer")
    phase_s_train(records)
    t19 = time.perf_counter()
    phase("19(a): selective remat at gpt-xl-L1024, and the composed optimizer")
    phase_selective_remat(records)
    phase("19(b): BPE text through LMTrainer.run() and run_compiled()")
    phase_text(records)
    phase("19(c): the MLP Trainer with stateful optimizers")
    phase_mlp_optimizers(records, ds)
    print(f"  phase 19 took {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    phase("20: the data-parallel modes (NCCL world of one; 2 workers + 1 ps over gloo; "
          "B2's composition on 2 ranks)")
    phase_dp(records, ds, smi)
    print(f"  phase 20 took {time.perf_counter() - t20:.1f} s")
    t21 = time.perf_counter()
    phase("21: the classifiers (CNN, LSTM, transformer) through build_trainer and Predictor; "
          "B3/B4 at head_dim 16")
    phase_classifiers(records, ds)
    print(f"  phase 21 took {time.perf_counter() - t21:.1f} s")
    t22 = time.perf_counter()
    phase("22: serve decode-full in f32 compute; head dims 8 and 16 served, 8 and 48 trained")
    phase_f32_serve(records)
    print(f"  phase 22 took {time.perf_counter() - t22:.1f} s")
    t23 = time.perf_counter()
    phase("23: MoE gpt-m trained and served, the quantized products (training and weight-only "
          "decode), head dim 4 on B5/B6/B7")
    phase_moe_quantized(records)
    print(f"  phase 23 took {time.perf_counter() - t23:.1f} s")
    t24 = time.perf_counter()
    phase(f"24: sequence-parallel GPT training ({SP_RANKS} ranks on the card over the ring-flash "
          "path; the ring offset on B3/B4a/B4b/B4c)")
    phase_sp(records, smi)
    print(f"  phase 24 took {time.perf_counter() - t24:.1f} s")
    t25 = time.perf_counter()
    phase(f"25: tensor parallelism ({TP_RANKS} ranks on the card: GPT dp x tp, tp over 2 KV "
          "heads, tp x sp; the classifiers' Megatron layouts)")
    phase_tp(records, smi)
    print(f"  phase 25 took {time.perf_counter() - t25:.1f} s")
    t26 = time.perf_counter()
    phase(f"26: expert and pipeline parallelism ({EPP_RANKS} ranks on the card: GPT ep, dp x ep, "
          "pp, dp x pp with remat)")
    phase_epp(records, smi)
    print(f"  phase 26 took {time.perf_counter() - t26:.1f} s")
    t27 = time.perf_counter()
    phase(f"27: the LM's async and ZeRO modes and DiLoCo ({LSGD_RANKS} ranks on the card: async "
          "avg_every 1 and 2, zero against dp, the DiLoCo gang with int8 deltas, overlapped)")
    phase_lsgd(records, smi)
    print(f"  phase 27 took {time.perf_counter() - t27:.1f} s")
    t28 = time.perf_counter()
    phase("28: the telemetry: the MLP through launch.run with DTF_LOGS and DTF_JOURNAL_DIR; "
          "gpt-m through LMTrainer with a journal, metrics, tfevents and a profile")
    phase_obs(records, ds, smi)
    print(f"  phase 28 took {time.perf_counter() - t28:.1f} s")
    t29 = time.perf_counter()
    phase("29: checkpoints and recovery: gpt-m through LMTrainer saved, resumed, restored past a "
          "flipped byte and chunked; the MLP preempted by SIGTERM, resumed and rolled back; the "
          "DiLoCo mailbox gang")
    phase_ckpt(records, ds, smi)
    print(f"  phase 29 took {time.perf_counter() - t29:.1f} s")
    print(f"total {time.perf_counter() - t0:.1f} s")

    kernels = []
    variants = [(f"{k}[{label}]", k, f"{PATHS.get(k, 'main')} {label}")
                for label, _, _ in VARIANTS + WINDOW_VARIANTS for k in DECODE_KERNELS]
    variants += [(name, base, path) for name, (base, _, path) in FLASH_WINDOWS.items()]
    variants += [(f"{k}[{v[0]}]", k, f"{PATHS.get(k, 'main')} {v[0]}")
                 for v in S_VARIANTS for k in DECODE_KERNELS]
    variants += [(name, base, path) for name, (base, path) in FLASH_D32.items()]
    variants += [(name, base, path) for name, (base, path) in FLASH_XL_SELECTIVE.items()]
    variants += [(name, base, path) for name, (base, path) in FLASH_D16.items()]
    variants += [(f"{k}[{v[0]}]", k, f"{PATHS.get(k, 'main')} {v[0]}")
                 for v in F32_VARIANTS for k in DECODE_KERNELS]
    variants += [(f"{k}[{lab}-{dt}]", k, f"{PATHS.get(k, 'main')} {lab}-{dt}")
                 for lab, _ in NARROW_MODELS for dt in ("bf16", "f32") for k in DECODE_KERNELS]
    variants += [(name, base, path) for name, (base, path) in FLASH_NARROW.items()]
    variants += [(f"{k}[{lab}]", k, f"{PATHS.get(k, 'main')} {lab}")
                 for lab in DH4_LABELS for k in DECODE_KERNELS]
    variants += [("verify_tokens_paged[c1-gqa2-2048]", "verify_tokens_paged", "c1 paged-spec")]
    variants += [("fused_mlp_epoch[dp-async]", "fused_mlp_epoch", "mlp-dp-async 2 ranks")]
    variants += [(name, base, path) for name, (base, path) in FLASH_OFFSET.items()]
    variants += [(name, base, path) for name, (base, path) in FLASH_TP.items()]
    variants += [(name, base, path) for name, (base, path) in FLASH_EPP.items()]
    variants += [(name, base, path) for name, (base, path) in FLASH_LSGD.items()]
    variants += [(name, base, path) for name, (base, path) in {**FLASH_OBS, **MLP_OBS}.items()]
    variants += [(name, base, path) for name, (base, path) in {**FLASH_CKPT, **MLP_CKPT}.items()]
    for kname, base, path in [(k, k, PATHS.get(k, "main")) for k in SOURCES] + variants:
        src, replaces = SOURCES[base]
        r = records[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "path": path,
            **({"bound_peak": r["bound_peak"]} if "bound_peak" in r else {}),
            **({"graph_ms": r["graph_ms"]} if "graph_ms" in r else {}),
        })
    print(f"power: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
