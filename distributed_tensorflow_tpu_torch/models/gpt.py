"""GPT-style causal decoder LM in PyTorch: serving and training.

Counterpart of ``distributed_tensorflow_tpu/models/gpt.py`` ``GPTLM``:
config and validation (:212-402), ``init`` (:406), the forward pieces
``_dot_full`` / ``_dot`` / ``decode_weights`` / ``_embed_tokens`` /
``_moe_capacity`` / ``_moe_block_ffn`` / ``_ffn`` / ``_block`` / ``_logits``
(:513-786), the training forward and loss ``apply`` / ``apply_with_aux`` /
``loss`` / ``loss_and_metrics`` (:789-823, :1078-1125) with ``_picked_nll`` /
``_ce_from_logits`` (:2572-2602) and the single-device
``make_lm_train_step`` (:3245-3335), the slot cache surface ``cache_len``
/ ``empty_slot_cache`` / ``reset_slots`` / ``prefill_slots`` /
``decode_slots`` (:1268-1797) with its engine resolution (:1129-1204),
and the paged cache surface ``PagedKVCache`` (:160),
``paged_blocks_per_slot`` / ``empty_paged_cache`` / ``extend_paged`` /
``verify_paged`` / ``decode_paged`` (:1871-2273); the per-layer engine's
commit ``_commit_paged_rows`` (:1234) is
``ops/fused_decode.commit_paged_rows``; the single-sequence decode
``KVCache`` (:193), ``prefill`` (:1276), ``decode_step`` (:1367),
``greedy_decode`` / ``sample_decode`` / ``beam_decode`` (:2275-2503).
A windowed model (``window=W``: each query sees its last W positions,
self included) trains and prefills through the banded flash kernels,
keeps a slab of ``cache_len = min(W, max_len)`` rows as a rolling buffer
(position p at slot ``p mod cache_len``, as in the JAX package) and its
paged pool absolutely, with the band masked.
Slot caches and pools take ``kv_dtype`` "bf16" (the compute dtype),
"int8" or "fp8": 1-byte codes with one f32 scale a row in ``k_scale`` /
``v_scale``, quantized on write and dequantized to the compute dtype on
every read (``ops/quantized.py``), the fresh rows included.

Architecture as there: token embed + learned positions (or RoPE) → N
pre-LN blocks (causal attention + tanh-GELU MLP, residuals) → final LN →
logits through the tied embedding. Products run on compute-dtype operands
with f32 accumulation; layernorm and softmax are f32.

Parameters are NamedTuples of tensors keyed like the JAX ones, so
``convert.py`` carries them across through numpy. Attention over a whole
sequence (training and prefill) goes through the flash kernels when
``attention_impl="flash"`` (the dense plain path otherwise): the forward
kernel, and under autograd the backward kernels
(``ops/flash_attention.flash_attention_op``; ``flash_fused`` picks the
fused backward or the dq + dk/dv pair, None = the auto rule); the paged extend (prefill and
the per-layer verify) is plain PyTorch, as it is XLA in the JAX package.
Single-token decode goes through the fused decode kernels and the
speculation verify through the fused verify kernel. On a CUDA device a
kernel launches or raises; on the CPU the plain versions run; the
``"xla"`` engine runs the plain versions on any device, when a caller names
it. Caches and
pools are updated in place. Gradients are torch autograd's where the JAX
package takes ``jax.value_and_grad``; ``remat=True`` checkpoints each
block (``torch.utils.checkpoint``), as ``jax.checkpoint`` does there;
``remat="selective"`` keeps the flash operator's out and lse, so the
recompute skips the forward kernel (the JAX ``save_names`` policy, :306-340
and :592-648); a callable ``remat`` is a torch selective-checkpoint policy.

MoE blocks (``moe_experts=E``, ``moe_top_k=k``; ``GPTMoEBlockParams``)
route each token's FFN through ``ops/moe.moe_ffn_local`` with a static
capacity (every token when L == 1, else the ``moe_capacity_factor`` rule),
pad tokens masked out of routing (``token_mask``), and add the router's
balance and z losses to the training loss (``loss_and_metrics``).
``matmul_dtype`` ("int8" | "fp8") sends the block projections through
``ops/quantized.quantized_dot`` (straight-through backward); a
``QuantizedLinear`` leaf (``decode_weights``, weight-only serving) through
``wo_dot``; the logits head always stays at the compute dtype. These three
are outside the decode kernels: "fused" and "fused-layer" refuse them with
the JAX package's reasons, and "auto" serves them on "xla", whose plain
decode then runs the model's own products and FFN.

Sequence parallelism (``apply_sequence_parallel``, JAX :825-935;
``make_lm_sp_parts`` / ``make_lm_sp_train_step``, JAX :2969-3091) runs
one rank of a :class:`~parallel.mesh.Mesh` per sequence shard: absolute
positions, the ring (plain), ring-flash (the flash kernels a hop, the
ring offset on a windowed model's past hops) or Ulysses attention of
``ops/ring_attention.py``, and the exact global masked CE with the shard
boundary's target over one permute hop. The data-parallel step
(``make_lm_train_step(model, opt, mesh, axis)``, JAX :3336-3356) splits
the batch over ``axis``. Both take the global batch on every rank and
keep their shard.

Tensor parallelism (``partition_specs``, JAX :467-503; ``make_lm_train_step``
with ``tp_axis``, and ``seq_axis`` its dp×tp×sp form, JAX :3245-3335) is
Megatron's, written out where the JAX package leaves it to GSPMD: each
rank of the ``model`` axis holds its columns of wq/wk/wv/w_up (and b_up)
and its rows of wo/w_down, so attention runs on its local heads (the
flash kernels at H/tp heads) and the FFN on its local units; the inputs of
the column products pass Megatron's f (``ops/collectives.copy_to``), the
row products' partial sums its g (``reduce_from``) before the residual
biases. When the axis size does not divide ``num_kv_heads``, each rank
gathers k and v over the axis (``gather_from``) and keeps the KV heads its
query heads read. The port refuses a layout whose axis size does not
divide the heads or the KV columns (the JAX package pads them), and
``matmul_dtype`` (its dynamic scales span the whole contraction).

Expert parallelism (``apply_expert_parallel``, JAX :937-1003;
``expert_parallel_specs``, ``make_lm_ep_parts`` / ``make_lm_ep_train_step``,
JAX :2605-2790) puts one expert's FFN weights on each rank of the
``expert`` axis: attention runs locally on the rank's batch shard, each MoE
block's FFN is ``ops/moe.moe_ffn``'s two all-to-alls, capacity per
(expert, source rank), the loss the mean over shards of each shard's CE
and router terms. Pipeline parallelism (``pipeline_stage_blocks``,
``apply_pipeline_parallel``, JAX :1005-1077; ``pipeline_parallel_specs``,
``pipeline_stage_params``, ``make_lm_pp_parts`` / ``make_lm_pp_train_step``,
JAX :2793-2966) stages the blocks as [S, L/S, ...], one layer group a rank
of the ``stage`` axis, and runs them as the GPipe schedule of
``parallel/pipeline.py`` over microbatches, embedding, head and CE on
every stage. JAX's automatic gradient sums are written out: each step sums
a replicated leaf's gradient over the axes that split the batch, and a
split leaf's over those its own split has not already summed.

The LM's async local SGD (``make_lm_async_parts`` /
``make_lm_async_train_step``, JAX :3094-3243) keeps a copy of the
parameters and optimizer state a rank of the data axis, each stepping on
its rows of the batch with its update scaled by ``update_scale``, and every
``avg_every`` steps all copies jump to their mean through one all-reduce;
no collective runs on the other steps. Its ZeRO step (``make_lm_zero_parts``;
JAX's GSPMD layout over ``parallel/fsdp.fsdp_specs``, ``lm_trainer.py``
:597-604) keeps each rank's slice of every parameter and slot, gathers the
parameters for the forward and updates the slices with the summed gradient.
The DiLoCo outer loop over either engine is ``train/local_sgd.py``. The
CUDA decode kernels compute in the model's dtype, bf16 or f32, at head dims
4 to 128 (``ops/fused_decode.HEAD_DIMS``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.base import layernorm, resolve_flash_min_len, rope
from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
from distributed_tensorflow_tpu_torch.ops.collectives import TensorParallel
from distributed_tensorflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    selective_policy,
)
from distributed_tensorflow_tpu_torch.ops.fused_decode import (
    PROJ_NAMES,
    WEIGHT_NAMES,
    commit_paged_rows,
    commit_slot_rows,
    decode_block_paged,
    decode_block_slab,
    decode_token_paged,
    decode_token_paged_plain,
    decode_token_slab,
    decode_token_slab_plain,
    dot,
    slot_group,
    verify_tokens_paged,
)
from distributed_tensorflow_tpu_torch.ops.moe import MoEAux, MoEParams, moe_ffn_local
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map, tree_unflatten
from distributed_tensorflow_tpu_torch.ops.paged_attention import (
    gather_block_view,
    paged_extend_attention,
    scatter_rows,
)
from distributed_tensorflow_tpu_torch.ops.quantized import (
    MATMUL_DTYPES,
    QuantizedLinear,
    as_stored,
    dequantize_kv,
    index_leaf,
    kv_elem_bytes,
    kv_quant_dtype,
    kv_storage_dtype,
    movable,
    quantize_linear_columns,
    quantized_dot,
    wo_dot,
)
from distributed_tensorflow_tpu_torch.parallel.specs import (
    aligned_specs,
    pinned_update,
    shard_tree,
    slot_specs,
)

# "fused" is the megakernel (one launch per token), "fused-layer" the
# per-layer kernel kept as its parity oracle (the JAX "pallas-layer"),
# "xla" the plain decode (the JAX package's XLA engine) on any device.
DECODE_ENGINES = ("auto", "fused", "fused-layer", "xla")


class GPTBlockParams(NamedTuple):
    """One decoder block; every leaf carries a leading [num_layers] axis."""

    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor  # [n, d, Hq·Dh]
    wk: torch.Tensor  # [n, d, Hkv·Dh]
    wv: torch.Tensor
    wo: torch.Tensor  # [n, d, d]
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w_up: torch.Tensor  # [n, d, 4d]
    b_up: torch.Tensor
    w_down: torch.Tensor  # [n, 4d, d]
    b_down: torch.Tensor


class GPTMoEBlockParams(NamedTuple):
    """A decoder block whose FFN is a top-k MoE (``ops/moe.py``): the
    attention fields of :class:`GPTBlockParams`, the FFN weights stacked
    over experts (axis 1; axis 0 is the layer)."""

    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    wg: torch.Tensor  # [n, d, E] gate (stays f32)
    w_up: torch.Tensor  # [n, E, d, 4d]
    b_up: torch.Tensor  # [n, E, 4d]
    w_down: torch.Tensor  # [n, E, 4d, d]
    b_down: torch.Tensor  # [n, E, d]


class GPTLMParams(NamedTuple):
    embed: torch.Tensor  # [vocab, d] (also the tied LM head)
    pos: torch.Tensor  # [max_len, d]
    blocks: GPTBlockParams  # or GPTMoEBlockParams
    lnf_scale: torch.Tensor
    lnf_bias: torch.Tensor


class SlotKVCache(NamedTuple):
    """Per-slot serving cache: K/V [num_layers, S, cache_len, Hkv, Dh] in
    the compute dtype, or int8/fp8 codes with their f32 scales
    ``k_scale``/``v_scale`` [num_layers, S, cache_len, Hkv] (None for the
    bf16 layout), and each slot's written length [S] int32."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


class PagedKVCache(NamedTuple):
    """Serving cache over a shared BLOCK POOL: K/V [num_layers, num_blocks,
    block_size, Hkv, Dh] in the compute dtype, each slot mapping logical
    position ``p`` to ``pool[block_tables[s, p // bs], p % bs]``
    (``block_tables`` [S, max_blocks] int32), and each slot's written
    length [S] int32. Two slots may map the same physical block for a
    shared prompt prefix (the host refcounts in ``serve_pool.py``) and,
    for an int8/fp8 pool, the block's scales in ``k_scale``/``v_scale``
    [num_layers, num_blocks, block_size, Hkv] with it; unused table entries
    read garbage that the validity masks keep out."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


class KVCache(NamedTuple):
    """Single-sequence decode state (``prefill`` / ``decode_step``): K/V
    [num_layers, B, cache_len, Hkv, Dh] in the compute dtype and the
    number of positions written, shared by the batch. ``length`` is a host
    int (the JAX package's is a device scalar), so a step needs no device
    sync to check it."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


class GPTLM:
    """tokens [B, L] int → next-token logits [B, L, vocab]."""

    def __init__(
        self,
        vocab_size: int = 256,
        max_len: int = 128,
        model_dim: int = 64,
        num_heads: int = 4,
        num_kv_heads: int | None = None,
        num_layers: int = 2,
        compute_dtype=torch.bfloat16,
        attention_impl: str = "xla",
        window: int | None = None,
        moe_experts: int | None = None,
        moe_capacity_factor: float = 2.0,
        moe_balance_coef: float = 1e-2,
        moe_z_coef: float = 1e-3,
        moe_top_k: int = 1,
        pos_embedding: str = "learned",
        remat=False,
        flash_min_len: int | None = None,
        flash_fused: bool | None = None,
        matmul_dtype: str | None = None,
        decode_engine: str = "auto",
    ):
        if model_dim % num_heads:
            raise ValueError(
                f"model_dim {model_dim} must be a multiple of num_heads {num_heads}"
            )
        # "xla" keeps the JAX package's name for the dense attention path.
        if attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"unknown attention_impl {attention_impl!r}; xla|flash"
            )
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if moe_experts is not None and moe_experts < 2:
            raise ValueError(f"moe_experts must be >= 2, got {moe_experts}")
        if moe_top_k < 1 or (moe_experts is not None and moe_top_k > moe_experts):
            raise ValueError(f"moe_top_k {moe_top_k} must be in [1, moe_experts={moe_experts}]")
        if moe_top_k > 1 and moe_experts is None:
            raise ValueError(f"moe_top_k={moe_top_k} requires a MoE model (set moe_experts)")
        if matmul_dtype is not None and matmul_dtype not in MATMUL_DTYPES:
            raise ValueError(
                f"unknown matmul_dtype {matmul_dtype!r}; None or one of {MATMUL_DTYPES}"
            )
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"unknown pos_embedding {pos_embedding!r}; learned|rope"
            )
        if pos_embedding == "rope" and (model_dim // num_heads) % 2:
            raise ValueError(
                f"rope needs an even head_dim, got {model_dim // num_heads}"
            )
        # remat: False; True (recompute each block in the backward);
        # "selective" (save the flash operator's out and lse, recompute the
        # layernorm/QKV/MLP half: the forward kernel runs once a layer a
        # step); or a torch.utils.checkpoint policy_fn (the JAX package's
        # jax.checkpoint policy callable).
        if not (isinstance(remat, bool) or remat == "selective" or callable(remat)):
            raise ValueError(
                f"remat must be False, True, 'selective', or a checkpoint "
                f"policy callable; got {remat!r}"
            )
        if flash_fused is not None and not isinstance(flash_fused, bool):
            raise ValueError(f"flash_fused must be None, False or True, got {flash_fused!r}")
        if num_kv_heads is None:
            num_kv_heads = num_heads
        if num_kv_heads < 1:
            raise ValueError(f"num_kv_heads must be >= 1, got {num_kv_heads}")
        if num_heads % num_kv_heads:
            raise ValueError(
                f"num_heads {num_heads} must be a multiple of num_kv_heads "
                f"{num_kv_heads}"
            )
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be torch.float32 or torch.bfloat16, got "
                f"{compute_dtype!r}"
            )
        if decode_engine not in DECODE_ENGINES:
            raise ValueError(
                f"unknown decode_engine {decode_engine!r}; one of {DECODE_ENGINES}"
            )
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = model_dim // num_heads
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.window = window
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_top_k = moe_top_k
        self.moe_balance_coef = moe_balance_coef
        self.moe_z_coef = moe_z_coef
        self.pos_embedding = pos_embedding
        self.remat = remat
        self.flash_min_len = flash_min_len
        self.flash_fused = flash_fused
        self.matmul_dtype = matmul_dtype
        self.decode_engine = decode_engine
        if decode_engine in ("fused", "fused-layer"):
            reason = self._config_unsupported_reason()
            if reason is not None:
                raise ValueError(f"decode_engine={decode_engine!r} unsupported: {reason}")

    # -- init --------------------------------------------------------------

    def init(self, seed: int = 1, device=None) -> GPTLMParams:
        """Fresh parameters from ``seed`` (a CPU ``torch.Generator``, then
        moved to ``device``). The draws are PyTorch's, not JAX's; the shapes,
        scales and zero-initialized residual projections (``wo``,
        ``w_down``) are the JAX package's, MoE blocks' expert stacks and
        f32 gate included. On the ``meta`` device it gives the shapes and
        dtypes only (what a layout or an optimizer's slot specs read)."""
        dev = resolve_device(device)
        if dev.type == "meta":
            with torch.device(dev):
                return self._init_tree(lambda shape, std=1.0: torch.empty(shape))
        gen = torch.Generator().manual_seed(seed)
        params = self._init_tree(lambda shape, std=1.0: torch.randn(shape, generator=gen) * std)
        return map_params(params, lambda t: t.to(dev))

    def _init_tree(self, normal) -> GPTLMParams:
        """:meth:`init`'s tree, ``normal(shape, std)`` drawing each random
        leaf in order."""
        d, n = self.model_dim, self.num_layers
        kvw = self.num_kv_heads * self.head_dim

        def dense(shape):
            return normal(shape) / shape[-2] ** 0.5

        attn = dict(
            ln1_scale=torch.ones(n, d),
            ln1_bias=torch.zeros(n, d),
            wq=dense((n, d, d)),
            wk=dense((n, d, kvw)),
            wv=dense((n, d, kvw)),
            wo=torch.zeros(n, d, d),
            ln2_scale=torch.ones(n, d),
            ln2_bias=torch.zeros(n, d),
        )
        if self.moe_experts is None:
            blocks = GPTBlockParams(
                **attn,
                w_up=dense((n, d, 4 * d)),
                b_up=torch.zeros(n, 4 * d),
                w_down=torch.zeros(n, 4 * d, d),
                b_down=torch.zeros(n, d),
            )
        else:
            e = self.moe_experts
            blocks = GPTMoEBlockParams(
                **attn,
                wg=dense((n, d, e)),
                w_up=dense((n, e, d, 4 * d)),
                b_up=torch.zeros(n, e, 4 * d),
                w_down=torch.zeros(n, e, 4 * d, d),
                b_down=torch.zeros(n, e, d),
            )
        pos = (
            normal((self.max_len, d), 0.02)
            if self.pos_embedding == "learned"
            else torch.zeros(self.max_len, d)
        )
        return GPTLMParams(
            embed=normal((self.vocab_size, d), 0.02),
            pos=pos,
            blocks=blocks,
            lnf_scale=torch.ones(d),
            lnf_bias=torch.zeros(d),
        )

    def serving_params(self, params: GPTLMParams) -> GPTLMParams:
        """The block projections pre-cast to the compute dtype, everything
        else (the MoE gate, ``QuantizedLinear`` leaves) as it was. Products
        cast their operands to the compute dtype anyway, so the math is
        unchanged; a server does this once instead of casting ~50 MB of
        weights per decoded token. Under ``matmul_dtype`` the projections
        stay as they are: ``quantized_dot`` scales the unrounded values."""
        if self.matmul_dtype is not None:
            return params
        cast = {nm: getattr(params.blocks, nm) for nm in PROJ_NAMES}
        blocks = params.blocks._replace(**{
            nm: w.to(self.compute_dtype) for nm, w in cast.items()
            if not isinstance(w, QuantizedLinear)})
        return params._replace(blocks=blocks)

    def decode_weights(self, params: GPTLMParams, dtype: str) -> GPTLMParams:
        """The decode projections quantized ONCE for weight-only serving
        (JAX ``decode_weights``, :548): the block q/k/v/out projections and,
        for dense blocks, the FFN pair become ``QuantizedLinear`` leaves
        (int8/fp8 codes, one f32 scale an output column), which
        :meth:`_dot` takes through ``wo_dot``. The logits head and the MoE
        experts (and their gate) stay full precision. A serving artifact:
        forward only, not a checkpoint."""
        if dtype not in MATMUL_DTYPES:
            raise ValueError(f"unknown decode weight dtype {dtype!r}; one of {MATMUL_DTYPES}")
        names = ("wq", "wk", "wv", "wo")
        if self.moe_experts is None:
            names += ("w_up", "w_down")
        repl = {nm: quantize_linear_columns(getattr(params.blocks, nm), dtype) for nm in names}
        return params._replace(blocks=params.blocks._replace(**repl))

    # -- tensor parallelism -------------------------------------------------

    def partition_specs(self, model_axis: str = "model") -> GPTLMParams:
        """Megatron's tensor-parallel layout over ``model_axis`` (the JAX
        ``partition_specs``; every block leaf keeps its leading num_layers
        dim whole): wq/wk/wv and w_up/b_up split on their output dim, wo
        and w_down on their input dim; embeddings, positions, norms and the
        residual-stream bias b_down replicated."""
        if self.moe_experts is not None:
            raise NotImplementedError(
                "tensor parallelism is not defined for the MoE blocks; "
                "use expert parallelism (apply_expert_parallel)")
        col, row = (None, None, model_axis), (None, model_axis, None)
        return GPTLMParams(
            embed=(), pos=(),
            blocks=GPTBlockParams(ln1_scale=(), ln1_bias=(), wq=col, wk=col, wv=col, wo=row,
                                  ln2_scale=(), ln2_bias=(), w_up=col, b_up=(None, model_axis),
                                  w_down=row, b_down=()),
            lnf_scale=(), lnf_bias=())

    def tp_unsupported_reason(self, size: int) -> str | None:
        """Why the port cannot split this model over a ``size``-way
        tensor-parallel axis, or None (the JAX package pads a dim the
        axis does not divide; the port refuses it)."""
        # The FFN's 4·model_dim splits wherever num_heads does.
        kvw = self.num_kv_heads * self.head_dim
        for what, n in (("num_heads", self.num_heads),
                        ("the KV columns (num_kv_heads·head_dim)", kvw)):
            if n % size:
                return (f"{what} = {n} does not split over a {size}-way tensor-parallel "
                        "axis (the JAX package pads it; the port needs the axis size to "
                        "divide it)")
        if self.matmul_dtype is not None:
            return (f"matmul_dtype={self.matmul_dtype!r}: the dynamic scales of a "
                    "row-parallel product span the whole contraction, which a rank does "
                    "not hold")
        return None

    def _kv_read(self, tp) -> list | None:
        """The KV heads this rank's query heads read when the
        tensor-parallel axis does not divide ``num_kv_heads`` (as a GQA
        group, or one a query head where the groups do not align); None
        when each rank holds its own KV heads."""
        if tp is None or self.num_kv_heads % tp.size == 0:
            return None
        hq, g = self.num_heads // tp.size, self.num_heads // self.num_kv_heads
        read = [(tp.index * hq + i) // g for i in range(hq)]
        heads = sorted(set(read))
        if hq % len(heads) or read != [h for h in heads for _ in range(hq // len(heads))]:
            return read
        return heads

    def _local_kv(self, tp, k, v):
        """k and v [B, L, ., Dh] for this rank's query heads: its own KV
        heads when the axis size divides ``num_kv_heads``; else k and v
        gathered whole over the axis and the heads :meth:`_kv_read` names
        kept."""
        b, l = k.shape[:2]
        heads = self._kv_read(tp)
        if heads is None:
            return (k.reshape(b, l, -1, self.head_dim), v.reshape(b, l, -1, self.head_dim))
        shape = (b, l, self.num_kv_heads, self.head_dim)
        k, v = tp.gather_from(k).reshape(shape), tp.gather_from(v).reshape(shape)
        idx = torch.tensor(heads, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)

    # -- shared pieces -----------------------------------------------------

    def _dot_full(self, x, w):
        """The compute-dtype product with f32 accumulation (the logits head,
        and every projection without ``matmul_dtype``)."""
        return dot(x, w, self.compute_dtype)

    def _dot(self, x, w):
        """A block projection: a ``QuantizedLinear`` leaf through
        ``wo_dot``, else ``quantized_dot`` under ``matmul_dtype``, else
        :meth:`_dot_full`."""
        if isinstance(w, QuantizedLinear):
            return wo_dot(x, w.qw, w.scale, self.compute_dtype)
        if self.matmul_dtype is None:
            return self._dot_full(x, w)
        return quantized_dot(self.matmul_dtype, x, w)

    @property
    def _block_cls(self):
        return GPTBlockParams if self.moe_experts is None else GPTMoEBlockParams

    def _attend(self, q, k, v, kv_lens=None):
        if self.attention_impl == "flash" and q.shape[1] >= resolve_flash_min_len(
                self.flash_min_len):
            return flash_attention(q, k, v, causal=True, window=self.window, kv_lens=kv_lens,
                                   fused=self.flash_fused)
        return dense_attention(q, k, v, causal=True, window=self.window, kv_lens=kv_lens)

    def _embed_tokens(self, params, tokens, positions):
        """Token embedding plus the learned position rows. Positions are
        clamped to the table (the JAX ``jnp.take`` never raises either);
        only rows the caller discards can reach the clamp."""
        if tokens.ndim > 1 and tokens.shape[1] > self.max_len:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds max_len {self.max_len}"
            )
        h = params.embed[tokens.long()]
        if self.pos_embedding == "learned":
            h = h + params.pos[positions.long().clamp(0, self.max_len - 1)]
        return h

    def _moe_capacity(self, tokens: int) -> int:
        """Static capacity an expert for a call routing ``tokens`` tokens
        (GShard: factor x k x tokens / experts, at least 1)."""
        return max(1, math.ceil(self.moe_capacity_factor * self.moe_top_k * tokens
                                / self.moe_experts))

    def _moe_block_ffn(self, blk, hn2, token_mask=None, moe=None):
        """The MoE FFN on hn2 [B, L, d]: tokens flattened and cast to the
        compute dtype with the experts' weights (the gate stays f32),
        routed by ``moe_ffn_local``, or by ``moe(params, x, capacity,
        token_mask) -> (out, aux)`` when given (the expert-parallel
        ``moe_ffn``). Capacity: every token for a single-token call (the
        decode step never drops), else the factor rule over this call's
        tokens. Returns (out [B, L, d] f32, the router's ``MoEAux``)."""
        cd = self.compute_dtype
        b, l, d = hn2.shape
        t = b * l
        capacity = t if l == 1 else self._moe_capacity(t)
        mp = MoEParams(blk.wg, blk.w_up.to(cd), blk.b_up.to(cd), blk.w_down.to(cd),
                       blk.b_down.to(cd))
        mask = None if token_mask is None else token_mask.reshape(t)
        x = hn2.reshape(t, d).to(cd)
        if moe is None:
            out, aux = moe_ffn_local(mp, x, capacity, with_aux=True, token_mask=mask,
                                     k=self.moe_top_k)
        else:
            out, aux = moe(mp, x, capacity, mask)
        return out.float().reshape(b, l, d), aux

    def _ffn(self, blk, hn2, token_mask=None, tp=None, moe=None):
        """The dense FFN, or the MoE FFN of a ``GPTMoEBlockParams`` block
        (through ``moe`` when given, :meth:`_moe_block_ffn`), on hn2
        [B, L, d], output bias included: (out, aux), aux the router's
        ``MoEAux`` (zeros for a dense block). ``token_mask`` [B, L] bool
        keeps pad tokens out of MoE routing. Under ``tp`` the dense FFN
        runs on this rank's units and sums over the axis before b_down."""
        if isinstance(blk, GPTMoEBlockParams):
            return self._moe_block_ffn(blk, hn2, token_mask, moe)
        if tp is not None:
            hn2 = tp.copy_to(hn2)
        up = self._dot(hn2, blk.w_up) + blk.b_up
        out = self._dot(F.gelu(up, approximate="tanh"), blk.w_down)
        if tp is not None:
            out = tp.reduce_from(out)
        return out + blk.b_down, MoEAux.zero(hn2.device)

    def _decode_ffn(self, h, w):
        """LN2, :meth:`_ffn` and the residual on one decode step's rows
        h [S, d] (``w``: one layer's block fields by name), for the plain
        decode of MoE and quantized models."""
        blk = self._block_cls(**{nm: w[nm] for nm in self._block_cls._fields})
        hn2 = layernorm(h, blk.ln2_scale, blk.ln2_bias)
        return h + self._ffn(blk, hn2[:, None])[0][:, 0]

    def _plain_fns(self, params):
        """The plain decode's products and FFN for a model outside the
        kernels' dense, compute-dtype weights (MoE, ``matmul_dtype``,
        ``QuantizedLinear`` leaves): this model's :meth:`_dot` and
        :meth:`_decode_ffn`; none (the kernels' plain versions as they are)
        otherwise."""
        if self._config_unsupported_reason() is None and \
                self._params_unsupported_reason(params) is None:
            return {}
        return dict(dot_fn=self._dot, ffn_fn=self._decode_ffn)

    def _block(self, blk, h, positions, kv_lens=None, attend=None, token_mask=None, tp=None,
               moe=None):
        """Block forward on h [B, L, d]: (h, this block's k/v [B, L, Hkv,
        Dh] (f32) for the cache, the FFN's ``MoEAux``). ``attend(q, k, v)``
        swaps the attention (the paged extend passes its own), ``moe`` the
        MoE FFN's routing (:meth:`_moe_block_ffn`); ``token_mask`` [B, L]
        keeps pads out of MoE routing. ``tp``
        (``ops/collectives.TensorParallel``): ``blk`` holds this rank's
        blocks of :meth:`partition_specs`, and the heads are its local
        ones (k/v those :meth:`_local_kv` keeps)."""
        b, l, d = h.shape
        hn = layernorm(h, blk.ln1_scale, blk.ln1_bias)
        if tp is not None:
            hn = tp.copy_to(hn)
        hq = self.num_heads // (1 if tp is None else tp.size)
        q = self._dot(hn, blk.wq).reshape(b, l, hq, self.head_dim)
        k, v = self._local_kv(tp, self._dot(hn, blk.wk), self._dot(hn, blk.wv))
        if self.pos_embedding == "rope":
            q, k = rope(q, positions), rope(k, positions)
        attn = attend(q, k, v) if attend else self._attend(q, k, v, kv_lens)
        out = self._dot(attn.reshape(b, l, hq * self.head_dim), blk.wo)
        h = h + (out if tp is None else tp.reduce_from(out))
        hn2 = layernorm(h, blk.ln2_scale, blk.ln2_bias)
        out, aux = self._ffn(blk, hn2, token_mask, tp, moe)
        return h + out, (k, v), aux

    def _logits(self, p: GPTLMParams, h):
        hf = layernorm(h, p.lnf_scale, p.lnf_bias)
        return self._dot_full(hf, p.embed.T)

    def _block_h(self, h, positions, token_mask, *blk, tp=None, moe=None):
        """:meth:`_block`'s residual stream and router statistics, on the
        block's tensors as arguments (what ``torch.utils.checkpoint``
        wraps)."""
        h, _, aux = self._block(self._block_cls(*blk), h, positions, token_mask=token_mask,
                                tp=tp, moe=moe)
        return h, aux

    # -- training forward --------------------------------------------------

    def apply(self, params: GPTLMParams, tokens: torch.Tensor, tp=None) -> torch.Tensor:
        """tokens [B, L] int → logits [B, L, vocab] f32, causal (on the
        :meth:`partition_specs` blocks over ``tp`` when given)."""
        return self.apply_with_aux(params, tokens, tp=tp)[0]

    def apply_with_aux(self, params: GPTLMParams, tokens: torch.Tensor, lengths=None, tp=None):
        """:meth:`apply` and the router statistics of every layer (a
        ``MoEAux`` of [num_layers] tensors; zeros for a dense model).
        ``lengths`` [B] (ragged right-padded batches) keeps pad tokens out
        of MoE routing, its capacity and the statistics. ``tp``: the
        tensor-parallel axis of a ``partition_specs`` layout."""
        return self._forward(params, tokens, lengths, tp=tp)

    def _forward(self, params, tokens, lengths=None, tp=None, moe=None):
        """:meth:`apply_with_aux`'s loop over the layers (each checkpointed
        under ``remat``), the MoE FFN routed by ``moe`` when given."""
        l = tokens.shape[1]
        positions = torch.arange(l, device=tokens.device)
        token_mask = (None if lengths is None
                      else positions[None, :] < lengths.to(tokens.device)[:, None])
        h = self._embed_tokens(params, tokens, positions)
        kw = self._checkpoint_kw()
        body = functools.partial(self._block_h, tp=tp, moe=moe)
        auxs = []
        for i in range(self.num_layers):
            blk = layer_params(params.blocks, i)
            if kw is None:
                h, aux = body(h, positions, token_mask, *blk)
            else:
                h, aux = checkpoint(body, h, positions, token_mask, *blk,
                                    use_reentrant=False, **kw)
            auxs.append(aux)
        return self._logits(params, h), MoEAux(*(torch.stack(a) for a in zip(*auxs)))

    def _checkpoint_kw(self):
        """``torch.utils.checkpoint`` arguments for the ``remat`` knob, or
        None without remat. "selective" and a callable policy run under
        ``create_selective_checkpoint_contexts``: "selective" saves the
        flash operator (``ops/flash_attention.selective_policy``), so the
        recompute skips the forward kernel; on the dense path it saves
        nothing and equals plain remat, as in the JAX package."""
        if not self.remat:
            return None
        if self.remat is True:
            return {}
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        policy = selective_policy if self.remat == "selective" else self.remat
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts, policy)}

    def loss(self, params: GPTLMParams, tokens: torch.Tensor, lengths=None,
             tp=None) -> torch.Tensor:
        """Training loss: mean next-token cross-entropy (positions 0..L-2
        predict 1..L-1, f32), masked to targets at positions < lengths[b]
        when ``lengths`` [B] is given (ragged right-padded batches; causal
        attention keeps pads out of real positions, ``lengths`` keeps them
        out of MoE routing), plus for MoE models the router's balance and
        z losses (:meth:`loss_and_metrics`). ``tp``: as :meth:`apply`."""
        return self.loss_and_metrics(params, tokens, lengths, tp)[0]

    def loss_and_metrics(self, params: GPTLMParams, tokens: torch.Tensor, lengths=None,
                         tp=None):
        """(total loss, metrics): ``ce`` always; MoE models add the layer
        means ``balance_loss`` and ``z_loss`` (in the total, behind
        ``moe_balance_coef`` / ``moe_z_coef``), ``drop_fraction`` (a
        metric only) and ``expert_fraction`` [E] (layer mean)."""
        logits, auxs = self.apply_with_aux(params, tokens, lengths, tp)
        ce = ce_from_logits(logits, tokens, lengths)
        metrics = {"ce": ce}
        if self.moe_experts is None:
            return ce, metrics
        balance, z = auxs.balance_loss.mean(), auxs.z_loss.mean()
        metrics.update(balance_loss=balance, z_loss=z, drop_fraction=auxs.drop_fraction.mean(),
                       expert_fraction=auxs.expert_fraction.mean(0))
        return ce + self.moe_balance_coef * balance + self.moe_z_coef * z, metrics

    # -- sequence parallelism ----------------------------------------------

    def apply_sequence_parallel(self, params: GPTLMParams, tokens: torch.Tensor, mesh,
                                axis: str = "seq", *, attention: str | None = None,
                                tp_axis: str | None = None):
        """The sequence-parallel causal forward on this rank's shard
        tokens [B, L/n] of a sequence split over ``axis`` of ``mesh`` (n
        ranks, params replicated): this shard's logits [B, L/n, vocab],
        equal to the matching slice of :meth:`apply` on the whole
        sequence. ``attention`` is ``"ring"``, ``"ring_flash"`` or
        ``"ulysses"`` (``ops/ring_attention.py``); the default follows
        ``attention_impl`` at the shard's length against
        ``flash_min_len``. Under GQA the KV blocks ride the ring at
        ``num_kv_heads``; a windowed model's ring runs only the band's
        hops. Ulysses needs the axis size to divide both head counts.
        ``tp_axis`` (the dp×tp×sp form): ``params`` are this rank's blocks of
        :meth:`partition_specs` over that axis of the mesh, and the ring
        runs on the local heads. A collective: every rank of the axes calls
        it."""
        if self.moe_experts is not None:
            raise NotImplementedError(
                "MoE blocks are not supported on the sequence-parallel "
                "path; use apply_expert_parallel")
        from distributed_tensorflow_tpu_torch.ops.ring_attention import (
            ring_attention,
            ring_flash_attention,
            ulysses_attention,
        )

        if attention is not None and attention not in ("ring", "ring_flash", "ulysses"):
            raise ValueError(f"unknown attention {attention!r}; ring|ring_flash|ulysses")
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        tp = None if tp_axis is None else TensorParallel(mesh, tp_axis)
        b, l_loc = tokens.shape
        if attention is None:
            attention = ("ring_flash" if self.attention_impl == "flash"
                         and l_loc >= resolve_flash_min_len(self.flash_min_len) else "ring")
        if n * l_loc > self.max_len:
            raise ValueError(f"global sequence {n * l_loc} exceeds max_len {self.max_len}")
        t, read = (1 if tp is None else tp.size), self._kv_read(tp)
        heads, kv_heads = self.num_heads // t, self.num_kv_heads // t if read is None else len(read)
        if attention == "ulysses" and (heads % n or kv_heads % n):
            raise ValueError(
                f"ulysses needs heads ({heads}) and kv heads "
                f"({kv_heads}) divisible by the axis size {n}")
        positions = my * l_loc + torch.arange(l_loc, device=tokens.device)
        h = self._embed_tokens(params, tokens, positions)
        if attention == "ulysses":
            def sp_attend(q, k, v):
                return ulysses_attention(q, k, v, mesh, axis, causal=True, window=self.window)
        elif attention == "ring":
            def sp_attend(q, k, v):
                return ring_attention(q, k, v, mesh, axis, causal=True, window=self.window)
        else:
            def sp_attend(q, k, v):
                return ring_flash_attention(q, k, v, mesh, axis, causal=True,
                                            window=self.window, fused=self.flash_fused)

        def body(h, *blk):
            return self._block(self._block_cls(*blk), h, positions, attend=sp_attend, tp=tp)[0]

        kw = self._checkpoint_kw()
        for i in range(self.num_layers):
            blk = layer_params(params.blocks, i)
            h = (body(h, *blk) if kw is None
                 else checkpoint(body, h, *blk, use_reentrant=False, **kw))
        return self._logits(params, h)

    # -- expert parallelism --------------------------------------------------

    def apply_expert_parallel(self, params: GPTLMParams, tokens: torch.Tensor, mesh,
                              axis: str = "expert", *, with_aux: bool = False, lengths=None):
        """The expert-parallel causal forward (JAX ``apply_expert_parallel``)
        on this rank's batch shard tokens [B/n, L]: ``params`` are this
        rank's blocks of :func:`expert_parallel_specs` over ``axis`` of
        ``mesh`` (one expert's FFN weights a rank; the gate, attention and
        embeddings replicated). Attention runs locally on the shard (the
        flash kernels under ``attention_impl="flash"``); each block's FFN
        is ``ops/moe.moe_ffn``'s exchange over the axis. Capacity holds per
        (expert, source rank), so this equals :meth:`apply` on the shard
        wherever no dispatch overflows. ``with_aux`` also returns each
        layer's ``MoEAux`` over this rank's tokens; ``lengths`` [B/n] keeps
        pad tokens out of routing, as :meth:`apply_with_aux` does. A
        collective: every rank of the axis calls it."""
        if self.moe_experts is None:
            raise ValueError("apply_expert_parallel requires moe_experts")
        n = mesh.axis_size(axis)
        if n != self.moe_experts:
            raise ValueError(f"{axis!r} axis size {n} != moe_experts {self.moe_experts}")
        from distributed_tensorflow_tpu_torch.ops.moe import moe_ffn

        def ep_moe(mp, x, capacity, mask):
            return moe_ffn(mp, x, mesh, axis, capacity, with_aux=True, token_mask=mask,
                           k=self.moe_top_k)

        logits, auxs = self._forward(params, tokens, lengths, moe=ep_moe)
        return (logits, auxs) if with_aux else logits

    # -- pipeline parallelism ------------------------------------------------

    def pipeline_stage_blocks(self, blocks, num_stages: int):
        """The [num_layers, ...] block stack as [num_stages,
        layers_per_stage, ...] (JAX ``pipeline_stage_blocks``): stage s holds
        layers s·L/S .. (s+1)·L/S − 1, the layout split over the stage axis
        on its leading dim."""
        if self.num_layers % num_stages:
            raise ValueError(
                f"num_layers {self.num_layers} not divisible by num_stages {num_stages}")
        lps = self.num_layers // num_stages
        return tree_map(lambda a: a.reshape((num_stages, lps) + tuple(a.shape[1:])), blocks)

    def _pp_stage_fn(self):
        """One pipeline stage's forward, the one stage body of
        :meth:`apply_pipeline_parallel` and :func:`make_lm_pp_parts`:
        ``stage_fn(blk_stack, x)`` runs the stage's layer group ([1,
        layers_per_stage, ...] leaves) on x [b, L, d] as :meth:`apply` runs
        its layers, the whole group under one ``torch.utils.checkpoint``
        when ``remat`` (``"selective"`` as :meth:`_checkpoint_kw` gives it),
        so the backward recomputes one group a tick."""
        kw = self._checkpoint_kw()

        def group(x, *leaves):
            positions = torch.arange(x.shape[1], device=x.device)
            stack = layer_params(self._block_cls(*leaves), 0)
            for i in range(stack[0].shape[0]):
                x = self._block(layer_params(stack, i), x, positions)[0]
            return x

        def stage_fn(blk_stack, x):
            if kw is None:
                return group(x, *blk_stack)
            return checkpoint(group, x, *blk_stack, use_reentrant=False, **kw)

        return stage_fn

    def apply_pipeline_parallel(self, params: GPTLMParams, tokens: torch.Tensor, mesh,
                                axis: str = "stage", *, num_microbatches: int = 4):
        """The pipeline-parallel causal forward (JAX
        ``apply_pipeline_parallel``): ``params.blocks`` are this rank's stage
        of :meth:`pipeline_stage_blocks` ([1, L/S, ...] leaves, split over
        ``axis`` of ``mesh``); embeddings, the final norm and tokens [B, L]
        the same on every rank. Embedding and head run on every stage; the
        blocks run as the GPipe pipeline of ``parallel/pipeline.py`` over
        ``num_microbatches`` microbatches. Returns logits [B, L, vocab],
        :meth:`apply`'s, on every rank. A collective of the axis."""
        if self.moe_experts is not None:
            raise NotImplementedError(
                "pipeline parallelism is not defined for MoE blocks; use "
                "expert parallelism (apply_expert_parallel)")
        from distributed_tensorflow_tpu_torch.parallel.pipeline import (
            microbatch,
            pipeline_apply,
        )

        b, l = tokens.shape
        h = self._embed_tokens(params, tokens, torch.arange(l, device=tokens.device))
        out = pipeline_apply(self._pp_stage_fn(), params.blocks, microbatch(h, num_microbatches),
                             mesh, axis)
        return self._logits(params, out.reshape(b, l, -1))

    # -- slot-wise decoding (the serving surface, serve.py) ----------------

    @property
    def cache_len(self) -> int:
        """Static KV-cache length per layer: ``min(window, max_len)`` for
        windowed models (a rolling buffer: older keys are outside every
        query's band), else ``max_len``."""
        if self.window is not None:
            return min(self.window, self.max_len)
        return self.max_len

    def _kv_arrays(self, shape, kv_dtype: str, dev):
        """Zero K/V payloads of ``shape`` in the ``kv_dtype`` storage and
        their scales (shape without ``Dh``; None for "bf16")."""
        z = lambda: torch.zeros(  # noqa: E731
            shape, dtype=kv_storage_dtype(kv_dtype, self.compute_dtype), device=dev)
        if kv_dtype == "bf16":
            return z(), z(), None, None
        sc = lambda: torch.zeros(shape[:-1], dtype=torch.float32, device=dev)  # noqa: E731
        return z(), z(), sc(), sc()

    def empty_slot_cache(self, slots: int, kv_dtype: str = "bf16", *,
                         device=None) -> SlotKVCache:
        """A vacant ``slots``-row cache (lengths all zero = free). The
        "bf16" layout stores the compute dtype, as in the JAX package;
        "int8"/"fp8" store 1-byte codes plus the per-row scales."""
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        dev = resolve_device(device)
        shape = (self.num_layers, slots, self.cache_len, self.num_kv_heads,
                 self.head_dim)
        k, v, ks, vs = self._kv_arrays(shape, kv_dtype, dev)
        return SlotKVCache(k=k, v=v, lengths=torch.zeros(slots, dtype=torch.int32, device=dev),
                           k_scale=ks, v_scale=vs)

    def reset_slots(self, cache: SlotKVCache, free: torch.Tensor) -> SlotKVCache:
        """Mark slots free (``free`` [S] bool): their lengths drop to 0; the
        stale K/V bytes stay and are unreachable past ``lengths``."""
        return cache._replace(
            lengths=torch.where(free, torch.zeros_like(cache.lengths), cache.lengths)
        )

    def _attended(self, x, cache):
        """Fresh K/V rows as a later read of ``cache`` attends them (JAX
        ``prefill_slots`` / ``extend_paged``): through a 1-byte cache's
        quantizer, dequantized to the compute dtype (in ``x``'s dtype);
        ``x`` itself for the bf16 layout."""
        if kv_quant_dtype(cache.k.dtype) is None:
            return x
        return as_stored(x, cache.k.dtype, self.compute_dtype)[2].to(x.dtype)

    def _stored(self, ks, vs, cache):
        """Stacked fresh K/V [n, S, L, Hkv, Dh] as ``cache`` stores them:
        (k, v, k_scale, v_scale), scales None for the bf16 layout."""
        (kq, ksc, _), (vq, vsc, _) = (as_stored(x, cache.k.dtype, self.compute_dtype)
                                      for x in (ks, vs))
        return kq, vq, ksc, vsc

    def prefill_slots(self, params, cache: SlotKVCache, tokens, lengths, admit):
        """Batched ragged prefill INTO slots: run the right-padded prompt
        block [S, L] (real lengths [S], each ≥ 1) once and, for rows with
        ``admit`` True, replace the slot's cache rows (positions ≥ L zeroed)
        and its length; other rows keep their state bit for bit. A quantized
        cache stores codes and scales, and the prompt attends its own K/V as
        stored. A windowed model keeps each row's last ``cache_len`` prompt
        positions at slots ``p % cache_len``. Returns (logits at each row's
        last real position [S, vocab], the cache — its tensors updated in
        place)."""
        s, l = tokens.shape
        c = self.cache_len
        if l > (self.max_len if self.window is not None else c):
            raise ValueError(f"prompt block {l} exceeds the cache length {c}")
        qd = kv_quant_dtype(cache.k.dtype)

        def attend(q, k, v):
            return self._attend(q, self._attended(k, cache), self._attended(v, cache),
                                kv_lens=lengths)

        positions = torch.arange(l, device=tokens.device)
        token_mask = positions[None, :] < lengths[:, None]
        h = self._embed_tokens(params, tokens, positions)
        ks, vs = [], []
        for i in range(self.num_layers):
            h, (k, v), _ = self._block(layer_params(params.blocks, i), h, positions,
                                       kv_lens=lengths, attend=attend if qd else None,
                                       token_mask=token_mask)
            ks.append(k)
            vs.append(v)
        stored = self._stored(torch.stack(ks), torch.stack(vs), cache)
        for dst, src in zip((cache.k, cache.v, cache.k_scale, cache.v_scale), stored):
            if dst is not None:  # [n, S, L, ...] padded or rolled to [n, S, C, ...]
                if l > c:
                    new = movable(rolling_layout(src.to(dst.dtype), lengths, c))
                else:
                    new = F.pad(movable(src.to(dst.dtype)), (0, 0) * (src.dim() - 3) + (0, c - l))
                m = admit.bool().reshape(1, -1, *([1] * (src.dim() - 2)))
                movable(dst).copy_(torch.where(m, new, movable(dst)))
        cache.lengths.copy_(
            torch.where(admit.bool(), lengths.to(cache.lengths.dtype), cache.lengths)
        )
        rows = torch.arange(s, device=h.device)
        h_last = h[rows, (lengths.long() - 1).clamp(min=0)]
        return self._logits(params, h_last), cache

    def _config_unsupported_reason(self) -> str | None:
        """The JAX package's config reasons (``models/gpt.py:1137-1148``)
        why no decode kernel serves this model: MoE blocks, or
        ``matmul_dtype`` projections; None otherwise."""
        if self.moe_experts is not None:
            return ("MoE blocks route through ops/moe (expert dispatch is not a single-launch "
                    "shape); serve MoE models on the XLA engine")
        if self.matmul_dtype is not None:
            return ("matmul_dtype projections route through ops/quantized.quantized_dot; the "
                    "fused kernel runs compute-dtype weights only")
        return None

    @staticmethod
    def _params_unsupported_reason(params) -> str | None:
        """The JAX package's params reason (``models/gpt.py:1186-1194``):
        weight-only quantized projections (``QuantizedLinear`` leaves)."""
        if params is not None and any(
                isinstance(getattr(params.blocks, nm, None), QuantizedLinear)
                for nm in PROJ_NAMES):
            return ("weight-only quantized decode params (QuantizedLinear leaves from "
                    "decode_weights) route through wo_dot; the fused kernels run compute-dtype "
                    "weights only")
        return None

    def _resolve_decode_engine(self, engine: str | None, params=None) -> str:
        """The per-call override (None → the model's knob) resolved to
        "fused", "fused-layer" or "xla". A MoE or ``matmul_dtype`` model,
        or ``params`` with ``QuantizedLinear`` leaves, is outside the
        kernels: "fused" and "fused-layer" raise with the JAX package's
        reason and "auto" resolves to "xla", as JAX's does (:1201-1203).
        Otherwise "auto" is the megakernel, on any device: on the card it
        launches or raises for a shape the kernels do not take (a head dim
        they are not built for), and never becomes "xla" (the JAX package's
        off-TPU "auto" does). "xla" — the plain decode on whatever device
        the tensors are on — runs when named or resolved so. On the CPU
        every engine runs the plain versions."""
        e = self.decode_engine if engine is None else engine
        if e not in DECODE_ENGINES:
            raise ValueError(f"unknown decode engine {e!r}; one of {DECODE_ENGINES}")
        if e == "xla":
            return e
        reason = self._config_unsupported_reason() or self._params_unsupported_reason(params)
        if e == "auto":
            return "xla" if reason else "fused"
        if reason is not None:
            raise ValueError(f"decode_engine={e!r} unsupported: {reason}")
        return e

    def _decode_unsupported_reason(self, *, slots: int, rows: int = 1,
                                   block_size: int | None = None, kv_dtype: str = "bf16",
                                   nsm: int, smem_limit: int) -> str | None:
        """Why the CUDA decode kernels cannot serve this model, or None when
        they can: the port's counterpart of the JAX
        ``_decode_unsupported_reason`` (``models/gpt.py:1129``), with the
        port's envelope: first the JAX config reasons (MoE blocks,
        ``matmul_dtype``), then the slot planner's. ``slots`` slots of
        ``rows`` rows each (1 for the
        decode step, ``spec_draft + 1`` for the verify) over the slab's
        ``cache_len`` positions, or (``block_size``) the pool's
        ``paged_blocks_per_slot(block_size) · block_size``, in the model's
        compute dtype (bf16 or f32) over a ``kv_dtype`` cache, on a card of
        ``nsm`` SMs with ``smem_limit`` bytes of shared memory a block: the
        slot planner's answer (``ops/fused_decode.slot_group``: the head
        dims the kernels take, the rows a launch takes at these widths,
        shared memory at the compute dtype's element size). The JAX
        engine's 8 MiB VMEM cap a layer is the TPU's and has no counterpart
        here. Pure Python, so a test pins it on the CPU with the H100's
        figures."""
        reason = self._config_unsupported_reason()
        if reason is not None:
            return reason
        if block_size is None:
            mb, c = 0, self.cache_len
        else:
            mb = self.paged_blocks_per_slot(block_size)
            c = mb * block_size
        nbytes = dict(w_bytes=torch.empty((), dtype=self.compute_dtype).element_size(),
                      kv_bytes=kv_elem_bytes(kv_dtype, self.compute_dtype))
        try:
            slot_group(slots, rows, self.model_dim, self.num_heads, self.num_kv_heads,
                       self.head_dim, 4 * self.model_dim, c, mb, nsm, smem_limit, **nbytes)
        except ValueError as e:
            return str(e)
        return None

    def decode_slots(self, params, token, cache: SlotKVCache, active=None, *,
                     engine: str | None = None):
        """Append one token per slot: token [S] int at each slot's own
        position. Returns (logits [S, vocab] f32, cache with ``lengths``
        advanced where active). Inactive rows are not written and their
        logits are garbage to discard. Stepping an active row past
        ``max_len`` would corrupt it, so CPU tensors raise "KV cache full"
        as the JAX package's eager calls do; on the card callers bound
        their own trip count as the server does (no per-token host sync)."""
        s = token.shape[0]
        act = (
            torch.ones(s, dtype=torch.bool, device=token.device)
            if active is None
            else active.bool()
        )
        if not token.is_cuda:
            self._refuse_full_cache(cache.lengths, act)
        h = self._embed_tokens(params, token[:, None], cache.lengths[:, None])[:, 0]
        kw = self._kernel_kw()
        eng = self._resolve_decode_engine(engine, params)
        if eng == "fused-layer":
            for i in range(self.num_layers):
                weights = {nm: getattr(params.blocks, nm)[i] for nm in WEIGHT_NAMES}
                ks, vs = _scales(cache, i)
                h, kq, vq, kqs, vqs = decode_block_slab(
                    h, weights, cache.k[i], cache.v[i], cache.lengths, **kw, k_scale=ks,
                    v_scale=vs)
                commit_slot_rows(cache.k[i], cache.v[i], kq, vq, cache.lengths, act, ks, vs,
                                 kqs, vqs, self.window)
        elif eng == "fused":
            weights = {nm: getattr(params.blocks, nm) for nm in WEIGHT_NAMES}
            ks, vs = _scales(cache)
            h, _, _ = decode_token_slab(h, weights, cache.k, cache.v, cache.lengths, act, **kw,
                                        k_scale=ks, v_scale=vs)
        else:
            ks, vs = _scales(cache)
            h, _, _ = decode_token_slab_plain(h, params.blocks._asdict(), cache.k, cache.v,
                                              cache.lengths, act, **kw, k_scale=ks, v_scale=vs,
                                              **self._plain_fns(params))
        new_cache = cache._replace(lengths=cache.lengths + act.to(cache.lengths.dtype))
        return self._logits(params, h), new_cache

    def _refuse_full_cache(self, lengths, act) -> None:
        """JAX's eager "KV cache full" check: raise when an active slot is
        already at ``max_len``."""
        if bool(act.any()):
            worst = int(torch.where(act, lengths, 0).max())
            if worst >= self.max_len:
                raise ValueError(
                    f"KV cache full: an active slot is at length {worst} == "
                    f"max_len {self.max_len}; increase max_len"
                )

    # -- single-sequence decoding (prefill / decode_step and the loops) ----

    def prefill(self, params, tokens) -> tuple[torch.Tensor, KVCache]:
        """Run the prompt [B, L] once: (last-position logits [B, vocab], a
        :class:`KVCache` holding every layer's prompt K/V). A windowed
        model keeps the last ``cache_len`` prompt positions, each at slot
        ``pos % cache_len``: the rolling layout :meth:`decode_step`
        writes."""
        b, l = tokens.shape
        c = self.cache_len
        if l > (self.max_len if self.window is not None else c):
            raise ValueError(f"prompt length {l} exceeds the cache length {c}")
        positions = torch.arange(l, device=tokens.device)
        h = self._embed_tokens(params, tokens, positions)
        ks, vs = [], []
        for i in range(self.num_layers):
            h, (k, v), _ = self._block(layer_params(params.blocks, i), h, positions)
            ks.append(k)
            vs.append(v)
        ks = torch.stack(ks).to(self.compute_dtype)
        vs = torch.stack(vs).to(self.compute_dtype)
        if l <= c:
            pad = (0, 0, 0, 0, 0, c - l)
            ck, cv = F.pad(ks, pad), F.pad(vs, pad)
        else:
            lens = torch.full((b,), l, device=tokens.device)
            ck, cv = rolling_layout(ks, lens, c), rolling_layout(vs, lens, c)
        return self._logits(params, h)[:, -1], KVCache(k=ck, v=cv, length=l)

    def decode_step(self, params, token, cache: KVCache, *, engine: str | None = None):
        """Append one token [B] at the shared position ``cache.length``:
        (logits [B, vocab] f32, the cache, its tensors updated in place).
        "fused" is B6 over the B rows at one length, "fused-layer" B5 and
        the commit a layer, "xla" the plain decode. Raises "KV cache full"
        at ``max_len`` (stepping past it would corrupt the last row)."""
        if cache.length >= self.max_len:
            raise ValueError(
                f"KV cache full: length {cache.length} == max_len {self.max_len}; "
                "increase max_len"
            )
        b = token.shape[0]
        dev = token.device
        lengths = torch.full((b,), cache.length, dtype=torch.int32, device=dev)
        act = torch.ones(b, dtype=torch.bool, device=dev)
        logits, _ = self.decode_slots(params, token, SlotKVCache(cache.k, cache.v, lengths), act,
                                      engine=engine)
        return logits, cache._replace(length=cache.length + 1)

    def _check_decode_bounds(self, prompt, max_new):
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.shape[1] + max_new > self.max_len:
            raise ValueError(
                f"prompt {prompt.shape[1]} + max_new {max_new} exceeds max_len {self.max_len}"
            )

    def _decode_loop(self, params, prompt, max_new, pick, engine=None):
        """Prefill, then ``max_new - 1`` decode steps, each next token
        ``pick(logits)``. Returns [B, L0 + max_new]."""
        self._check_decode_bounds(prompt, max_new)
        logits, cache = self.prefill(params, prompt)
        out = [pick(logits)]
        for _ in range(max_new - 1):
            logits, cache = self.decode_step(params, out[-1], cache, engine=engine)
            out.append(pick(logits))
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

    def greedy_decode(self, params, prompt, max_new: int, *, engine: str | None = None):
        """[B, L0] prompt → [B, L0 + max_new], each token the argmax."""
        return self._decode_loop(params, prompt, max_new,
                                 lambda lg: lg.argmax(-1).to(prompt.dtype), engine)

    def sample_decode(self, params, prompt, max_new: int, generator: torch.Generator, *,
                      temperature: float = 1.0, top_k: int | None = None,
                      top_p: float | None = None, engine: str | None = None):
        """Sampling from ``logits / temperature`` within :func:`filter_logits`'
        ``top_k`` / ``top_p`` truncation, the draws from ``generator`` (on the
        prompt's device): one uniform row a token, Gumbel-max. ``top_k=1`` is
        greedy. The bits differ from the JAX package's PRNG."""
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        if top_k is not None and not 1 <= top_k <= self.vocab_size:
            raise ValueError(f"top_k must be in [1, {self.vocab_size}], got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")

        def pick(logits):
            lt = filter_logits(logits, temperature, top_k, top_p)
            u = torch.rand(lt.shape, generator=generator, device=lt.device)
            return torch.argmax(lt - torch.log(-torch.log(u)), dim=-1).to(prompt.dtype)

        return self._decode_loop(params, prompt, max_new, pick, engine)

    def beam_decode(self, params, prompt, max_new: int, beam_size: int, *,
                    eos_id: int | None = None, length_penalty: float = 0.0,
                    engine: str | None = None):
        """Beam search over the KV cache (JAX ``beam_decode``): the
        ``beam_size`` best summed log-probabilities kept each step, all beams
        decoded as one batch of B·K rows, reordered by gathering the cache's
        batch rows. A beam that emits ``eos_id`` extends only with EOS at
        zero cost; final beams rank by ``score / len_gen ** length_penalty``.
        Returns the best beam a row, [B, L0 + max_new]."""
        b, _ = prompt.shape
        kb = beam_size
        self._check_decode_bounds(prompt, max_new)
        if not 1 <= kb <= self.vocab_size:
            raise ValueError(f"beam_size must be in [1, {self.vocab_size}], got {kb}")
        if eos_id is not None and not 0 <= eos_id < self.vocab_size:
            raise ValueError(f"eos_id must be in [0, {self.vocab_size}), got {eos_id}")
        v, dev = self.vocab_size, prompt.device
        logits, cache = self.prefill(params, prompt)
        scores, tok = torch.topk(torch.log_softmax(logits.float(), -1), kb)  # [B, K]
        tok = tok.to(prompt.dtype)
        cache = cache._replace(k=cache.k.repeat_interleave(kb, dim=1),
                               v=cache.v.repeat_interleave(kb, dim=1))
        seqs = [tok]
        finished = (tok == eos_id) if eos_id is not None else torch.zeros_like(tok, dtype=torch.bool)
        only_eos = None
        if eos_id is not None:
            only_eos = torch.full((v,), float("-inf"), device=dev)
            only_eos[eos_id] = 0.0
        for _ in range(1, max_new):
            step_logits, cache = self.decode_step(params, tok.reshape(b * kb), cache,
                                                  engine=engine)
            logp = torch.log_softmax(step_logits.float(), -1).reshape(b, kb, v)
            if eos_id is not None:
                logp = torch.where(finished[..., None], only_eos, logp)
            scores, idx = torch.topk((scores[..., None] + logp).reshape(b, kb * v), kb)
            parent = idx // v
            tok = (idx % v).to(prompt.dtype)
            flat = (torch.arange(b, device=dev)[:, None] * kb + parent).reshape(-1)
            cache = cache._replace(k=cache.k[:, flat], v=cache.v[:, flat])
            seqs = [s.gather(1, parent) for s in seqs] + [tok]
            finished = finished.gather(1, parent)
            if eos_id is not None:
                finished = finished | (tok == eos_id)
        seqs = torch.stack(seqs, dim=-1)  # [B, K, max_new]
        if eos_id is not None and length_penalty != 0.0:
            is_eos = seqs == eos_id
            first_eos = is_eos.int().argmax(-1)
            gen_len = torch.where(is_eos.any(-1), first_eos + 1,
                                  torch.full_like(first_eos, max_new))
        else:
            gen_len = torch.full((b, kb), max_new, device=dev)
        ranked = scores / gen_len.float().clamp(min=1.0) ** length_penalty
        best = ranked.argmax(-1)
        return torch.cat([prompt, seqs[torch.arange(b, device=dev), best]], dim=1)

    # -- paged decoding (block-table cache, serve.py paged=True) -----------

    def _kernel_kw(self):
        return dict(num_heads=self.num_heads, rope=self.pos_embedding == "rope",
                    compute_dtype=self.compute_dtype, window=self.window)

    def paged_blocks_per_slot(self, block_size: int) -> int:
        """Block-table width: blocks to address ``max_len`` positions (the
        table is sized for the worst request; the POOL is what paging
        shrinks). A windowed model's pool keeps full history too: it
        addresses absolutely and masks the band."""
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        return -(-self.max_len // block_size)

    def empty_paged_cache(self, slots: int, num_blocks: int, block_size: int = 16,
                          kv_dtype: str = "bf16", *, device=None) -> PagedKVCache:
        """A vacant :class:`PagedKVCache`: ``num_blocks`` pool blocks of
        ``block_size`` positions in the compute dtype ("bf16"), or 1-byte
        codes with scale pools ("int8"/"fp8"), all-zero block tables
        (unreachable while lengths are 0)."""
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        dev = resolve_device(device)
        shape = (self.num_layers, num_blocks, block_size, self.num_kv_heads,
                 self.head_dim)
        k, v, ks, vs = self._kv_arrays(shape, kv_dtype, dev)
        return PagedKVCache(
            k=k, v=v,
            block_tables=torch.zeros(
                (slots, self.paged_blocks_per_slot(block_size)), dtype=torch.int32,
                device=dev),
            lengths=torch.zeros(slots, dtype=torch.int32, device=dev),
            k_scale=ks, v_scale=vs,
        )

    def extend_paged(self, params, cache: PagedKVCache, tokens, suffix_lens,
                     prefix_lens, admit):
        """Batched ragged EXTEND through the block tables: the suffix block
        ``tokens`` [S, L] (right-padded, real lengths ``suffix_lens``) at
        absolute positions ``prefix_lens[s] + 0..L-1``, each query over the
        slot's cached prefix (read through its table; dequantized to the
        compute dtype for a 1-byte pool) plus the suffix itself causally
        (as stored: quantized and dequantized for a 1-byte pool); the suffix
        K/V (and scales) are scattered into the pool where ``token_mask &
        admit``, in place. Returns (per-position logits [S, L, vocab], the
        cache). ``lengths``/``block_tables`` stay the caller's: admission
        commits ``prefix + suffix``, the speculative verify only the emitted
        tokens. The caller guarantees every written position lies in the
        slot's reserved blocks."""
        s, l = tokens.shape
        dev = tokens.device
        positions = prefix_lens.long()[:, None] + torch.arange(l, device=dev)[None, :]
        token_mask = torch.arange(l, device=dev)[None, :] < suffix_lens[:, None]
        h = self._embed_tokens(params, tokens, positions)
        tables = cache.block_tables
        ks, vs = [], []
        for i in range(self.num_layers):
            kview, vview = (
                gather_block_view(p[i], tables) if sc is None else dequantize_kv(
                    gather_block_view(p[i], tables), gather_block_view(sc[i], tables),
                    self.compute_dtype)
                for p, sc in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)))

            def attend(q, k, v, kview=kview, vview=vview):
                return paged_extend_attention(
                    q, self._attended(k, cache), self._attended(v, cache), kview, vview,
                    positions, prefix_lens, suffix_lens, self.window,
                )

            h, (k, v), _ = self._block(
                layer_params(params.blocks, i), h, positions, attend=attend,
                token_mask=token_mask,
            )
            ks.append(k)
            vs.append(v)
        valid = token_mask & admit.bool()[:, None]
        stored = self._stored(torch.stack(ks), torch.stack(vs), cache)
        pairs = [(d, s) for d, s in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                                         stored) if d is not None]
        scatter_rows(*zip(*pairs), tables, positions, valid)
        return self._logits(params, h), cache

    def verify_paged(self, params, cache: PagedKVCache, tokens, suffix_lens,
                     prefix_lens, admit, *, engine: str | None = None):
        """The speculation-verify extend: :meth:`extend_paged`'s contract
        (per-position logits [S, L, vocab], the pool written in place,
        lengths/tables the caller's), engine-dispatched. "fused" runs the
        verify kernel (``ops/fused_decode.verify_tokens_paged``: one launch
        over all layers, the valid rows committed in the kernel; the
        logits head stays a plain product); "fused-layer" and "xla"
        delegate to :meth:`extend_paged`, as the JAX per-layer and XLA
        engines do."""
        if self._resolve_decode_engine(engine, params) != "fused":
            return self.extend_paged(
                params, cache, tokens, suffix_lens, prefix_lens, admit
            )
        l = tokens.shape[1]
        positions = prefix_lens.long()[:, None] + torch.arange(l, device=tokens.device)
        h = self._embed_tokens(params, tokens, positions)
        weights = {nm: getattr(params.blocks, nm) for nm in WEIGHT_NAMES}
        ks, vs = _scales(cache)
        hr = verify_tokens_paged(
            h, weights, cache.k, cache.v, cache.block_tables, prefix_lens,
            suffix_lens, admit, **self._kernel_kw(), k_scale=ks, v_scale=vs,
        )
        return self._logits(params, hr), cache

    def decode_paged(self, params, token, cache: PagedKVCache, active=None, *,
                     engine: str | None = None):
        """Append one token per slot through the block tables — the paged
        counterpart of :meth:`decode_slots` (same masking contract). The
        caller guarantees each active slot's table covers ``lengths[s]``
        (the server reserves ``prompt + max_new`` positions at admission).
        JAX's "KV cache full" check runs only on CPU tensors, where it
        costs no device sync."""
        s = token.shape[0]
        act = (
            torch.ones(s, dtype=torch.bool, device=token.device)
            if active is None
            else active.bool()
        )
        if not token.is_cuda:
            self._refuse_full_cache(cache.lengths, act)
        h = self._embed_tokens(params, token[:, None], cache.lengths[:, None])[:, 0]
        kw = self._kernel_kw()
        tables, lengths = cache.block_tables, cache.lengths
        eng = self._resolve_decode_engine(engine, params)
        if eng == "fused-layer":
            for i in range(self.num_layers):
                weights = {nm: getattr(params.blocks, nm)[i] for nm in WEIGHT_NAMES}
                ks, vs = _scales(cache, i)
                h, kq, vq, kqs, vqs = decode_block_paged(
                    h, weights, cache.k[i], cache.v[i], tables, lengths, **kw, k_scale=ks,
                    v_scale=vs)
                commit_paged_rows(cache.k[i], cache.v[i], kq, vq, tables, lengths, act, ks,
                                  vs, kqs, vqs)
        elif eng == "fused":
            weights = {nm: getattr(params.blocks, nm) for nm in WEIGHT_NAMES}
            ks, vs = _scales(cache)
            h, _, _ = decode_token_paged(h, weights, cache.k, cache.v, tables, lengths, act,
                                         **kw, k_scale=ks, v_scale=vs)
        else:
            ks, vs = _scales(cache)
            h, _, _ = decode_token_paged_plain(h, params.blocks._asdict(), cache.k, cache.v,
                                               tables, lengths, act, **kw, k_scale=ks,
                                               v_scale=vs, **self._plain_fns(params))
        new_cache = cache._replace(lengths=lengths + act.to(lengths.dtype))
        return self._logits(params, h), new_cache


def _scales(cache, i=None):
    """A cache's (k_scale, v_scale), of layer ``i`` when given; (None,
    None) for the bf16 layout."""
    ks, vs = getattr(cache, "k_scale", None), getattr(cache, "v_scale", None)
    if ks is None or i is None:
        return ks, vs
    return ks[i], vs[i]


def filter_logits(logits, temperature: float = 1.0, top_k: int | None = None,
                  top_p: float | None = None):
    """``sample_decode``'s truncation (JAX ``sample_decode``'s ``pick``): f32
    ``logits / temperature``, then the ``top_k`` largest kept (exactly k,
    ties by index), then the ``top_p`` nucleus: tokens whose EXCLUSIVE
    cumulative probability in sorted order is below p. The rest are -inf."""
    lt = logits.float() / temperature
    if top_k is not None:
        vals, idx = torch.topk(lt, top_k, dim=-1)
        lt = torch.full_like(lt, float("-inf")).scatter(-1, idx, vals)
    if top_p is not None and top_p < 1.0:
        # JAX's argsort(...)[::-1]: descending, ties in reverse index order.
        order = torch.argsort(lt, dim=-1, stable=True).flip(-1)
        probs = torch.softmax(lt.gather(-1, order), dim=-1)
        keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        lt = lt.masked_fill(~keep, float("-inf"))
    return lt


def rolling_layout(x, lengths, c):
    """Stacked rows ``x`` [n, S, L, ...] of positions 0..L-1 (L > c) laid
    out as a rolling slab [n, S, c, ...]: slot j holds row s's largest
    position ``p < lengths[s]`` with ``p ≡ j (mod c)``, ``p = j + c ⌊(len - 1
    - j) / c⌋`` (the JAX ``prefill_slots`` gather, :1600-1615); a slot with
    p < 0 holds garbage that the decode's validity never reaches."""
    idx = torch.arange(c, device=x.device)[None, :]
    p = idx + c * torch.div(lengths.long()[:, None] - 1 - idx, c, rounding_mode="floor")
    p = p.clamp(0, x.shape[2] - 1).reshape(1, x.shape[1], c, *([1] * (x.dim() - 3)))
    return torch.take_along_dim(movable(x), p, dim=2).view(x.dtype)


def layer_params(blocks, i: int):
    """Layer ``i`` of the stacked block parameters (dense or MoE;
    ``QuantizedLinear`` leaves indexed field by field)."""
    return type(blocks)(*(index_leaf(t, i) for t in blocks))


def map_params(params: GPTLMParams, fn) -> GPTLMParams:
    """Apply ``fn`` to every tensor of a params tree (MoE blocks and
    ``QuantizedLinear`` leaves included)."""
    return tree_map(fn, params)


def picked_nll(logits32, targets):
    """Per-position negative log-likelihood ``logsumexp(x) − x[target]``
    (the JAX ``_picked_nll``; a gather picks the target, the same values as
    the compare-and-reduce the TPU needed)."""
    picked = logits32.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits32, dim=-1) - picked


def ce_from_logits(logits, tokens, lengths=None):
    """Mean next-token cross-entropy (positions 0..L-2 predict 1..L-1, f32),
    masked over ``lengths`` when given (the JAX ``_ce_from_logits``)."""
    nll = picked_nll(logits[:, :-1].float(), tokens[:, 1:])
    if lengths is None:
        return nll.mean()
    # The target at position i is token i+1: valid iff i+1 < lengths[b].
    pos = torch.arange(tokens.shape[1] - 1, device=tokens.device)
    w = (pos[None, :] < (lengths.to(tokens.device)[:, None] - 1)).float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def lm_value_and_grad(model: GPTLM, params: GPTLMParams, tokens, lengths=None):
    """``(loss, grads)`` of ``model.loss`` at ``params`` by autograd (the
    JAX ``jax.value_and_grad(model.loss)``); the loss comes back detached,
    on the device."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten(params, leaves), tokens, lengths)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _mesh_axes(mesh, *axes):
    """``axes`` that ``mesh`` has, checked (None entries dropped)."""
    out = tuple(a for a in axes if a is not None)
    for a in out:
        if a not in mesh.shape:
            raise ValueError(f"mesh has no {a!r} axis: {dict(mesh.shape)}")
    return out


def _shard(t, mesh, axis, dim):
    """This rank's block of ``t`` along ``dim`` split over ``axis`` (all
    of ``t`` for None)."""
    if t is None or axis is None:
        return t
    n = mesh.axis_size(axis)
    if t.shape[dim] % n:
        raise ValueError(f"a size of {t.shape[dim]} does not split over the {n}-way "
                         f"{axis!r} axis")
    m = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axis) * m, m)


def _summed_update(optimizer, mesh, axes, params, opt_state, loss, leaves, specs=None,
                   whole: bool = False):
    """The update from a rank's share of a global loss: its gradient
    summed over ``axes`` (the JAX shard_map's auto-psum of a replicated
    parameter's gradient), the shares of the loss summed likewise, one flat
    all-reduce a set of axes. ``specs``: the params are this rank's blocks
    of that layout, and the update runs on them
    (``parallel/specs.pinned_update``); a leaf split over an axis of
    ``axes`` already holds its gradient summed over that axis (an expert's
    weights, through the all-to-all's backward) and is summed over the
    others only. ``whole``: ``leaves`` are the parameters whole (ZeRO's
    gathered slices), every gradient is summed over ``axes`` and each rank
    keeps its slice of ``specs``."""
    with torch.enable_grad():
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        split = [()] * len(grads) if specs is None or whole else aligned_specs(params, specs)
        groups = {tuple(axes): [-1]}  # -1: the loss
        for i, sp in enumerate(split):
            groups.setdefault(tuple(a for a in axes if a not in sp), []).append(i)
        out = list(grads)
        for over, idx in groups.items():
            parts = [loss.detach().reshape(1) if i < 0 else grads[i] for i in idx]
            flat = torch.cat([t.reshape(-1).float() for t in parts])
            if over:
                mesh.all_reduce_(flat, over)
            at = 0
            for i, t in zip(idx, parts):
                v = flat[at:at + t.numel()].view_as(t)
                at += t.numel()
                if i < 0:
                    total = v[0]
                else:
                    out[i] = v.to(t.dtype)
        grads = tree_unflatten(params, out)
        if whole:
            grads = shard_tree(grads, specs, mesh)
        if specs is None:
            params2, opt_state = optimizer.update(grads, opt_state, params)
        else:
            params2, opt_state = pinned_update(optimizer, params, opt_state, grads, mesh, specs)
    return params2, opt_state, total


def _tp_specs(model: GPTLM, mesh, tp_axis: str):
    """The model's ``partition_specs`` over ``tp_axis`` of ``mesh``, the
    layout refused where the port cannot split it."""
    specs = model.partition_specs(tp_axis)  # raises for MoE blocks
    _mesh_axes(mesh, tp_axis)
    reason = model.tp_unsupported_reason(mesh.axis_size(tp_axis))
    if reason is not None:
        raise ValueError(f"tensor parallelism over {tp_axis!r}: {reason}")
    return specs


def make_lm_sp_parts(model: GPTLM, optimizer, mesh, axis: str = "seq", *,
                     data_axis: str | None = None, attention: str | None = None,
                     ragged: bool = False, tp_axis: str | None = None):
    """The sequence-parallel update (JAX :2999): ``mapped(params,
    opt_state, tokens, lengths) -> (params, opt_state, loss)``, a
    collective over ``mesh``. ``tokens`` [B, L] is the global batch, the
    same on every rank; each rank keeps its sequence shard over ``axis``
    (and its rows over ``data_axis`` when given: dp×sp), params and
    optimizer state replicated.

    The loss is the exact global masked next-token CE: each rank scores
    its L/n positions, the shard boundary's target (the next shard's first
    token) arrives over one permute hop, and the CE and count sums are
    summed over every axis before the division, so it equals
    ``ce_from_logits`` on the whole batch. Each rank differentiates its
    share (its CE sum over the global count) and the gradients are summed
    over every axis: the gradient of the global loss. ``lengths`` [B]
    (``ragged``) masks targets past each row's length. ``tp_axis`` (the
    dp×tp×sp step): params and optimizer state are this rank's blocks of
    ``model.partition_specs(tp_axis)``, the forward Megatron's over that
    axis on the local heads, and the gradients summed over the data and
    sequence axes only."""
    if model.moe_experts is not None:
        raise NotImplementedError(
            "MoE blocks are not supported on the sequence-parallel path; "
            "use expert parallelism (make_lm_ep_parts)")
    if data_axis == axis:
        raise ValueError(f"data_axis must differ from the seq axis {axis!r}")
    axes = _mesh_axes(mesh, data_axis, axis)
    n = mesh.axis_size(axis)
    specs = None if tp_axis is None else _tp_specs(model, mesh, tp_axis)

    def mapped(params, opt_state, tokens, lengths=None):
        toks = _shard(_shard(tokens, mesh, data_axis, 0), mesh, axis, 1)
        lens = _shard(lengths, mesh, data_axis, 0) if ragged else None
        l_loc = toks.shape[1]
        my = mesh.axis_index(axis)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            logits = model.apply_sequence_parallel(tree_unflatten(params, leaves), toks, mesh,
                                                   axis, attention=attention, tp_axis=tp_axis)
            # Shard i receives shard i + 1's first token: the boundary target.
            (nxt,) = mesh.ring_permute([toks[:, 0].contiguous()], axis, shift=-1)
            targets = torch.cat([toks[:, 1:], nxt[:, None]], dim=1)
            nll = picked_nll(logits.float(), targets)
            tpos = my * l_loc + torch.arange(l_loc, device=toks.device) + 1
            valid = tpos[None, :] < n * l_loc  # the last position has no target
            if lens is not None:
                valid = valid & (tpos[None, :] < lens.to(toks.device)[:, None])
            w = valid.expand_as(nll).float()
            count = mesh.all_reduce_(w.sum().detach().clone(), axes)
            loss = (nll * w).sum() / torch.clamp(count, min=1.0)
        return _summed_update(optimizer, mesh, axes, params, opt_state, loss, leaves, specs)

    return mapped


def make_lm_sp_train_step(model: GPTLM, optimizer, mesh, *, axis: str = "seq",
                          data_axis: str | None = None, attention: str | None = None):
    """The sequence-parallel training step (JAX :2969): ``step(params,
    opt_state, tokens) -> (params, opt_state, loss)`` on the global batch
    [B, L], L divisible by the ``axis`` size; ``data_axis`` composes data
    parallelism (dp×sp on a ``("data", "seq")`` mesh). See
    :func:`make_lm_sp_parts`."""
    mapped = make_lm_sp_parts(model, optimizer, mesh, axis, data_axis=data_axis,
                              attention=attention)

    def step(params, opt_state, tokens):
        return mapped(params, opt_state, tokens, None)

    return step


def expert_parallel_specs(model: GPTLM, axis_name: str = "expert") -> GPTLMParams:
    """The expert-parallel layout (JAX ``expert_parallel_specs``): the MoE
    blocks' expert-stacked FFN leaves (w_up, b_up, w_down, b_down) split
    on dim 1, the expert dim (dim 0 is the layer's), every other leaf
    replicated: the layout :meth:`GPTLM.apply_expert_parallel` and
    :func:`make_lm_ep_parts` take."""
    if model.moe_experts is None:
        raise ValueError("expert_parallel_specs requires moe_experts")
    ex = (None, axis_name)
    return GPTLMParams(
        embed=(), pos=(),
        blocks=GPTMoEBlockParams(ln1_scale=(), ln1_bias=(), wq=(), wk=(), wv=(), wo=(),
                                 ln2_scale=(), ln2_bias=(), wg=(), w_up=ex, b_up=ex,
                                 w_down=ex, b_down=ex),
        lnf_scale=(), lnf_bias=())


def _shard_rows(t, mesh, axes):
    """This rank's block of rows of ``t`` split over ``axes`` taken
    major to minor in the order given (JAX ``P((data, expert))``)."""
    if t is None:
        return t
    n, idx = 1, 0
    for a in axes:
        n, idx = n * mesh.axis_size(a), idx * mesh.axis_size(a) + mesh.axis_index(a)
    if t.shape[0] % n:
        raise ValueError(f"a batch of {t.shape[0]} rows does not split over {n} shards")
    b = t.shape[0] // n
    return t[idx * b:(idx + 1) * b]


def make_lm_ep_parts(model: GPTLM, optimizer, mesh, axis: str = "expert", *,
                     data_axis: str | None = None, ragged: bool = False):
    """The expert-parallel update (JAX ``make_lm_ep_parts``, :2688):
    ``(specs, opt_specs, mapped)``, the layout of the params
    (:func:`expert_parallel_specs`), that of the optimizer's slots
    (``parallel/specs.slot_specs``) and ``mapped(params, opt_state, tokens,
    lengths=None) -> (params, opt_state, loss)``, a collective over
    ``mesh``. ``tokens`` [B, L] is the global batch, the same on every rank;
    each rank keeps its block of B/shards rows, over ``(data_axis, axis)``
    data-major; params and slots are its blocks of the layout (one expert's
    FFN weights).

    The loss is the mean over the shards of each shard's masked CE plus
    ``moe_balance_coef`` · balance + ``moe_z_coef`` · z, the router's terms
    over the shard's own tokens (JAX's per-shard semantics). A replicated
    leaf's gradient is summed over both axes; an expert leaf's, which the
    all-to-all's backward has summed over the expert axis, over the data
    axis only; the mean's 1/shards is in each rank's share. ``lengths``
    (``ragged``) masks the CE and the routing per shard (None means every
    position, JAX's ``_default_lens``); without ``ragged`` it is ignored."""
    if model.moe_experts is None:
        raise ValueError("make_lm_ep_train_step requires moe_experts")
    n = mesh.axis_size(_mesh_axes(mesh, axis)[0])
    if n != model.moe_experts:
        raise ValueError(f"{axis!r} axis size {n} != moe_experts {model.moe_experts}")
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"mesh has no {data_axis!r} axis: {dict(mesh.shape)}")
    if data_axis == axis:
        raise ValueError(f"data_axis must differ from the expert axis {axis!r}")
    axes = (axis,) if data_axis is None else (data_axis, axis)
    specs = expert_parallel_specs(model, axis)
    opt_specs = slot_specs(optimizer, model.init(device="meta"), specs)
    shards = mesh.axis_size(axes)

    def mapped(params, opt_state, tokens, lengths=None):
        if not ragged:
            lengths = None
        elif lengths is None:
            lengths = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        toks, lens = _shard_rows(tokens, mesh, axes), _shard_rows(lengths, mesh, axes)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            logits, auxs = model.apply_expert_parallel(tree_unflatten(params, leaves), toks,
                                                       mesh, axis, with_aux=True, lengths=lens)
            loss = (ce_from_logits(logits, toks, lens)
                    + model.moe_balance_coef * auxs.balance_loss.mean()
                    + model.moe_z_coef * auxs.z_loss.mean()) / shards
        return _summed_update(optimizer, mesh, axes, params, opt_state, loss, leaves, specs)

    return specs, opt_specs, mapped


def make_lm_ep_train_step(model: GPTLM, optimizer, mesh, axis: str = "expert", *,
                          data_axis: str | None = None):
    """The expert-parallel training step (JAX :2639): ``step(params,
    opt_state, tokens) -> (params, opt_state, loss)`` on the global batch,
    params and slots in :func:`expert_parallel_specs`' layout
    (``parallel/specs.shard_tree``); ``data_axis`` composes data
    parallelism (dp×ep on a ``("data", "expert")`` mesh). See
    :func:`make_lm_ep_parts`."""
    _, _, mapped = make_lm_ep_parts(model, optimizer, mesh, axis, data_axis=data_axis)

    def step(params, opt_state, tokens):
        return mapped(params, opt_state, tokens, None)

    return step


def pipeline_parallel_specs(model: GPTLM, axis_name: str = "stage") -> GPTLMParams:
    """The pipeline layout over :meth:`GPTLM.pipeline_stage_blocks` (JAX
    ``pipeline_parallel_specs``): every staged block leaf split on its
    leading num_stages dim, one layer group a rank of ``axis_name``;
    embeddings and the final norm replicated."""
    if model.moe_experts is not None:
        raise NotImplementedError(
            "pipeline parallelism is not defined for MoE blocks; use "
            "expert parallelism (make_lm_ep_train_step)")
    return GPTLMParams(embed=(), pos=(), blocks=GPTBlockParams(*[(axis_name,)] * 12),
                       lnf_scale=(), lnf_bias=())


def pipeline_stage_params(model: GPTLM, params: GPTLMParams, num_stages: int) -> GPTLMParams:
    """Canonical params → the pipeline layout: the blocks as
    [num_stages, layers_per_stage, ...] (:meth:`GPTLM.pipeline_stage_blocks`),
    everything else as it is. :func:`pipeline_unstage_params` inverts it."""
    return params._replace(blocks=model.pipeline_stage_blocks(params.blocks, num_stages))


def pipeline_unstage_params(params: GPTLMParams) -> GPTLMParams:
    """Staged params → canonical: the two leading block dims merged."""
    return params._replace(blocks=tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                                           params.blocks))


def _global_ce_share(logits, tokens, lengths, mesh, axes):
    """This rank's share of the global batch's next-token CE, its rows
    split over ``axes``: its mean over the shards or, with ``lengths``, its
    masked sum over the global count of targets."""
    if lengths is None:
        return ce_from_logits(logits, tokens) / mesh.axis_size(axes)
    nll = picked_nll(logits[:, :-1].float(), tokens[:, 1:])
    pos = torch.arange(tokens.shape[1] - 1, device=tokens.device)
    w = (pos[None, :] < (lengths.to(tokens.device)[:, None] - 1)).float()
    count = mesh.all_reduce_(w.sum().detach().clone(), axes)
    return (nll * w).sum() / torch.clamp(count, min=1.0)


def make_lm_pp_parts(model: GPTLM, optimizer, mesh, *, axis: str = "stage",
                     num_microbatches: int = 4, data_axis: str | None = None):
    """The pipeline-parallel update (JAX ``make_lm_pp_parts``, :2893):
    ``(specs, opt_specs, mapped)``, the layout of the staged params
    (:func:`pipeline_parallel_specs`), that of the optimizer's slots and
    ``mapped(params, opt_state, tokens, lengths=None) -> (params,
    opt_state, loss)``, a collective over ``mesh``. ``params`` and
    ``opt_state`` are this rank's stage of :func:`pipeline_stage_params`
    (``parallel/specs.shard_tree``): its layer group and that group's
    slots; embeddings, final norm and their slots replicated. ``tokens``
    [B, L] is the global batch on every rank.

    Embedding, head and CE run on every stage's replica; the blocks run as
    the GPipe pipeline (``parallel/pipeline.py``, ``num_microbatches``
    microbatches, :meth:`GPTLM._pp_stage_fn`, checkpointed under remat).
    The loss is the global batch's CE (masked over ``lengths`` when given),
    which every stage computes alike: the head's gradient is whole on each
    stage, the embedding's input gradient reaches every stage through the
    pipeline's ``copy_to``, and a layer group's arrives through the hops'
    backward. ``data_axis`` (dp×pp) splits each microbatch's rows over that
    axis; every gradient is then summed over it. The update is
    ``parallel/specs.pinned_update`` on the stage's blocks."""
    from distributed_tensorflow_tpu_torch.parallel.pipeline import microbatch, pipeline_apply

    s = mesh.axis_size(_mesh_axes(mesh, axis)[0])
    if model.num_layers % s:
        raise ValueError(
            f"num_layers {model.num_layers} not divisible by {axis!r} axis size {s}")
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"mesh has no {data_axis!r} axis: {dict(mesh.shape)}")
    if data_axis == axis:
        raise ValueError(f"data_axis must differ from the stage axis {axis!r}")
    specs = pipeline_parallel_specs(model, axis)  # raises for MoE blocks
    staged = pipeline_stage_params(model, model.init(device="meta"), s)
    opt_specs = slot_specs(optimizer, staged, specs)
    axes = () if data_axis is None else (data_axis,)
    m = num_microbatches
    stage_fn = model._pp_stage_fn()

    def rows(t):  # this rank's rows of every microbatch, microbatch-major
        if t is None or data_axis is None:
            return t
        mbs = _shard(microbatch(t, m), mesh, data_axis, 1)
        return mbs.reshape((-1,) + tuple(t.shape[1:]))

    def mapped(params, opt_state, tokens, lengths=None):
        toks, lens = rows(tokens), rows(lengths)
        b, l = toks.shape
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            p = tree_unflatten(params, leaves)
            h = model._embed_tokens(p, toks, torch.arange(l, device=toks.device))
            out = pipeline_apply(stage_fn, p.blocks, microbatch(h, m), mesh, axis)
            logits = model._logits(p, out.reshape(b, l, -1))
            loss = _global_ce_share(logits, toks, lens, mesh, axes)
        return _summed_update(optimizer, mesh, axes, params, opt_state, loss, leaves, specs)

    return specs, opt_specs, mapped


def make_lm_pp_train_step(model: GPTLM, optimizer, mesh, *, axis: str = "stage",
                          num_microbatches: int = 4, data_axis: str | None = None):
    """The pipeline-parallel training step (JAX :2827): ``step(params,
    opt_state, tokens) -> (params, opt_state, loss)`` on the global batch,
    params and slots this rank's stage of :func:`pipeline_stage_params`;
    ``data_axis`` composes data parallelism (dp×pp on a ``("data",
    "stage")`` mesh). See :func:`make_lm_pp_parts`."""
    _, _, mapped = make_lm_pp_parts(model, optimizer, mesh, axis=axis,
                                    num_microbatches=num_microbatches, data_axis=data_axis)

    def step(params, opt_state, tokens):
        return mapped(params, opt_state, tokens, None)

    return step


def _batch_step(model: GPTLM, optimizer, mesh, axis: str | None, tp=None, specs=None,
                zero: bool = False):
    """The step over the batch split on ``axis`` of ``mesh`` (None: every
    rank takes the whole batch), the loss the global batch's (the mean of
    the ranks' means; with ``lengths``, the global masked mean) and its
    gradient summed over the axis; under ``tp`` the forward and update on
    this rank's blocks of ``specs``. ``zero``: the params are this rank's
    slices of ``specs`` over ``axis`` (ZeRO), gathered whole for the forward
    (:func:`~parallel.fsdp.gather_sharded`), the summed gradient cut to the
    slices and the update run on them."""
    axes = () if axis is None else (axis,)
    n = mesh.axis_size(axes)
    if zero:
        from distributed_tensorflow_tpu_torch.parallel.fsdp import gather_sharded

        spec_list = aligned_specs(model.init(device="meta"), specs)

    def step(params, opt_state, tokens, lengths=None):
        toks, lens = _shard(tokens, mesh, axis, 0), _shard(lengths, mesh, axis, 0)
        full = gather_sharded(params, spec_list, mesh, axis) if zero else params
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(full)]
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(params, leaves), toks, lens, tp)
            if lens is None:
                loss = loss / n
            else:  # the rank's masked mean weighted by its share of the targets
                count = torch.clamp(lens.long() - 1, min=0).sum().float()
                loss = loss * count / torch.clamp(mesh.all_reduce_(count.clone(), axes),
                                                  min=1.0)
        return _summed_update(optimizer, mesh, axes, params, opt_state, loss, leaves, specs,
                              whole=zero)

    return step


def make_lm_zero_parts(model: GPTLM, optimizer, mesh, axis: str = "data"):
    """The LM's ZeRO-3 update (the JAX trainer's ``dp_mode="zero"``, GSPMD
    over ``parallel/fsdp.fsdp_specs``): ``(specs, opt_specs, mapped)``, the
    layout of the params (each leaf's largest dim the ``axis`` size
    divides, split over ``axis``; a leaf with none whole on every rank),
    that of the optimizer's slots, and ``mapped(params, opt_state, tokens,
    lengths=None) -> (params, opt_state, loss)``, a collective over
    ``mesh``: params and slots are this rank's slices
    (``parallel/specs.shard_tree``). The forward gathers the parameters
    over ``axis`` (one all-reduce of a zero bucket holding each rank's
    slices: exact), runs :func:`make_lm_train_step`'s data-parallel step on
    this rank's rows, sums the gradients and the loss in its one flat
    bucket, and each rank keeps its slice of the sum; the update runs on
    the slices (``parallel/specs.pinned_update``: global-norm clipping's
    norm over every slice). The same batches give dp's parameters."""
    from distributed_tensorflow_tpu_torch.parallel.fsdp import fsdp_specs

    axis = _mesh_axes(mesh, axis)[0]
    meta = model.init(device="meta")
    specs = fsdp_specs(meta, mesh, axis=axis)
    return (specs, slot_specs(optimizer, meta, specs),
            _batch_step(model, optimizer, mesh, axis, specs=specs, zero=True))


def make_lm_async_parts(model: GPTLM, optimizer, mesh, *, axis: str = "data",
                        avg_every: int = 1, update_scale: float | None = None,
                        ragged: bool = False):
    """Async local SGD for the LM (JAX ``make_lm_async_parts``, :3151), the
    reference's HOGWILD mode as ``parallel/strategy.AsyncDataParallel``
    emulates it: each rank of ``axis`` owns its copy of the parameters and
    optimizer state and steps on its own rows. Returns ``(init_state,
    mapped)``:

    - ``init_state(params, opt_state) -> (params, opt_state, count)``: this
      rank's copies, count 0;
    - ``mapped(params, opt_state, tokens, lengths, count) -> (params,
      opt_state, loss)``: one step on this rank's rows of the global batch
      ``tokens`` [n·B, L] (``lengths`` masks each copy's loss when
      ``ragged``), the update scaled by ``update_scale`` (None = N, the
      replica count, as in ``AsyncDataParallel``); then, when ``(count + 1)
      % avg_every == 0`` (a host ``if`` on the host count), every copy
      jumps to the mean of the copies through one all-reduce of a flat
      bucket. No collective runs on the other steps: ``loss`` is this
      rank's own, and the trainer means it over the ranks where it reads
      it. With SGD, ``avg_every=1`` and ``update_scale=1`` the step is the
      sync data-parallel step up to the order of the sums."""
    if avg_every < 1:
        raise ValueError(f"avg_every must be >= 1, got {avg_every}")
    axis = _mesh_axes(mesh, axis)[0]
    scale = float(mesh.axis_size(axis) if update_scale is None else update_scale)
    local = make_lm_train_step(model, optimizer)

    def init_state(params, opt_state):
        copy = lambda t: tree_map(  # noqa: E731
            lambda a: a.clone() if isinstance(a, torch.Tensor) else a, t)
        return copy(params), copy(opt_state), 0

    def mapped(params, opt_state, tokens, lengths, count):
        toks = _shard(tokens, mesh, axis, 0)
        lens = _shard(lengths, mesh, axis, 0) if ragged else None
        new, opt_state, loss = local(params, opt_state, toks, lens)
        # The optimizer returns new parameters, so the scaled update is
        # p + scale·(new − p); at scale 1 the step itself, bit for bit.
        params = new if scale == 1.0 else tree_map(lambda p, q: p + (q - p) * scale, params, new)
        if (count + 1) % avg_every == 0:
            params = tree_unflatten(params, mesh.mean_(tree_leaves(params), axis))
        return params, opt_state, loss

    return init_state, mapped


def make_lm_async_train_step(model: GPTLM, optimizer, mesh, *, axis: str = "data",
                             avg_every: int = 1, update_scale: float | None = None):
    """Async local SGD for the LM (JAX :3094): ``(init_state, step)`` with
    ``init_state(params, opt_state) -> state`` and ``step(state, tokens) ->
    (state, loss)``, ``state = (params, opt_state, count)`` this rank's.
    See :func:`make_lm_async_parts`."""
    init_state, mapped = make_lm_async_parts(model, optimizer, mesh, axis=axis,
                                             avg_every=avg_every, update_scale=update_scale)

    def step(state, tokens):
        params, opt_state, count = state
        params, opt_state, loss = mapped(params, opt_state, tokens, None, count)
        return (params, opt_state, count + 1), loss

    return init_state, step


def make_lm_train_step(model: GPTLM, optimizer, mesh=None, axis: str = "data", *,
                       tp_axis: str | None = None, seq_axis: str | None = None):
    """``step(params, opt_state, tokens, lengths=None) -> (params, opt_state,
    loss)`` for any optimizer of ``ops/optim.py``: the loss (masked over
    ``lengths`` when given), its gradient, one update; the loss stays on
    the device. Without ``mesh``, on one device. With ``mesh`` (a
    :class:`~parallel.mesh.Mesh`), data parallelism over ``axis`` (JAX
    :3336-3356): ``tokens`` is the global batch, each rank keeps its rows,
    and the loss is the global batch's (the mean of the ranks' means; with
    ``lengths``, the global masked mean), its gradient summed over the
    axis.

    ``tp_axis`` (JAX :3245-3335) is the dp×tp step: ``params`` and
    ``opt_state`` are this rank's blocks of ``model.partition_specs(
    tp_axis)`` (``parallel/specs.shard_tree`` and ``slot_specs``), the
    batch split over ``axis`` when the mesh has it, the forward Megatron's
    over ``tp_axis`` on the local heads, the gradients summed over ``axis``
    only and the update on the blocks (global-norm clipping's norm over
    every block). ``seq_axis`` adds the sequence split over that axis
    (dp×tp×sp): :func:`make_lm_sp_parts` on the local heads, ring-flash
    when ``attention_impl="flash"``. Both are the single-device step's
    math, as JAX's GSPMD program is; dense models only."""
    if seq_axis is not None and tp_axis is None:
        raise ValueError(
            "seq_axis composes on the GSPMD tp path; pass tp_axis too "
            "(for shard_map sequence parallelism use make_lm_sp_parts)")
    if tp_axis is not None:
        if mesh is None:
            raise ValueError("tp_axis requires a mesh")
        if seq_axis is not None and seq_axis not in mesh.shape:
            raise ValueError(f"mesh has no {seq_axis!r} axis: {dict(mesh.shape)}")
        data = axis if axis in mesh.shape else None
        if seq_axis is not None:
            return make_lm_sp_parts(model, optimizer, mesh, seq_axis, data_axis=data,
                                    ragged=True, tp_axis=tp_axis)
        specs = _tp_specs(model, mesh, tp_axis)
        return _batch_step(model, optimizer, mesh, data, TensorParallel(mesh, tp_axis), specs)
    if mesh is None:
        def step(params, opt_state, tokens, lengths=None):
            loss, grads = lm_value_and_grad(model, params, tokens, lengths)
            with torch.no_grad():
                params, opt_state = optimizer.update(grads, opt_state, params)
            return params, opt_state, loss

        return step
    return _batch_step(model, optimizer, mesh, _mesh_axes(mesh, axis)[0])
