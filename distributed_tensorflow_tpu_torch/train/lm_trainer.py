"""The GPT training loop of the port, on one device.

Counterpart of ``distributed_tensorflow_tpu/train/lm_trainer.py``
``LMTrainer`` in its single mode (``mesh=None``): the reference loop's
contract over token batches.

- ``epochs`` × ``num_train // batch_size`` steps over a
  :class:`~data.tokens.TokenDataset` (``next_batch`` semantics);
- the ``Step/Epoch/Batch/Cost/AvgTime`` line every ``log_frequency``
  batches, a held-out **perplexity** per epoch (``Test-Perplexity:``,
  exp of the mean next-token CE over the validation split in
  ``eval_batch``-row chunks), ``Final Cost:`` and ``Done``;
- ragged corpora (datasets with ``lengths``) through the masked loss.

One loop runs the step function (``models/gpt.make_lm_train_step``): the
token arrays are staged on the device once, each epoch's ``[steps,
batch]`` indices are drawn from the dataset's own ``next_indices`` stream
(the batches ``next_batch`` would give), each step gathers its batch on
the device, and a cost is fetched to the host only where a log line is
due. In PyTorch the JAX package's eager and scanned epochs both come down
to this loop, so ``TrainConfig.scan_epoch`` is accepted and changes
nothing. ``TrainConfig.remat`` (True or "selective") lands on a copy of
the model.

:meth:`LMTrainer.run_compiled` (and ``run()`` under
``TrainConfig.compiled_run``) is the JAX ``_build_compiled_run_fn``
(:1299-1440): every epoch's ``[steps, batch]`` indices come from the same
``next_indices`` stream, each step gathers its batch on the device, each
epoch's held-out perplexity is summed on the device in ``eval_batch``-row
chunks (the split trimmed to a chunk multiple, as there), and the costs
and sums are fetched once at the end, from which the same log lines are
printed. The updates, hence the parameters and costs, equal ``run()``'s
bit for bit. ``tokenizer=`` is kept on ``self.tokenizer``.

As in the JAX trainer, the optimizer is ``optimizer=`` or else the plain
``ops/optim.make(config.optimizer, config.learning_rate)``: the config's
``lr_schedule``, ``warmup_steps``, ``grad_clip_norm`` and
``accumulate_steps`` act only through an ``optimizer=`` composed from
them, as ``launch.build_trainer`` composes the MLP ``Trainer``'s.

With ``mesh`` (a :class:`~parallel.mesh.Mesh` over the ranks of a
``torch.distributed`` group, ``parallel/mesh.make_mesh``), every
rank runs this loop on the same global batches (the same dataset, seed
and index stream) and its step keeps its shard, as the JAX trainer's
``shard_map`` does (:540-565):

- ``dp_mode="replicated"`` → **dp**: the batch split over ``data_axis``
  (``models/gpt.make_lm_train_step(model, opt, mesh, data_axis)``);
- ``dp_mode="sp"`` → **sp**: the sequence split over ``seq_axis``
  (``models/gpt.make_lm_sp_parts``, ``sp_attention`` ring | ring_flash |
  ulysses), composed with ``data_axis`` when the mesh has it (dp×sp);
- ``dp_mode="tp"`` → **tp** (JAX :487-498, :605-610, :1143-1160):
  Megatron tensor parallelism over ``tp_axis``
  (``models/gpt.make_lm_train_step(..., tp_axis=)``): the parameters and
  the optimizer slots that track them are this rank's blocks of
  ``GPTLM.partition_specs`` (``parallel/specs.py``), the batch split over
  ``data_axis`` when the mesh has it (dp×tp). The held-out perplexity runs
  the same tensor-parallel forward (a collective of the axis), and
  :meth:`LMTrainer.to_canonical` / :meth:`LMTrainer.from_canonical` gather
  and shard the state;
- ``dp_mode="ep"`` → **ep** (MoE models; JAX :499-515, :612-623):
  expert parallelism over ``expert_axis`` (``models/gpt.make_lm_ep_parts``):
  one expert's FFN weights and their slots a rank, the batch split over
  ``(data_axis, expert_axis)`` data-major (dp×ep when the mesh has the data
  axis), ragged corpora masking the routing per shard;
- ``dp_mode="pp"`` → **pp** (JAX :519-539, :576-595): the GPipe pipeline
  over ``stage_axis`` (``models/gpt.make_lm_pp_parts``,
  ``pp_microbatches`` microbatches): each rank holds its stage's layer
  group of the staged blocks ([S, L/S, ...]) and that group's slots, each
  microbatch's rows split over ``data_axis`` when the mesh has it (dp×pp).

- ``dp_mode="zero"`` → **zero** (JAX :566-567, :597-604): ZeRO-3 over
  ``data_axis`` (``models/gpt.make_lm_zero_parts``): each rank holds its
  slice of every parameter and optimizer slot (``parallel/fsdp.fsdp_specs``),
  the forward gathers the parameters, the update runs on the slices; the
  same batches give dp's parameters;
- ``sync=False`` → **async** (JAX :470-486, :679-696): a copy of the
  parameters and optimizer state a rank of ``data_axis``
  (``models/gpt.make_lm_async_parts``), each stepping on its rows with its
  update scaled by ``async_update_scale`` (None = N), all copies jumping to
  their mean every ``config.async_avg_every`` steps (0 = never);
- ``dp_mode="diloco"`` → **diloco** (JAX :410-467, :639-678): the local-SGD
  outer loop of ``train/local_sgd.py``, ``config.sync_every`` inner steps a
  worker between outer Nesterov rounds (``outer_lr``, ``outer_momentum``,
  the ``delta_dtype`` and ``delta_overlap`` levers): on the mesh one rank
  of ``data_axis`` a worker (``make_lm_diloco_parts``), without a mesh
  ``config.diloco_workers`` workers emulated on one device
  (``make_lm_diloco_vmapped``), the state's ``opt_state`` a
  ``DiLoCoState``.

Under ep, pp and zero the held-out perplexity is the dense forward's at
the canonical parameters, gathered over the axis (pp folds the staged
blocks back: the parameters the metric is defined at); under async and
diloco it is at the mean of the copies (on the mesh a collective, which
every rank calls), as in the JAX trainer (:773-784).
:meth:`LMTrainer.to_canonical` / :meth:`LMTrainer.from_canonical` gather,
unstage, stage and shard the state; async and diloco merge the copies (and
the inner optimizer states) at their mean, integer leaves checked equal
(``parallel/strategy.merge_replica_leaf``), and a diloco state from the
canonical one starts a fresh outer round at its parameters (JAX
:952-1059). In the other modes the parameters stay replicated, so the
held-out perplexity is the dense forward's on each rank, as in the JAX
trainer. Under async and diloco on a mesh a step's cost is the rank's own
(no collective between exchanges); the printed costs are their mean over
the ranks, taken where a line is due (a collective of every rank, which
prints step lines alike) and, in :meth:`LMTrainer.run_compiled`, once over
the run's costs before its one fetch. Step lines print on every rank; the
epoch and final lines on the chief (``is_chief`` and rank 0 of the mesh).

Telemetry, as the JAX trainer wires it (JAX :124-183, :1419-1498,
:1620-1750), and as the MLP ``Trainer`` takes it: the lines rendered from
``journal`` events, the ``step_time_ms`` histogram and ``epochs_total`` in
``metrics`` (flushed into the journal at the end), the compiled run's
dispatch span up to its one fetch, one ambient trace id a run; on the
chief, ``summary_writer`` takes the step's graph once
(:meth:`LMTrainer.write_graph`), a ``cost`` scalar at each logged step and
``perplexity`` each epoch; ``TrainConfig.profile_dir`` profiles the first
epoch of :meth:`LMTrainer.run`. In the dp and DiLoCo modes each epoch
journals a ``comm_stats`` event (sync rounds, the dense all-reduce bytes
and the bytes a round puts on the wire, from
``local_sgd.sync_rounds_between``, ``params_nbytes`` and
``delta_payload_nbytes``) and adds them to the ``sync_rounds_total``,
``allreduce_bytes_total`` and ``payload_bytes_total`` counters.

Checkpoints and recovery, as the JAX trainer wires them (JAX :220-352,
:811-1050, :1331-1545, :1870+): with ``TrainConfig.checkpoint_dir`` (or a
``supervisor=``) the trainer writes ``tokenizer.json`` beside the
checkpoints (refusing a different vocab), restores the newest valid step at
construction (in its own layout, or across modes and world sizes through
the layout sidecar and the canonical form, a DiLoCo gang's outer state
carried across a resize) and fast-forwards the data stream to it, saves
each epoch (each dispatch) in the JAX package's layout for the mode
(dense canonical leaves; pp's staged ``[S, L/S, ...]`` blocks; async's and
DiLoCo's copies stacked ``[n, ...]``: every rank gathers, the chief
writes), and runs ``run()`` under the preemption guard. ``max_rollbacks``
arms the anomaly rollback; ``epochs_per_dispatch`` runs
:meth:`LMTrainer.run_compiled` a chunk of epochs at a time.

``delta_exchange=`` (a ``local_sgd.DeltaExchange``) makes this process
one member of the DiLoCo mailbox gang (``dp_mode="diloco"``,
``diloco_workers=1``, no mesh): every ``sync_every`` steps the member posts
its delta and applies the staleness-weighted mean of what its peers posted,
never waiting (:meth:`LMTrainer._maybe_mailbox_round`, a
``delta_exchange`` journal event and ``mailbox_rounds_total``).
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.observability import journal as obs_journal
from distributed_tensorflow_tpu_torch.observability import tracing
from distributed_tensorflow_tpu_torch.observability.metrics import TIME_MS_EDGES, MetricsRegistry
from distributed_tensorflow_tpu_torch.observability.spans import SpanRecorder
from distributed_tensorflow_tpu_torch.models.gpt import (
    make_lm_async_parts,
    make_lm_ep_parts,
    make_lm_pp_parts,
    make_lm_sp_parts,
    make_lm_train_step,
    make_lm_zero_parts,
    pipeline_unstage_params,
)
from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map, tree_unflatten
from distributed_tensorflow_tpu_torch.ops.collectives import TensorParallel
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.parallel.specs import (
    gather_tree,
    map_split,
    match_slot_specs,
    shard_tree,
)
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    TrainState,
    merge_replica_leaf,
    merge_stacked_leaf,
)
from distributed_tensorflow_tpu_torch.train import local_sgd
from distributed_tensorflow_tpu_torch.train.resilience import (
    AnomalyError,
    AnomalyGuard,
    arm_stall_dump,
    preemption_guard,
)
from distributed_tensorflow_tpu_torch.train.supervisor import (
    Supervisor,
    checkpoint_steps,
    layout_shape,
)
from distributed_tensorflow_tpu_torch.utils.logging import StepLogger
from distributed_tensorflow_tpu_torch.utils.summary import lifecycle_event

# JAX LMTrainer keyword -> (values that leave it off, ROADMAP item).
NOT_PORTED: dict = {}
# Modes whose state has the canonical shapes (JAX :808).
_DENSE_LAYOUTS = frozenset({"single", "dp", "zero", "tp", "ep", "sp"})
SP_ATTENTIONS = (None, "ring", "ring_flash", "ulysses")


class LMTrainer:
    def __init__(
        self,
        model,
        datasets,
        config: TrainConfig | None = None,
        *,
        optimizer=None,
        eval_batch: int = 256,
        print_fn=print,
        device=None,
        tokenizer=None,
        mesh=None,
        data_axis: str = "data",
        seq_axis: str = "seq",
        tp_axis: str = "model",
        expert_axis: str = "expert",
        stage_axis: str = "stage",
        pp_microbatches: int = 4,
        sp_attention: str | None = None,
        is_chief: bool = True,
        async_update_scale: float | None = None,
        summary_writer=None,
        journal=None,
        metrics: MetricsRegistry | None = None,
        supervisor: Supervisor | None = None,
        delta_exchange=None,
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in NOT_PORTED:
                raise TypeError(f"LMTrainer() got an unexpected keyword argument {name!r}")
            off, item = NOT_PORTED[name]
            if value not in off:
                raise NotImplementedError(
                    f"LMTrainer({name}=...) is not ported yet (ROADMAP {item})"
                )
        if sp_attention not in SP_ATTENTIONS:
            raise ValueError(f"unknown sp_attention {sp_attention!r}; ring|ring_flash|ulysses")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
        self.config = config or TrainConfig()
        self.mesh, self.data_axis, self.seq_axis = mesh, data_axis, seq_axis
        self.tp_axis, self.expert_axis, self.stage_axis = tp_axis, expert_axis, stage_axis
        self.pp_microbatches = pp_microbatches
        self.sp_attention = sp_attention
        self.async_update_scale = async_update_scale
        self.is_chief = is_chief and (mesh is None or mesh.rank == 0)
        self.tokenizer = tokenizer
        # The config's remat and matmul_dtype land on a shallow copy, so the
        # caller's model object keeps its own settings (as in the JAX
        # trainer); a knob already set on the model wins.
        apply_remat = self.config.remat and not model.remat
        apply_mm = self.config.matmul_dtype and model.matmul_dtype is None
        if apply_remat or apply_mm:
            model = copy.copy(model)
            if apply_remat:
                model.remat = self.config.remat
            if apply_mm:
                model.matmul_dtype = self.config.matmul_dtype
        self.model = model
        self.datasets = datasets
        self.device = resolve_device(device)
        self.optimizer = optimizer or optim_lib.make(
            self.config.optimizer, self.config.learning_rate
        )
        self.eval_batch = eval_batch
        self.print_fn = print_fn
        self.summary_writer = summary_writer
        self.journal = journal if journal is not None else obs_journal.get_journal()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.spans = SpanRecorder(journal=self.journal)
        self._graph_written = False
        self._ragged = datasets.train.lengths is not None
        # The mailbox gang (local_sgd.DeltaExchange): its knobs must agree
        # with the config's, and it reports through this trainer's journal
        # and metrics unless the caller wired its own (JAX :185-211).
        self.delta_exchange = delta_exchange
        if delta_exchange is not None:
            if delta_exchange.delta_dtype != self.config.delta_dtype:
                raise ValueError(
                    f"delta_exchange.delta_dtype={delta_exchange.delta_dtype!r} disagrees with "
                    f"config.delta_dtype={self.config.delta_dtype!r}")
            if delta_exchange.stale_limit != self.config.stale_limit:
                raise ValueError(
                    f"delta_exchange.stale_limit={delta_exchange.stale_limit} disagrees with "
                    f"config.stale_limit={self.config.stale_limit}")
            if getattr(delta_exchange, "journal", None) is None:
                delta_exchange.journal = self.journal
            if getattr(delta_exchange, "metrics", None) is None:
                delta_exchange.metrics = self.metrics
        self.mode = self._resolve_mode()
        self._tp = self._specs = None
        if self.mode == "tp":
            self._tp = TensorParallel(mesh, tp_axis)
            self._specs = self.model.partition_specs(tp_axis)
        self._step = self._make_step()  # sets the ep and pp layouts
        self.state = self._init_state(self.model.init(seed=self.config.seed, device=self.device))
        self._stage_cache: dict = {}
        self.last_cost = None
        self._epoch_costs = None
        self.history: list[dict] = []

        self.supervisor = supervisor
        if self.supervisor is None and self.config.checkpoint_dir:
            self.supervisor = Supervisor(
                is_chief=self.is_chief,
                checkpoint_dir=self.config.checkpoint_dir,
                keep_last_n=self.config.keep_last_n,
                io_retries=self.config.checkpoint_retries,
                io_backoff=self.config.checkpoint_retry_backoff,
                async_checkpoint=self.config.async_checkpoint,
            )
        if (tokenizer is not None and self.supervisor is not None
                and self.supervisor.checkpoint_dir and self.supervisor.is_chief
                and hasattr(tokenizer, "save")):
            # The vocab ships with the checkpoint: restored weights are
            # useless without the merges that made their token ids.
            os.makedirs(self.supervisor.checkpoint_dir, exist_ok=True)
            self._write_tokenizer(tokenizer)
        self.start_step = 0
        if self.supervisor is not None:
            self.supervisor.attach_observability(self.journal, self.metrics, self.spans)
            self._restore()

    # -- checkpoints ------------------------------------------------------

    def _write_tokenizer(self, tokenizer) -> None:
        """``tokenizer.json`` into checkpoint_dir, unless one is there: a
        vocab with the same merges makes it a no-op, another one is
        refused (it is the vocab of the checkpoint's token ids)."""
        path = os.path.join(self.supervisor.checkpoint_dir, "tokenizer.json")
        if os.path.exists(path):
            from distributed_tensorflow_tpu_torch.data.text import BPETokenizer

            try:
                existing = BPETokenizer.load(path)
            except Exception as exc:
                raise ValueError(
                    f"checkpoint_dir already holds an unreadable {path} "
                    f"({type(exc).__name__}: {exc}); refusing to overwrite "
                    "the vocab record the checkpoint's token ids depend on"
                ) from exc
            if getattr(tokenizer, "merges", None) != existing.merges:
                raise ValueError(
                    f"tokenizer mismatch: {path} holds "
                    f"{len(existing.merges)} merges that differ from this "
                    f"tokenizer's {len(getattr(tokenizer, 'merges', []))}; "
                    "refusing to overwrite the vocab that matches the "
                    "checkpoint's token ids (use a fresh checkpoint_dir "
                    "to train with a new vocab)"
                )
            return
        tokenizer.save(path)

    def _restore(self) -> None:
        """Restore-or-init at construction (JAX :247-350): the newest step
        that is not known-corrupt, in this layout (newest valid first), or,
        written under another mode or width, through the canonical form
        (a DiLoCo gang keeps its saved outer state across a resize); the
        global batch checked; the data stream fast-forwarded to the step."""
        step = self.supervisor.newest_restorable_step()
        src = self.supervisor.saved_layout(step) if step is not None else None
        if step is not None and src is not None and not self._layout_compatible(src):
            raw = self.supervisor.restore_raw(step, self._disk_template(src), device=self.device)
            restored = self.from_canonical(self._state_to_canonical(raw, src))
            if src.get("mode") == "diloco" and self.mode == "diloco":
                carry = dict(theta=raw.opt_state.theta, momentum=raw.opt_state.momentum)
                if self.config.delta_dtype and src.get("delta_dtype") == self.config.delta_dtype:
                    carry["residual"] = raw.opt_state.residual
                if self.config.delta_overlap and src.get("overlap"):
                    carry["inflight"] = raw.opt_state.inflight
                restored = restored._replace(opt_state=restored.opt_state._replace(**carry))
            self.state = restored
            self.start_step = step
        else:
            self.state, self.start_step = self._restore_own(verified_step=step)
        if src is not None and src.get("global_batch") is not None:
            saved_gb = int(src["global_batch"])
            if saved_gb != int(self.config.batch_size):
                raise ValueError(
                    f"checkpoint was trained with global batch {saved_gb} "
                    f"(world={src.get('world')}) but this config says "
                    f"batch_size={self.config.batch_size}; the LM batch is GLOBAL — "
                    "resume with the same batch_size (the per-shard batch grows "
                    "with the smaller mesh) to preserve the trajectory and "
                    "data-stream position")
        # The data stream to where the checkpoint left it: the batches the
        # uninterrupted run would draw next (world-invariant: the batch is
        # global).
        for _ in range(self.start_step):
            self.datasets.train.next_indices(self.config.batch_size)

    def _restore_own(self, fresh: TrainState | None = None,
                     verified_step: int | None = None) -> tuple[TrainState, int]:
        """``Supervisor.prepare_or_restore`` in this trainer's own layout;
        with no checkpoint ``fresh`` (default the current state), step 0."""
        self.supervisor.wait_pending()
        if not checkpoint_steps(self.supervisor.checkpoint_dir):
            return (self.state if fresh is None else fresh), 0
        raw, step = self.supervisor.prepare_or_restore(
            self._disk_template(self._layout_meta()), verified_step=verified_step,
            device=self.device)
        return self._from_disk(raw), step

    def _layout_meta(self) -> dict:
        """The layout sidecar, JAX's dict for every mode (JAX :811-850):
        the mode, pp's stages, async's and DiLoCo's stacked width
        (``replicas``; 1 for a mailbox member), DiLoCo's ``sync_every`` and
        its levers when on, the world size and the global batch."""
        meta: dict = {"mode": self.mode}
        if self.mode == "pp":
            meta["stages"] = int(self.mesh.shape[self.stage_axis])
        if self.mode == "async":
            meta["replicas"] = int(self.mesh.shape[self.data_axis])
        if self.mode == "diloco":
            meta["replicas"] = 1 if self.delta_exchange is not None else int(self._gang_size())
            meta["sync_every"] = int(self.config.sync_every)
            if self.config.delta_dtype:
                meta["delta_dtype"] = self.config.delta_dtype
            if self.config.delta_overlap:
                meta["overlap"] = True
        meta["world"] = int(1 if self.mesh is None else self.mesh.size)
        meta["global_batch"] = int(self.config.batch_size)
        return meta

    def _layout_compatible(self, src: dict) -> bool:
        """True when the saved state's shapes are this trainer's (JAX
        :863-876): every dense mode restores every dense mode; the others
        need the same mode and shape keys."""
        m = src.get("mode")
        if self.mode in _DENSE_LAYOUTS:
            return m in _DENSE_LAYOUTS
        return m == self.mode and layout_shape(src) == layout_shape(self._layout_meta())

    @staticmethod
    def _map_params_like(fn, tree):
        """``fn`` on every GPTLMParams node of a tree (the optimizer's
        moments are GPTLMParams too); other nodes kept."""
        from distributed_tensorflow_tpu_torch.models.gpt import GPTLMParams

        if isinstance(tree, GPTLMParams):
            return fn(tree)
        if isinstance(tree, tuple):
            subs = [LMTrainer._map_params_like(fn, t) for t in tree]
            return type(tree)(*subs) if hasattr(tree, "_fields") else type(tree)(subs)
        return tree

    def _disk_template(self, src: dict) -> TrainState:
        """A state of the structure and shapes (on the meta device) of a
        checkpoint written under layout ``src`` by this model and optimizer
        (JAX ``_abstract_state_shapes``, :906-950)."""
        from distributed_tensorflow_tpu_torch.models.gpt import pipeline_stage_params

        params = self.model.init(seed=0, device="meta")
        if src["mode"] == "pp":
            params = pipeline_stage_params(self.model, params, int(src["stages"]))
        opt = self.optimizer.init(params)
        if src["mode"] in ("async", "diloco"):
            n = int(src["replicas"])
            stack = lambda t: tree_map(  # noqa: E731
                lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape))
                if isinstance(a, torch.Tensor) else a, t)
            if src["mode"] == "diloco":
                return TrainState(stack(params), local_sgd.DiLoCoState(
                    stack(opt), params, params, params if src.get("delta_dtype") else None,
                    local_sgd.InFlight(params, params) if src.get("overlap") else None), 0)
            return TrainState(stack(params), stack(opt), 0)
        return TrainState(params, opt, 0)

    def _stacked(self, tree):
        """Every rank's tensors of ``tree`` stacked ``[n, ...]`` in the data
        axis's order (a collective)."""
        from distributed_tensorflow_tpu_torch.ops.collectives import all_gather_raw

        return tree_map(lambda a: all_gather_raw(a.detach().unsqueeze(0), self.mesh,
                                                 self.data_axis, 0)
                        if isinstance(a, torch.Tensor) else a, tree)

    def _disk_state(self) -> TrainState:
        """The state as the JAX package's checkpoint of this mode holds it:
        the dense canonical leaves (gathered from the blocks under tp, ep
        and zero), pp's staged blocks gathered, async's and the DiLoCo
        gang's copies stacked ``[n, ...]`` (gathered across the ranks on a
        mesh). A collective: every rank calls it, the chief writes."""
        state = self.state
        step = int(state.step)
        if self.mode == "async":
            return TrainState(self._stacked(state.params), self._stacked(state.opt_state), step)
        if self.mode == "diloco":
            if self.mesh is None:
                return TrainState(state.params, state.opt_state, step)
            d = state.opt_state
            return TrainState(self._stacked(state.params),
                              d._replace(inner=self._stacked(d.inner)), step)
        if self.mode == "pp":
            slots = match_slot_specs(state.opt_state, state.params, self._specs)
            return TrainState(gather_tree(state.params, self._specs, self.mesh),
                              gather_tree(state.opt_state, slots, self.mesh), step)
        c = self.to_canonical(state)
        return TrainState(c.params, c.opt_state, step)

    def _state_to_canonical(self, state: TrainState, src: dict) -> TrainState:
        """A source-layout state → the dense single-device form (JAX
        :952-998): async's and DiLoCo's copies (and inner states) merged at
        their mean, integer leaves from copy 0 after checking they agree
        (``merge_stacked_leaf``; DiLoCo's outer state has no canonical
        form); pp's blocks unstaged."""
        mode, merge, step = src["mode"], merge_stacked_leaf, int(state.step)
        if mode == "async":
            return TrainState(tree_map(merge, state.params), tree_map(merge, state.opt_state),
                              step)
        if mode == "diloco":
            return TrainState(tree_map(merge, state.params),
                              tree_map(merge, state.opt_state.inner), step)
        if mode == "pp":
            unstage = lambda t: self._map_params_like(pipeline_unstage_params, t)  # noqa: E731
            return TrainState(unstage(state.params), unstage(state.opt_state), step)
        return TrainState(state.params, state.opt_state, step)

    def _from_disk(self, raw: TrainState) -> TrainState:
        """A checkpoint of this trainer's own layout as this rank's state:
        the rank's copy (and inner state) of async's or the DiLoCo mesh
        gang's stacks, the one-device gang's stacks as they are, a dense
        (or pp's staged) state laid out by :meth:`from_canonical`."""
        if self.mode == "async" or (self.mode == "diloco" and self.mesh is not None):
            r = self.mesh.axis_index(self.data_axis)
            row = lambda t: tree_map(  # noqa: E731
                lambda a: a[r].clone() if isinstance(a, torch.Tensor) else a, t)
            if self.mode == "async":
                return TrainState(row(raw.params), row(raw.opt_state), int(raw.step))
            d = raw.opt_state
            return TrainState(row(raw.params), d._replace(inner=row(d.inner)), int(raw.step))
        if self.mode == "diloco":
            return TrainState(raw.params, raw.opt_state, int(raw.step))
        if self.mode == "pp":
            raw = self._state_to_canonical(raw, {"mode": "pp"})
        return self.from_canonical(raw)

    def _save(self) -> None:
        """A checkpoint at the current step (every rank gathers; the chief
        writes)."""
        self.supervisor.save(self._disk_state(), self.global_step, layout=self._layout_meta())

    # -- modes ------------------------------------------------------------

    def _resolve_mode(self) -> str:
        """single, dp, zero, async, diloco, sp, tp, ep or pp, with the JAX
        trainer's checks (:393-565)."""
        cfg, mesh = self.config, self.mesh
        if cfg.dp_mode != "diloco" and self.delta_exchange is not None:
            raise ValueError(
                "delta_exchange is the diloco mailbox gang: it requires "
                f"dp_mode='diloco', got {cfg.dp_mode!r}")
        if cfg.dp_mode == "diloco":
            if not cfg.sync:
                raise ValueError(
                    "dp_mode='diloco' does not compose with sync=False: the outer loop IS "
                    "the (reduced) synchronization; use sync=False + async_avg_every for "
                    "the HOGWILD emulation instead")
            if self.delta_exchange is not None:
                # One member a process: the gang is the processes sharing
                # the exchange's directory (JAX :418-445).
                if mesh is not None:
                    raise ValueError(
                        "delta_exchange runs one gang member per process (the outer round "
                        "is a host decision point): pass mesh=None with diloco_workers=1")
                if cfg.diloco_workers != 1:
                    raise ValueError(
                        "delta_exchange needs diloco_workers=1 (each process is ONE "
                        f"member), got {cfg.diloco_workers}")
                if cfg.delta_overlap:
                    raise ValueError(
                        "delta_overlap does not compose with delta_exchange: the mailbox "
                        "gang never waits on the exchange — staleness tolerance IS its "
                        "overlap")
                if cfg.epochs_per_dispatch:
                    raise ValueError(
                        "epochs_per_dispatch does not compose with delta_exchange: the "
                        "outer round is a host decision point inside every epoch")
                return "diloco"
            if mesh is not None:
                if self.data_axis not in mesh.shape:
                    raise ValueError(
                        f"dp_mode='diloco' needs a {self.data_axis!r} mesh axis (the gang): "
                        f"{dict(mesh.shape)}")
                n = mesh.shape[self.data_axis]
            elif cfg.diloco_workers >= 1:
                n = cfg.diloco_workers
            else:
                raise ValueError(
                    f"dp_mode='diloco' needs a mesh (the gang is the {self.data_axis!r} axis) "
                    "or diloco_workers >= 1 (the single-device gang emulation)")
            if cfg.batch_size % n:
                raise ValueError(
                    f"dp_mode='diloco' shards the batch over {n} workers: batch_size "
                    f"{cfg.batch_size} must divide")
            return "diloco"
        if mesh is None:
            return "single"
        if not cfg.sync:
            if cfg.dp_mode != "replicated":
                raise ValueError(
                    f"dp_mode={cfg.dp_mode!r} does not compose with "
                    "sync=False: the async copies are per-chip by "
                    "construction; pick one")
            if self.data_axis not in mesh.shape:
                raise ValueError(f"mesh has no {self.data_axis!r} axis: {dict(mesh.shape)}")
            if cfg.batch_size % mesh.shape[self.data_axis]:
                raise ValueError(
                    f"async mode shards the batch over {self.data_axis!r}: batch_size "
                    f"{cfg.batch_size} must be divisible by the axis size "
                    f"{mesh.shape[self.data_axis]}")
            return "async"
        if cfg.dp_mode == "sp":
            if self.seq_axis not in mesh.shape:
                raise ValueError(
                    f"dp_mode='sp' needs a {self.seq_axis!r} mesh axis: {dict(mesh.shape)}")
            if self.model.moe_experts is not None:
                raise ValueError(
                    "dp_mode='sp' is not defined for MoE blocks; use "
                    "dp_mode='ep' (expert parallelism)")
            s = mesh.shape[self.seq_axis]
            seq_len = self.datasets.train.tokens.shape[1]
            if seq_len % s:
                raise ValueError(
                    f"dp_mode='sp' shards the {seq_len}-token sequence "
                    f"over the {s}-way {self.seq_axis!r} axis: must divide")
            d = mesh.shape.get(self.data_axis, 1)
            if self._dp_axis() is not None and cfg.batch_size % d:
                raise ValueError(
                    f"dp×sp shards the batch over the {d}-way {self.data_axis!r} axis: "
                    f"batch_size {cfg.batch_size} must divide")
            return "sp"
        if cfg.dp_mode == "tp":
            if self.tp_axis not in mesh.shape:
                raise ValueError(
                    f"dp_mode='tp' needs a {self.tp_axis!r} mesh axis: {dict(mesh.shape)}")
            if self.model.moe_experts is not None:
                raise ValueError(
                    "dp_mode='tp' is not defined for MoE blocks; use "
                    "dp_mode='ep' (expert parallelism)")
            reason = self.model.tp_unsupported_reason(mesh.shape[self.tp_axis])
            if reason is not None:
                raise ValueError(f"dp_mode='tp': {reason}")
            d = mesh.shape.get(self.data_axis, 1)
            if cfg.batch_size % d:
                raise ValueError(
                    f"dp×tp shards the batch over the {d}-way {self.data_axis!r} axis: "
                    f"batch_size {cfg.batch_size} must divide")
            return "tp"
        if cfg.dp_mode == "ep":
            if self.model.moe_experts is None:
                raise ValueError("dp_mode='ep' requires a MoE model (moe_experts=E)")
            if self.expert_axis not in mesh.shape:
                raise ValueError(
                    f"dp_mode='ep' needs a {self.expert_axis!r} mesh axis: {dict(mesh.shape)}")
            shards = mesh.shape[self.expert_axis] * (
                mesh.shape[self.data_axis] if self._dp_axis() is not None else 1)
            if cfg.batch_size % shards:
                raise ValueError(
                    f"dp_mode='ep' shards the batch {shards} ways: batch_size "
                    f"{cfg.batch_size} must divide")
            return "ep"
        if cfg.dp_mode == "pp":
            if self.stage_axis not in mesh.shape:
                raise ValueError(
                    f"dp_mode='pp' needs a {self.stage_axis!r} mesh axis: {dict(mesh.shape)}")
            m = self.pp_microbatches
            if cfg.batch_size % m:
                raise ValueError(
                    f"dp_mode='pp' splits the batch into {m} microbatches: batch_size "
                    f"{cfg.batch_size} must be divisible")
            d = mesh.shape.get(self.data_axis, 1)
            if self._dp_axis() is not None and (cfg.batch_size // m) % d:
                raise ValueError(
                    f"dp×pp shards each {cfg.batch_size // m}-row microbatch over the {d}-way "
                    f"{self.data_axis!r} axis: sizes must divide")
            return "pp"
        if self.data_axis not in mesh.shape:
            raise ValueError(f"mesh has no {self.data_axis!r} axis: {dict(mesh.shape)}")
        if cfg.batch_size % mesh.shape[self.data_axis]:
            raise ValueError(
                f"dp shards the batch over {self.data_axis!r}: batch_size {cfg.batch_size} "
                f"must be divisible by the axis size {mesh.shape[self.data_axis]}")
        return "zero" if cfg.dp_mode == "zero" else "dp"

    def _dp_axis(self) -> str | None:
        """The data axis to compose with sp, ep or pp: on the mesh, or
        None."""
        return self.data_axis if self.data_axis in self.mesh.shape else None

    def _make_step(self):
        """``step(params, opt_state, tokens, lengths) -> (params, opt_state,
        loss)`` of the mode, on the global batch (async and diloco key their
        exchange on the state's step count)."""
        if self.mode == "single":
            return make_lm_train_step(self.model, self.optimizer)
        if self.mode == "dp":
            return make_lm_train_step(self.model, self.optimizer, self.mesh, self.data_axis)
        if self.mode == "zero":
            self._specs, _, mapped = make_lm_zero_parts(self.model, self.optimizer, self.mesh,
                                                        self.data_axis)
            return mapped
        if self.mode in ("async", "diloco"):
            cfg = self.config
            if self.mode == "async":
                self._init_copies, mapped = make_lm_async_parts(
                    self.model, self.optimizer, self.mesh, axis=self.data_axis,
                    # async_avg_every=0 means never: an unreachable period.
                    avg_every=cfg.async_avg_every or (1 << 30),
                    update_scale=self.async_update_scale, ragged=self._ragged)
            else:
                # The mailbox gang's round is a host step (_maybe_mailbox_round):
                # the in-graph exchange never fires (an unreachable period),
                # while the engine keeps the residual the host round updates.
                kw = dict(sync_every=(1 << 30) if self.delta_exchange is not None
                          else cfg.sync_every, outer_lr=cfg.outer_lr,
                          outer_momentum=cfg.outer_momentum, ragged=self._ragged,
                          delta_dtype=cfg.delta_dtype, overlap=cfg.delta_overlap)
                if self.mesh is not None:
                    self._init_copies, mapped = local_sgd.make_lm_diloco_parts(
                        self.model, self.optimizer, self.mesh, axis=self.data_axis, **kw)
                else:
                    self._init_copies, mapped = local_sgd.make_lm_diloco_vmapped(
                        self.model, self.optimizer, cfg.diloco_workers, **kw)

            def step(params, opt_state, toks, lens):
                return mapped(params, opt_state, toks, lens, self.state.step)

            return step
        if self.mode == "tp":
            return make_lm_train_step(self.model, self.optimizer, self.mesh, self.data_axis,
                                      tp_axis=self.tp_axis)
        if self.mode == "ep":
            self._specs, _, mapped = make_lm_ep_parts(
                self.model, self.optimizer, self.mesh, self.expert_axis,
                data_axis=self._dp_axis(), ragged=self._ragged)
            return mapped
        if self.mode == "pp":
            self._specs, _, mapped = make_lm_pp_parts(
                self.model, self.optimizer, self.mesh, axis=self.stage_axis,
                num_microbatches=self.pp_microbatches, data_axis=self._dp_axis())
            return mapped
        return make_lm_sp_parts(self.model, self.optimizer, self.mesh, self.seq_axis,
                                data_axis=self._dp_axis(), attention=self.sp_attention,
                                ragged=self._ragged)

    # -- pieces -----------------------------------------------------------

    def _init_state(self, params) -> TrainState:
        """A fresh state at the canonical ``params``: this rank's blocks of
        them under tp and ep, its stage of the staged blocks under pp, the
        optimizer's initial state (its slots born in that layout), step 0."""
        if self.mode in ("async", "diloco"):
            return TrainState(*self._init_copies(params, self.optimizer.init(params)))
        if self.mode == "pp":
            params = map_split(params, self._specs, self._stage_split)
        if self._specs is not None:
            params = shard_tree(params, self._specs, self.mesh)
        return TrainState(params, self.optimizer.init(params), 0)

    def _stage_split(self, a):
        """A canonical [num_layers, ...] block leaf as [S, L/S, ...]."""
        s = self.mesh.shape[self.stage_axis]
        return a.reshape((s, a.shape[0] // s) + tuple(a.shape[1:]))

    @staticmethod
    def _stage_merge(a):
        return a.reshape((-1,) + tuple(a.shape[2:]))

    def _copies_on_mesh(self) -> bool:
        """Whether the state is a copy a rank (async, diloco on a mesh)."""
        return self.mode == "async" or (self.mode == "diloco" and self.mesh is not None)

    def _merge(self, tree):
        """A tree of copies → one copy: float leaves at their mean, integer
        leaves checked equal (``merge_replica_leaf``); on the mesh a
        collective over ``data_axis``, on one device over the stack."""
        if self._copies_on_mesh():
            return tree_map(lambda a: merge_replica_leaf(a, self.mesh, self.data_axis), tree)

        def one(a):
            if not isinstance(a, torch.Tensor):
                return a
            if a.is_floating_point():
                return a.mean(0)
            if not torch.equal(a.amax(0), a.amin(0)):
                raise ValueError(
                    "integer optimizer-state leaf differs across workers; refusing to merge "
                    "(the copies should be identical)")
            return a[0].clone()

        return tree_map(one, tree)

    def to_canonical(self, state: TrainState | None = None) -> TrainState:
        """The single-device form of ``state`` (default the trainer's): under
        tp, ep and zero the parameters and optimizer slots gathered from
        every rank's blocks (a collective of the axis), under pp gathered
        and unstaged; under async and diloco the copies and their (inner)
        optimizer states merged at the mean (:meth:`_merge`; diloco's outer
        state has no canonical form and is left out, as in JAX :970-986);
        the other modes hold it already."""
        state = self.state if state is None else state
        if self.mode == "async":
            return TrainState(self._merge(state.params), self._merge(state.opt_state),
                              int(state.step))
        if self.mode == "diloco":
            return TrainState(self._merge(state.params), self._merge(state.opt_state.inner),
                              int(state.step))
        if self._specs is None:
            return state
        slots = match_slot_specs(state.opt_state, state.params, self._specs)
        params = gather_tree(state.params, self._specs, self.mesh)
        opt_state = gather_tree(state.opt_state, slots, self.mesh)
        if self.mode == "pp":
            params = map_split(params, self._specs, self._stage_merge)
            opt_state = map_split(opt_state, slots, self._stage_merge)
        return TrainState(params, opt_state, state.step)

    def from_canonical(self, canonical: TrainState) -> TrainState:
        """A single-device state as this trainer's (this rank's blocks
        under tp, ep and zero, its stage under pp, a copy a worker under
        async and diloco, where a fresh outer round starts at the
        parameters: θ_start a copy of them, zero momentum and residual,
        nothing in flight), on its device; set it as ``self.state`` to
        resume."""
        on = lambda t: tree_map(  # noqa: E731
            lambda a: a.to(self.device) if isinstance(a, torch.Tensor) else a, t)
        params, opt_state = on(canonical.params), on(canonical.opt_state)
        if self.mode in ("async", "diloco"):
            p, o, _ = self._init_copies(params, opt_state)
            return TrainState(p, o, int(canonical.step))
        if self._specs is not None:
            slots = match_slot_specs(opt_state, params, self._specs)
            if self.mode == "pp":
                params = map_split(params, self._specs, self._stage_split)
                opt_state = map_split(opt_state, slots, self._stage_split)
                slots = match_slot_specs(opt_state, params, self._specs)
            params = shard_tree(params, self._specs, self.mesh)
            opt_state = shard_tree(opt_state, slots, self.mesh)
        return TrainState(params, opt_state, int(canonical.step))

    def _eval_params(self):
        """The parameters the held-out metric is computed at (JAX
        ``_eval_params``): under ep, pp and zero the canonical ones, gathered
        over the axis (pp's staged blocks folded back; a collective); under
        async and diloco the mean of the copies (on a mesh a collective);
        the state's own otherwise (tp's blocks run the tensor-parallel
        forward)."""
        if self._copies_on_mesh():
            p = self.state.params
            return tree_unflatten(p, self.mesh.mean_(tree_leaves(p), self.data_axis))
        if self.mode == "diloco":
            return tree_map(lambda a: a.mean(0), self.state.params)
        if self.mode not in ("ep", "pp", "zero"):
            return self.state.params
        params = gather_tree(self.state.params, self._specs, self.mesh)
        return pipeline_unstage_params(params) if self.mode == "pp" else params

    @property
    def global_step(self) -> int:
        return int(self.state.step)

    def _stage(self, name: str, arr) -> torch.Tensor:
        """Host array → device tensor, staged once and reused across epochs
        and evals (keyed by name, checked by identity)."""
        hit = self._stage_cache.get(name)
        if hit is None or hit[0] is not arr:
            staged = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            self._stage_cache[name] = hit = (arr, staged)
        return hit[1]

    def _train_step(self, toks, lens):
        """One update on a device batch; returns the cost (on the device)."""
        params, opt_state, cost = self._step(
            self.state.params, self.state.opt_state, toks, lens
        )
        self.state = TrainState(params, opt_state, self.state.step + 1)
        return cost

    def _mean_costs(self, costs: torch.Tensor) -> torch.Tensor:
        """Costs of the rank's own steps → their mean over the ranks when
        the copies are a rank's (a collective), else as they are."""
        if not self._copies_on_mesh():
            return costs
        return self.mesh.mean_([costs.detach().float().reshape(-1)],
                               self.data_axis)[0].reshape(costs.shape)

    def _ce_count(self, params, toks, lens):
        """(CE · target count, target count) of one token block, masked when
        ragged (the count then a device tensor): the one eval arithmetic of
        :meth:`evaluate` and the compiled run."""
        if self._ragged:
            ce = self.model.loss(params, toks, lens, self._tp)
            count = torch.clamp(lens.long() - 1, min=0).sum()
        else:
            ce = self.model.loss(params, toks, tp=self._tp)
            count = toks.shape[0] * (toks.shape[1] - 1)
        return ce * count, count

    @torch.no_grad()
    def _eval_sums(self, toks, lens, *, trim: bool = False):
        """Held-out sums at the current parameters, on the device: (Σ CE ·
        count as f64, Σ count as int64) over ``eval_batch``-row chunks, added
        in order. ``trim`` drops the rows past the last whole chunk (the
        compiled run's eval, as in the JAX package); else a smaller last
        chunk covers the whole split."""
        n = toks.shape[0]
        b = min(self.eval_batch, n)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = torch.zeros((), dtype=torch.int64, device=self.device)
        params = self._eval_params()
        for lo in range(0, (n // b) * b if trim else n, b):
            hi = min(lo + b, n)
            s, c = self._ce_count(
                params, toks[lo:hi], None if lens is None else lens[lo:hi]
            )
            total = total + s.double()
            count = count + c
        return total, count

    @staticmethod
    def _perplexity(total, count) -> float:
        """exp(total / count) on the host, from fetched sums."""
        return float(np.exp(float(total) / max(int(count), 1)))

    def _split_arrays(self, split: str):
        """A split's tokens (and lengths when ragged), staged on the device."""
        ds = getattr(self.datasets, split)
        lens = self._stage(f"{split}_lengths", ds.lengths) if self._ragged else None
        return self._stage(f"{split}_tokens", ds.tokens), lens

    def evaluate(self, split: str = "validation") -> float:
        """Held-out perplexity = exp(total next-token CE / total targets),
        over the whole split in ``eval_batch``-row chunks."""
        return self._perplexity(*self._eval_sums(*self._split_arrays(split)))

    # -- the loop ---------------------------------------------------------

    def _draw_indices(self, epochs: int, steps: int) -> torch.Tensor:
        """``[epochs, steps, batch]`` train indices from the split's own
        ``next_indices`` stream (the batches ``next_batch`` would give), on
        the device."""
        train, b = self.datasets.train, self.config.batch_size
        idxs = np.stack([np.stack([train.next_indices(b) for _ in range(steps)])
                         for _ in range(epochs)])
        return torch.from_numpy(idxs.astype(np.int64)).to(self.device)

    def _epoch_steps(self, idxs, toks_all, lens_all):
        """One epoch on the device, the loop :meth:`run` and
        :meth:`run_compiled` share: each row of ``idxs`` gathers its batch
        and takes a step. Yields ``(i, cost)``, the cost on the device."""
        for i in range(idxs.shape[0]):
            lens = None if lens_all is None else lens_all.index_select(0, idxs[i])
            cost = self._train_step(toks_all.index_select(0, idxs[i]), lens)
            if self.delta_exchange is not None:
                self._maybe_mailbox_round(int(self.state.step))
            yield i, cost

    def _end_epoch(self, logger: StepLogger, epoch: int, perplexity: float, step: int) -> None:
        if self.is_chief:
            logger.log_epoch_metric("Test-Perplexity", perplexity)
            self._add_scalar("perplexity", perplexity, step)
        self.history.append({"epoch": epoch + 1, "perplexity": perplexity, "step": step})

    def _finish(self, logger: StepLogger, perplexity: float, final_cost=None) -> dict:
        if final_cost is None:
            final_cost = float("nan") if self.last_cost is None else float(self.last_cost)
        if self.is_chief:
            logger.log_final(cost=final_cost)
            # The end of a run (JAX :1494-1498): summaries to disk, the
            # metrics snapshot into the journal, the journal synced.
            if self.summary_writer is not None:
                self.summary_writer.flush()
            self.metrics.flush_to(self.journal, component="lm_trainer")
            self.journal.flush()
        return {
            "perplexity": perplexity,
            "final_cost": final_cost,
            "global_step": self.global_step,
        }

    def run_epoch(self, epoch: int, logger: StepLogger) -> None:
        steps = self.datasets.train.num_examples // self.config.batch_size
        step_before = self.global_step
        logger.reset_window()
        t_epoch = time.time()
        cost = None
        # With the anomaly guard armed, every step's cost is kept on the
        # device and fetched once at the epoch's end (the guard judges them
        # all, as the JAX scanned epoch's); else only the last is read.
        kept = [] if self.config.max_rollbacks else None
        self._epoch_costs = None
        for i, cost in self._epoch_steps(self._draw_indices(1, steps)[0],
                                         *self._split_arrays("train")):
            if kept is not None:
                kept.append(cost.detach().reshape(()))
            if logger.is_due(i + 1, steps):  # the fetch waits for the device
                host_cost = float(self._mean_costs(cost))
                logger.maybe_log_step(
                    step=step_before + i + 1, epoch=epoch, batch=i,
                    batch_count=steps, cost=host_cost,
                )
                self._add_scalar("cost", host_cost, step_before + i + 1)
        if kept:
            self._epoch_costs = self._mean_costs(torch.stack(kept).float()).cpu().numpy()
            self.last_cost = float(self._epoch_costs[-1])
        elif cost is not None:
            self.last_cost = float(self._mean_costs(cost))
        self._observe_step_time((time.time() - t_epoch) * 1000 / max(steps, 1))
        self._emit_comm_stats(epoch=epoch, steps=steps, count_before=step_before)

    # -- telemetry --------------------------------------------------------

    def _add_scalar(self, tag: str, value: float, step: int) -> None:
        """A tfevents scalar on the chief (``value`` already on the host)."""
        if self.summary_writer is not None and self.is_chief:
            self.summary_writer.add_scalar(tag, value, step)

    def _observe_step_time(self, avg_ms: float) -> None:
        """An epoch's mean step time into the ``step_time_ms`` histogram
        (JAX :1859-1868)."""
        self.metrics.histogram("step_time_ms", edges=TIME_MS_EDGES).observe(float(avg_ms))

    def _gang_size(self) -> int:
        """Workers in the data-parallel gang (1 when there is none): the
        data axis's size, or the emulated DiLoCo gang's width (JAX :852)."""
        if self.mesh is not None and self.data_axis in self.mesh.shape:
            return int(self.mesh.shape[self.data_axis])
        if self.mode == "diloco":
            if self.delta_exchange is not None:
                return int(self.delta_exchange.world)
            return int(self.config.diloco_workers)
        return 1

    def _emit_comm_stats(self, *, epoch: int, steps: int, count_before: int) -> None:
        """An epoch's communication accounting (JAX :1687-1750), counted on
        the host from the step counts, not measured: the gang's sync rounds
        (dp: one a step; DiLoCo: one every ``sync_every`` steps), the bytes
        they all-reduce (a dense parameter set a round) and what a round
        puts on the wire (the dense set, or its per-tensor codes under
        ``delta_dtype``). One ``comm_stats`` event and three counters;
        the other modes' traffic is not a parameter-sized all-reduce a
        round and is left out, as in the JAX trainer."""
        if self.mode not in ("dp", "diloco") or steps <= 0:
            return
        if self.mode == "diloco":
            h = self.config.sync_every
            rounds = local_sgd.sync_rounds_between(count_before, count_before + steps, h)
        else:
            h, rounds = 1, steps
        if not hasattr(self, "_dense_param_nbytes"):
            shapes = self.model.init(seed=0, device="meta")
            self._dense_param_nbytes = local_sgd.params_nbytes(shapes)
            self._delta_payload_nbytes = local_sgd.delta_payload_nbytes(
                shapes, self.config.delta_dtype if self.mode == "diloco" else None)
        nbytes = rounds * self._dense_param_nbytes
        payload = rounds * self._delta_payload_nbytes
        self.journal.emit(
            "comm_stats",
            epoch=int(epoch),
            mode=self.mode,
            steps=int(steps),
            sync_every=int(h),
            sync_rounds=int(rounds),
            allreduce_bytes=int(nbytes),
            payload_bytes=int(payload),
            delta_dtype=self.config.delta_dtype if self.mode == "diloco" else None,
            overlap=bool(self.mode == "diloco" and self.config.delta_overlap),
            workers=int(self._gang_size()),
        )
        self.metrics.counter("sync_rounds_total").inc(int(rounds))
        self.metrics.counter("allreduce_bytes_total").inc(int(nbytes))
        self.metrics.counter("payload_bytes_total").inc(int(payload))

    def _maybe_write_graph(self) -> None:
        # Once per trainer, on the chief: one graph a run.
        if self.summary_writer is not None and self.is_chief and not self._graph_written:
            self.write_graph()
            self._graph_written = True

    def write_graph(self) -> None:
        """The mode's train step as the TensorBoard graph (the reference's
        ``FileWriter(graph=...)``, ``tfsingle.py:69``): traced by
        ``make_fx`` on fake tensors over an uninitialized token batch of
        the training shape, so nothing runs on the device and the index
        stream does not move. The flash kernels are one node each way
        (``dtf.FlashAttention``, ``dtf.FlashAttentionBackward``)."""
        train = self.datasets.train
        rows = (self.config.batch_size,)
        dtype = torch.from_numpy(train.tokens[:0]).dtype
        toks = torch.empty(rows + tuple(train.tokens.shape[1:]), dtype=dtype, device=self.device)
        lens = None
        if self._ragged:
            lens = torch.empty(rows, dtype=torch.from_numpy(train.lengths[:0]).dtype,
                               device=self.device)
        self.summary_writer.add_graph(self._step, self.state.params, self.state.opt_state,
                                      toks, lens)

    def run_compiled(self, epochs: int | None = None, *, epoch_offset: int = 0,
                     finalize: bool = True) -> dict:
        """The whole run with no host round trip until its end (the JAX
        ``run_compiled``): :meth:`run`'s epoch loop over indices drawn for
        every epoch up front, each epoch's perplexity from
        :meth:`_eval_sums` over whole chunks, the costs and sums fetched
        once afterwards and printed as :meth:`run`'s lines (a uniform
        AvgTime). Where ``eval_batch`` divides the split, each epoch's
        perplexity is :meth:`evaluate`'s bit for bit. The returned
        perplexity is :meth:`evaluate`'s over the whole split. With a
        supervisor the dispatch ends in a save (skipped, with a
        ``rollback_compiled`` line, when a cost is not finite and the guard
        is armed). ``epoch_offset`` shifts the epoch numbers and
        ``finalize=False`` leaves out the final evaluation and line: the
        ``epochs_per_dispatch`` tier's chunks (JAX :1327-1503). Refused
        with ``delta_exchange`` (its round is a host step inside every
        epoch). One trace id (the caller's, when it runs inside one); a
        finalizing call returns once its save is on disk."""
        if self.delta_exchange is not None:
            raise ValueError(
                "run_compiled does not compose with delta_exchange: the mailbox round is a "
                "host decision point inside every epoch; use run()")
        with tracing.trace(tracing.current_trace()):
            try:
                return self._run_compiled(epochs, epoch_offset=epoch_offset, finalize=finalize)
            finally:
                if finalize and self.supervisor is not None:
                    self.supervisor.wait_pending()
                    self._barrier()

    def _run_compiled(self, epochs: int | None = None, *, epoch_offset: int = 0,
                      finalize: bool = True) -> dict:
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        steps = self.datasets.train.num_examples // cfg.batch_size
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn, journal=self.journal)
        if epochs * steps == 0:
            return self._finish(logger, self.evaluate("validation"), float("nan"))
        train, val = self._split_arrays("train"), self._split_arrays("validation")
        self._maybe_write_graph()
        idxs = self._draw_indices(epochs, steps)
        step_before = self.global_step
        mark = self.spans.mark()
        costs = torch.empty((epochs, steps), dtype=torch.float32, device=self.device)
        totals = torch.empty(epochs, dtype=torch.float64, device=self.device)
        counts = torch.empty(epochs, dtype=torch.int64, device=self.device)
        t0 = time.time()
        for e in range(epochs):
            for i, cost in self._epoch_steps(idxs[e], *train):
                costs[e, i] = cost
            totals[e], counts[e] = self._eval_sums(*val, trim=True)
        # The run's one fetch; the span runs from the first dispatch to it.
        costs = self.spans.dispatch_fetch("lm_compiled_run", self._mean_costs(costs),
                                          start=mark, epochs=int(epochs))
        totals, counts = totals.cpu().numpy(), counts.cpu().numpy()
        avg_ms = (time.time() - t0) * 1000 / (epochs * steps)
        self._observe_step_time(avg_ms)
        self.last_cost = float(costs[-1, -1])
        for e in range(epochs):
            for i in range(steps):
                if logger.is_due(i + 1, steps):
                    step = step_before + e * steps + i + 1
                    logger.log_step_line(step=step, epoch=epoch_offset + e, batch=i,
                                         batch_count=steps, cost=float(costs[e, i]),
                                         avg_ms=avg_ms)
                    self._add_scalar("cost", float(costs[e, i]), step)
            self._emit_comm_stats(epoch=epoch_offset + e, steps=steps,
                                  count_before=step_before + e * steps)
            self._end_epoch(logger, epoch_offset + e, self._perplexity(totals[e], counts[e]),
                            step_before + (e + 1) * steps)
        if self.supervisor is not None:
            self.supervisor.report_progress(self.global_step)
            if cfg.max_rollbacks and not np.isfinite(costs).all():
                # One dispatch cannot roll back inside itself; a poisoned
                # state must not land over the last good checkpoint.
                if self.is_chief:
                    lifecycle_event("rollback_compiled", print_fn=self.print_fn,
                                    journal=self.journal)
            else:
                self._save()
        if not finalize:
            return {"perplexity": self._perplexity(totals[-1], counts[-1]),
                    "final_cost": self.last_cost, "global_step": self.global_step}
        return self._finish(logger, self.evaluate("validation"))

    def _run_chunked(self, epochs: int) -> dict:
        """The k-epochs-per-dispatch tier (``config.epochs_per_dispatch``,
        JAX :1505-1554): :meth:`run_compiled` a chunk at a time, a
        checkpoint after each dispatch, ``should_stop`` at the boundaries;
        a chunk that went NaN is rolled back and retried on the next index
        window."""
        import math

        k = self.config.epochs_per_dispatch
        guard = AnomalyGuard.from_config(self.config)
        res = {"perplexity": float("nan"), "final_cost": float("nan"),
               "global_step": self.global_step}
        done = 0
        while done < epochs:
            n = min(k, epochs - done)
            last = done + n >= epochs
            step_before = self.global_step
            res = self.run_compiled(n, epoch_offset=done, finalize=last)
            if (guard is not None and not math.isfinite(res["final_cost"])
                    and res["global_step"] > step_before):
                self._anomaly_rollback(guard, "nan", done)
                continue
            done += n
            if self.supervisor is not None and self.supervisor.should_stop:
                if not last:
                    res["perplexity"] = self.evaluate("validation")
                    if self.is_chief:
                        StepLogger(freq=self.config.log_frequency, print_fn=self.print_fn,
                                   journal=self.journal).log_final(cost=res["final_cost"])
                        if self.summary_writer is not None:
                            self.summary_writer.flush()
                break
        return res

    def _anomaly_rollback(self, guard: AnomalyGuard, kind: str, epoch: int) -> None:
        """Restore the newest valid checkpoint after an anomalous epoch,
        keeping the index stream where it is (the offending window is
        skipped); with no checkpoint yet, the seed's fresh state. Raises
        :class:`AnomalyError` once ``max_rollbacks`` is spent (JAX
        :1870-1908)."""
        detected_step = self.global_step
        if self.supervisor is None or guard.exhausted:
            raise AnomalyError(
                f"anomalous cost (kind={kind}) at epoch {epoch} step "
                f"{detected_step} with no rollback budget left "
                f"({guard.rollbacks}/{guard.max_rollbacks} used"
                + ("" if self.supervisor else "; no supervisor") + ")"
            )
        guard.rollbacks += 1
        self.metrics.counter("rollbacks_total").inc()
        fresh = self._init_state(self.model.init(seed=self.config.seed, device=self.device))
        self.state, restored_step = self._restore_own(fresh)
        self.last_cost = None
        if self.is_chief:
            lifecycle_event(
                "rollback",
                print_fn=self.print_fn,
                journal=self.journal,
                writer=self.summary_writer,
                scalar=("rollback", float(restored_step), detected_step),
                anomaly=kind,
                epoch=epoch,
                detected_step=detected_step,
                restored_step=restored_step,
                rollback=guard.rollbacks,
                max_rollbacks=guard.max_rollbacks,
            )

    def _maybe_mailbox_round(self, count: int) -> None:
        """The mailbox gang's outer round (JAX :1752-1857), every
        ``sync_every`` steps on the host count: post this member's delta
        θ_start − θ (with the residual folded in and kept as what the wire
        lost, under ``delta_dtype``), take the staleness-weighted mean of
        the peers' posts without waiting, apply the outer update
        (``outer_lr`` None scales by the round's total weight), and journal
        a ``delta_exchange`` event; ``mailbox_rounds_total`` and
        ``stale_contributions_total`` count."""
        h = self.config.sync_every
        if h < 1 or count % h:
            return
        t0 = time.perf_counter()
        round_idx = count // h - 1
        d = self.state.opt_state
        p = tree_map(lambda x: x[0], self.state.params)
        delta = tree_map(torch.sub, d.theta, p)
        np_leaves = [x.detach().float().cpu().numpy() for x in tree_leaves(delta)]
        residual = d.residual
        dev = self.device
        if self.config.delta_dtype is not None:
            r_leaves = [x.detach().float().cpu().numpy() for x in tree_leaves(residual)]
            corr = [a + b for a, b in zip(np_leaves, r_leaves)]
            # post() returns the wire values: the residual keeps what they lost.
            own = self.delta_exchange.post(round_idx, corr)
            residual = tree_unflatten(delta, [torch.from_numpy(a - b).to(dev)
                                              for a, b in zip(corr, own)])
        else:
            own = self.delta_exchange.post(round_idx, np_leaves)
        mean, total_weight, contributors = self.delta_exchange.weighted_delta(round_idx, own)
        mean_delta = tree_unflatten(delta, [torch.from_numpy(x).to(dev) for x in mean])
        eta = (float(total_weight) if self.config.outer_lr is None
               else local_sgd.resolve_outer_lr(self.config.outer_lr, self._gang_size()))
        theta2, m2 = local_sgd.outer_apply(d.theta, mean_delta, d.momentum, outer_lr=eta,
                                           outer_momentum=self.config.outer_momentum)
        new_p = tree_map(lambda x: x.unsqueeze(0).clone(), theta2)
        self.state = TrainState(new_p, d._replace(theta=theta2, momentum=m2, residual=residual),
                                self.state.step)
        stale = [c for c in contributors if c[1] > 0]
        self.journal.emit(
            "delta_exchange",
            round=int(round_idx),
            rank=int(self.delta_exchange.rank),
            world=int(self.delta_exchange.world),
            contributors=[[int(r), int(age), float(w)] for r, age, w in contributors],
            total_weight=float(total_weight),
            outer_lr=float(eta),
            stale_contributions=len(stale),
            delta_dtype=self.config.delta_dtype,
            payload_nbytes=self.delta_exchange.payload_nbytes(round_idx),
            wall_ms=round((time.perf_counter() - t0) * 1000, 3),
        )
        self.metrics.counter("mailbox_rounds_total").inc()
        if stale:
            self.metrics.counter("stale_contributions_total").inc(len(stale))

    def run(self, epochs: int | None = None) -> dict:
        """The run: ``epochs`` epochs (default the config's), each
        evaluated, under one ambient trace id and the preemption contract
        (SIGTERM/SIGINT: a stop at the next boundary with a final save);
        returns once every save is on disk (JAX :1910-1935)."""
        arm_stall_dump()  # $DTF_STALL_DUMP, or nothing
        with tracing.trace(tracing.current_trace()), preemption_guard(
            self.supervisor, enabled=self.config.handle_preemption, print_fn=self.print_fn,
            journal=self.journal,
        ):
            try:
                return self._run(epochs)
            finally:
                if self.supervisor is not None:
                    self.supervisor.wait_pending()
                    self._barrier()

    def _barrier(self) -> None:
        """On a mesh of several ranks, wait for every rank: after the
        chief's final save has committed, so a rank that restores next
        reads it."""
        import torch.distributed as dist

        if self.mesh is not None and self.mesh.size > 1 and dist.is_initialized():
            dist.barrier()

    def _run(self, epochs: int | None = None) -> dict:
        cfg = self.config
        if cfg.compiled_run:
            return self.run_compiled(epochs)
        epochs = cfg.epochs if epochs is None else epochs
        if cfg.epochs_per_dispatch:
            return self._run_chunked(epochs)
        self._maybe_write_graph()
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn, journal=self.journal)
        guard = AnomalyGuard.from_config(cfg)
        perplexity = float("nan")
        epoch, profiled = 0, False
        while epoch < epochs:
            if epoch == 0 and cfg.profile_dir and not profiled:
                from distributed_tensorflow_tpu_torch.utils import profiler

                profiled = True
                with profiler.trace(cfg.profile_dir, self.spans, device=self.device):
                    self.run_epoch(epoch, logger)
            else:
                self.run_epoch(epoch, logger)
            if guard is not None:
                # Judged before the eval and the save (every rank alike).
                cost = float(self.last_cost) if self.last_cost is not None else float("nan")
                kind = guard.classify(cost, costs=self._epoch_costs)
                if kind is not None:
                    self._anomaly_rollback(guard, kind, epoch)
                    continue  # this epoch index again, on the next window
                guard.record(cost)
            self.metrics.counter("epochs_total").inc()
            perplexity = self.evaluate("validation")
            self._end_epoch(logger, epoch, perplexity, self.global_step)
            if self.supervisor is not None:
                self.supervisor.report_progress(self.global_step)
                self._save()
                if self.supervisor.should_stop:
                    break
            epoch += 1
        return self._finish(logger, perplexity)
