"""Batched prediction from trained parameters.

Counterpart of ``distributed_tensorflow_tpu/inference.py`` ``Predictor``:
take the parameters of a live training state or of a checkpoint
(:meth:`Predictor.from_checkpoint`), and stream inputs of any size through the model's forward in chunks of
``batch_size``, the tail zero-padded, so that every call sees one input
shape (the JAX package compiles once for it; here it keeps the kernels'
launch shapes fixed). It serves every family of ``MODEL_REGISTRY``, on
``cuda`` unless ``device="cpu"`` is asked for.

Under async data parallelism a rank's state holds its own copy, under
ZeRO or tensor parallelism its blocks; ``Strategy.effective_params``
collapses the copies at their mean or gathers the blocks into the
canonical parameters (a collective), which the predictor serves.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.ops import losses as losses_lib


class Predictor:
    """Fixed-shape batched prediction over a trained parameter set."""

    def __init__(self, model, params, *, batch_size: int = 1024, device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model = model
        self.device = resolve_device(device)
        self.params = type(params)(*(p.detach().to(self.device) for p in params))
        self.batch_size = batch_size

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_state(cls, model, state, *, strategy=None, **kw) -> "Predictor":
        """Build from a live training state. Pass the training ``strategy``
        so that an async state's per-rank copies collapse correctly (and a
        sharded state's blocks are gathered)."""
        if strategy is not None:
            params = strategy.effective_params(state)
        else:
            # An async state's step is every rank's count, a tuple
            # (parallel/strategy.py AsyncDataParallel.init_state): its
            # params are this rank's copy, not the parameters to serve.
            if isinstance(state.step, tuple):
                raise ValueError(
                    "state holds one rank's parameter copy of several (async DP); pass "
                    "strategy= so effective_params can collapse the per-rank copies"
                )
            params = state.params
        return cls(model, params, **kw)

    @classmethod
    def from_checkpoint(cls, model, checkpoint_dir: str, *, optimizer=None, seed: int = 1,
                        **kw) -> "Predictor":
        """Serve the newest checkpoint in ``checkpoint_dir`` (written by
        ``train/supervisor.py``), of any strategy's layout: the sidecar
        says which; an async checkpoint's stacked copies collapse at their
        mean (the parameters async evaluates at). ``optimizer`` must be
        the training one (the checkpoint holds its slots); the default is
        the reference's SGD, which has none. The directory is probed
        first and never created: no checkpoint raises
        ``FileNotFoundError`` (JAX :63-119)."""
        from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
        from distributed_tensorflow_tpu_torch.ops.optim import tree_map
        from distributed_tensorflow_tpu_torch.parallel.strategy import (
            TrainState,
            merge_stacked_leaf,
        )
        from distributed_tensorflow_tpu_torch.train.supervisor import (
            Supervisor,
            latest_checkpoint_step,
        )

        step = latest_checkpoint_step(checkpoint_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        optimizer = optimizer or optim_lib.sgd(0.001)
        params = model.init(seed, device="cpu")
        fresh = TrainState(params, optimizer.init(params), 0)
        sup = Supervisor(checkpoint_dir=checkpoint_dir)
        meta = sup.saved_layout(step) or {}
        if meta.get("mode") == "async":
            n = int(meta["replicas"])
            stack = lambda t: tree_map(  # noqa: E731
                lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape))
                if isinstance(a, torch.Tensor) else a, t)
            stacked = sup.restore_raw(step, TrainState(stack(params), stack(fresh.opt_state),
                                                       (0,) * n))
            return cls(model, tree_map(merge_stacked_leaf, stacked.params), **kw)
        state, _ = sup.prepare_or_restore(fresh)
        return cls(model, state.params, **kw)

    # -- prediction --------------------------------------------------------

    @torch.no_grad()
    def predict_proba(self, images) -> np.ndarray:
        """[N, ...] host array → [N, num_classes] f32 probabilities, in
        chunks of ``batch_size`` with a zero-padded tail."""
        images = np.asarray(images, dtype=np.float32)
        n = images.shape[0]
        if n == 0:
            raise ValueError("predict_proba called with an empty batch")
        bs = self.batch_size
        out = []
        for lo in range(0, n, bs):
            chunk = images[lo : lo + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            probs = self.model.apply(self.params, torch.from_numpy(chunk).to(self.device))
            out.append(probs[: bs - pad].float().cpu().numpy())
        return np.concatenate(out)

    def predict(self, images) -> np.ndarray:
        """[N, ...] → [N] int64 predicted class ids."""
        return self.predict_proba(images).argmax(axis=-1)

    def accuracy(self, images, labels_one_hot) -> float:
        """Accuracy over a whole split, the trainer's eval metric."""
        probs = self.predict_proba(images)
        return float(losses_lib.accuracy(torch.from_numpy(probs),
                                         torch.as_tensor(np.asarray(labels_one_hot))))
