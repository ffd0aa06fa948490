"""Language-model training and generation on the copy task: the port's
``examples/lm.py``.

Trains a small GPT through :class:`~train.lm_trainer.LMTrainer` (the
reference loop's Step/Cost/AvgTime lines, a held-out perplexity an epoch)
on the synthetic copy task (sequences ``x · x``: the model must attend back
and reproduce the first half), then continues a held-out prompt greedily,
by sampling and by beam search. ``DTF_LM_FLASH=1`` runs the causal
attention on the flash kernels. ``DTF_LM_CKPT=dir`` checkpoints each epoch
into ``dir`` and resumes from its newest valid step.

Run: ``python -m distributed_tensorflow_tpu_torch.examples.lm [epochs]
[max_new] [device]`` (the device defaults to cuda; pass ``cpu`` to run the
plain versions on the CPU).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer


def main(epochs: int = 8, max_new: int = 16, device=None, print_fn=print) -> dict:
    datasets = copy_corpus(num=4096, half_len=8, vocab=61, seed=0)
    model = GPTLM(vocab_size=61, max_len=48, model_dim=64, num_heads=4, num_layers=2,
                  compute_dtype=torch.float32,
                  attention_impl="flash" if os.environ.get("DTF_LM_FLASH") else "xla",
                  flash_min_len=0)  # the corpus is toy-length; keep the knob real
    trainer = LMTrainer(model, datasets,
                        TrainConfig(epochs=epochs, batch_size=64, optimizer="adam",
                                    learning_rate=3e-3, log_frequency=20,
                                    checkpoint_dir=os.environ.get("DTF_LM_CKPT") or None),
                        device=device, print_fn=print_fn)
    result = trainer.run()
    print_fn(f"held-out perplexity: {result['perplexity']:.2f}")

    params = trainer.state.params
    half = np.random.default_rng(1).integers(0, 61, size=(2, 8))
    # The first half and 2 copied tokens: the model should continue the copy.
    prompt = torch.from_numpy(np.concatenate([half, half[:, :2]], axis=1).astype(np.int64)
                              ).to(trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    greedy = model.greedy_decode(params, prompt, max_new)
    sampled = model.sample_decode(params, prompt, max_new, gen, temperature=0.7, top_k=8,
                                  top_p=0.95)
    beam = model.beam_decode(params, prompt, max_new, 4)
    ncheck = min(6, max_new)
    copied = greedy[:, 10:10 + ncheck].cpu().numpy()
    accuracy = float((copied == half[:, 2:2 + ncheck]).mean())
    print_fn(f"greedy continuation:  {greedy[0, 10:].tolist()}")
    print_fn(f"sampled continuation: {sampled[0, 10:].tolist()}")
    print_fn(f"beam-4 continuation:  {beam[0, 10:].tolist()}")
    print_fn(f"copy-accuracy (greedy): {accuracy:.2f}")
    print_fn("Done")
    return {**result, "copy_accuracy": accuracy}


if __name__ == "__main__":
    ints = [int(a) for a in sys.argv[1:3]]
    main(*ints, *sys.argv[3:4])
