"""Text LM: train on deterministic English-like documents, then generate
text. The port's ``examples/text_lm.py``: tokenizer → ``text_corpus``
(``pack_documents``) → ``LMTrainer`` → greedy, nucleus and beam decoding
→ ``tok.decode``.

Byte-level by default; pass a merge count to train a BPE vocabulary on the
corpus first (pure Python, ``data/text.py``): the same documents then pack
into fewer, higher-entropy tokens. The model is f32 (dense attention) with
4 heads of 24, a head dim the decode kernels are not built for (8, 16, 32,
64, 128), so it decodes on ``engine="xla"``.

Run: ``python -m distributed_tensorflow_tpu_torch.examples.text_lm
[epochs] [max_new] [bpe_merges] [device]`` (the device defaults to cuda;
pass ``cpu`` to run the plain versions on the CPU).
"""

from __future__ import annotations

import sys
import time

import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.data import (
    BPETokenizer,
    ByteTokenizer,
    synthetic_documents,
    text_corpus,
)
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer


def main(epochs: int = 6, max_new: int = 48, bpe_merges: int = 0, device=None,
         print_fn=print) -> dict:
    if bpe_merges:
        t0 = time.perf_counter()
        tok = BPETokenizer.train(synthetic_documents(768, seed=0), num_merges=bpe_merges)
        print_fn(f"trained {len(tok.merges)}-merge BPE vocab ({tok.vocab_size} ids) in "
                 f"{time.perf_counter() - t0:.2f}s")
    else:
        tok = ByteTokenizer()
    datasets = text_corpus(num_docs=768, seq_len=96, n_val=16, n_test=16, seed=0, tokenizer=tok)
    model = GPTLM(vocab_size=tok.vocab_size, max_len=96 + max_new, model_dim=96, num_heads=4,
                  num_layers=3, compute_dtype=torch.float32, decode_engine="xla")
    trainer = LMTrainer(
        model, datasets,
        TrainConfig(epochs=epochs, batch_size=32, optimizer="adam", learning_rate=3e-3,
                    log_frequency=20),
        tokenizer=tok, device=device, print_fn=print_fn,
    )
    result = trainer.run()
    print_fn(f"held-out perplexity: {result['perplexity']:.2f} (uniform = {tok.vocab_size})")

    params = trainer.state.params
    prompt = torch.from_numpy(tok.encode("the model ")[None, :]).to(trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    outs = {
        "greedy": model.greedy_decode(params, prompt, max_new),
        "nucleus": model.sample_decode(params, prompt, max_new, gen, temperature=0.8,
                                       top_p=0.95),
        "beam-4": model.beam_decode(params, prompt, max_new, 4, eos_id=tok.eos_id),
    }
    texts = {k: tok.decode(v[0].cpu().numpy()) for k, v in outs.items()}
    for k, text in texts.items():
        print_fn(f"{k + ':':<9}{text!r}")
    print_fn("Done")
    return {**result, "texts": texts, "vocab_size": tok.vocab_size}


if __name__ == "__main__":
    ints = [int(a) for a in sys.argv[1:4]]
    main(*ints, *sys.argv[4:5])
