"""Data helpers of the port: the tokenizers, document packing and the text
corpus (``text``), the MNIST loader (``mnist``) and the token corpora of
the LM family (``tokens``)."""

from distributed_tensorflow_tpu_torch.data.text import (  # noqa: F401
    BPETokenizer,
    ByteTokenizer,
    pack_documents,
    synthetic_documents,
    text_corpus,
)
