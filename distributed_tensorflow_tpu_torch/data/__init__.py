"""Data helpers of the port: the byte tokenizer (``text``), the MNIST
loader (``mnist``) and the token corpora of the LM family (``tokens``)."""
