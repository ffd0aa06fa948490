"""Data helpers of the port: the byte tokenizer (``text``) and the MNIST
loader (``mnist``)."""
