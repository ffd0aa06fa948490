"""Text data helpers of the port (slice 1: the byte tokenizer)."""
