"""Model families of the port (slice 1: the GPT LM's serving subset)."""
