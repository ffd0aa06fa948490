"""Model families of the port: the GPT LM's serving subset (``gpt``) and
the reference MLP (``mlp``)."""
