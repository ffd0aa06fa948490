"""Model families of the port: the GPT LM, serving and training
(``gpt``), and the reference MLP (``mlp``)."""
