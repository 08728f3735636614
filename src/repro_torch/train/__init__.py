"""Train-step builders of the port (``repro.train.steps``, LM part)."""
