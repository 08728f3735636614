"""Train-step builders of the port (``repro.train.steps``: the LM and the
CycleGAN steps) and the round figures of ``repro.train.telemetry``."""
