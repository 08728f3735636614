"""Optimizers of the port (the formulas of ``repro.optim.optimizers``)."""
