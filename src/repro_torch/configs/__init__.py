"""Model configurations of the port (the LM families and the CycleGAN)."""
