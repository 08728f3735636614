"""Model configurations of the port (the dense LM family)."""
