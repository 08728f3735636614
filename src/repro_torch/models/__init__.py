"""Models of the port (the dense decoder LM)."""
