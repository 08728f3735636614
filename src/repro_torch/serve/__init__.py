"""Continuous-batching LM serving of the port over a paged KV cache."""
