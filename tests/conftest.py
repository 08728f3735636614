import os
import sys

# smoke tests and benches must see 1 CPU device (the dry-run entrypoint
# sets its own XLA_FLAGS before importing jax) — ensure src is importable
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels have no CPU mode); skips without one")
