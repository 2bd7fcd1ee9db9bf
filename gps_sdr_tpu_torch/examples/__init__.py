"""Long-run stress tools of the port: examples/soak.py and
examples/endurance.py of the JAX package, on PyTorch."""
