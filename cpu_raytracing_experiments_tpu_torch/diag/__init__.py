"""Diagnostics of the port's kernels: the counterparts of the JAX package's
``benchmarks/diag_*.py`` tools that reach a TPU kernel."""
