"""Core math: RNG, vectors, sampling, color."""
