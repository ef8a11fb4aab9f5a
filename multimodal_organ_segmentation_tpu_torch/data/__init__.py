"""Data layer of the port: CSV-driven dataset, synthetic data and the host
loader (the JAX package's ``data/``; the transform graph is not ported yet)."""
