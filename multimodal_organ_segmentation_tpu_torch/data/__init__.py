"""Data layer of the port: CSV-driven dataset, synthetic data, the host
loader and the transform graph (the JAX package's ``data/``)."""
