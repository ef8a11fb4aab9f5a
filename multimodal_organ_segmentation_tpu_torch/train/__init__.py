"""Training layer of the port: losses, metrics, optimisers, checkpoints and
the trainer (the JAX package's ``train/``)."""
