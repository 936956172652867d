"""Training: the port of the JAX package's ``train/``."""
