"""Data generators of the port (numpy streams, as in the JAX package)."""
