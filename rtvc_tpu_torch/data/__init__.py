"""Training datasets and samplers (numpy; own copies of the JAX package's)."""
