"""Checkpoints of the port, in the JAX package's file format."""
