"""Checkpoint conversion from the JAX package."""
