"""Inference rollout."""
