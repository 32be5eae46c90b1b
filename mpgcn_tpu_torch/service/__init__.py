"""Serving: admission gate, micro-batcher, engine."""
