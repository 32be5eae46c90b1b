"""Model modules and the hand-written kernels' wrappers."""
