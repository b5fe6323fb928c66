"""Training: optimizer, steps, validation, checkpoints."""
