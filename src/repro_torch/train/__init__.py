"""Training: optimizers, train steps and the trainer."""
