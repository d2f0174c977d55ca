"""Training: losses, optimiser, checkpoints and the training loop."""
