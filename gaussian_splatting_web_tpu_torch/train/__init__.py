"""Training: losses, per-group Adam, densification and the training loop."""
