"""Training: losses, learning-rate schedule, Adam, densification
statistics and the training step."""
