"""Training: losses, learning-rate schedule, Adam, densification, the
training step and its captured windows, checkpoints and the Trainer."""
