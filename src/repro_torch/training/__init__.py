"""Training of the port: optimizer, data, checkpoints and the loop."""
