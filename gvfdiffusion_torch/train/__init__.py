"""The DiT trainer: train state, optimizer and the training step."""
