"""Diffusion sampling, optimizers and the training loop."""
