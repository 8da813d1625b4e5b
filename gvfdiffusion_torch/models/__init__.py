"""The DiT denoiser and the motion VAE decoder."""
