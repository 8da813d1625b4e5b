"""The DiT denoiser, the motion VAE decoder and the DINOv2 encoder."""
