"""Layers of the DiT: embedders, attention parameters, transformer blocks."""
