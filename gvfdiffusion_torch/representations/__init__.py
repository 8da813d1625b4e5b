"""Gaussian splats and cameras."""
