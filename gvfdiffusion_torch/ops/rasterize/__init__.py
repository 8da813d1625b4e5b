"""Tile binning and blending of projected Gaussians."""
