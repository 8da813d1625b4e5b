"""The Gaussian renderer: projection, tile binning, blending."""
