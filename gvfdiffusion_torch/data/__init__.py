"""Training data: the deformation-latent dataset."""
