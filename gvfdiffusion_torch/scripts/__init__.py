"""Video preprocessing: frames -> DINOv2 tokens."""
