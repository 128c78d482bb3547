"""Entry-point scripts of the PyTorch port (the serve CLI)."""
