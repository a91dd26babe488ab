"""Channel simulation of the PyTorch port."""
