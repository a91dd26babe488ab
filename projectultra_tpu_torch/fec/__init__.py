"""Forward error correction host tables of the PyTorch port."""
