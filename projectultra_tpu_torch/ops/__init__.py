"""Device operators of the PyTorch port: LDPC, demapping, mixers, kernels."""
