"""OFDM PHY of the PyTorch port: modulator, demodulator, frame pipeline."""
