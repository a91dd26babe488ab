"""Waveform adapters of the PyTorch port (IWaveform over the port's modules)."""
