"""PSK waveforms (port of projectultra_tpu/psk)."""
