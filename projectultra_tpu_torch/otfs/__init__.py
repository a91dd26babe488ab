"""OTFS modem (port of projectultra_tpu/otfs)."""
