"""Preamble acquisition (port of projectultra_tpu/sync)."""
