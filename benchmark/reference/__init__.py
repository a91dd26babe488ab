"""The benchmark's plain reference: what the timed paths should produce,
computed again from the same info bits and normals.

Plain PyTorch and numpy, on any device, float32 with TF32 off.  It
imports nothing of the program, nor JAX: its modules are frozen copies of
the port's plain versions at commit eda5b68 (each names its original),
cut to the paths the benchmark's configurations run, and every table is
built here from the configuration.
"""
