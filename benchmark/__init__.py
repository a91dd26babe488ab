"""The benchmark of the PyTorch/CUDA port (``projectultra_tpu_torch``):
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (``harness.py`` says how a run goes)."""
