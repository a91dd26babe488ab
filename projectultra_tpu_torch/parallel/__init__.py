"""The sweep harness and frame-axis data parallelism (port of
projectultra_tpu/parallel): ``sweep`` runs the regression matrix,
``mesh`` splits a frame batch over ``torch.distributed`` ranks, ``dcn``
is the acquisition sweep whose counts do not depend on the topology, and
``dryrun`` runs the multi-rank dry run."""
