"""The ("dp", "tp") mesh on ``torch.distributed`` (``mesh.py``), tensor
parallelism over it (``partition.py``) and the multi-process dry run
(``dryrun.py``)."""
