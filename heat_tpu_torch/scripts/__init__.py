"""Command lines of the multi-process runtime: the local launcher
(``python -m heat_tpu_torch.scripts.launch_multiproc``) and its acceptance
workload (``python -m heat_tpu_torch.scripts.multiproc_trainer``)."""
