"""Training of the port: the train step and forward adapters (``step.py``),
checkpoints, the epoch trainer and the CLI (``python -m
cruse_tpu_torch.train``)."""
