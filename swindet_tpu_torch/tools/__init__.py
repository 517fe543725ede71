"""Command-line tools of the port: ``python -m swindet_tpu_torch.tools.test``
and ``python -m swindet_tpu_torch.tools.train``."""
