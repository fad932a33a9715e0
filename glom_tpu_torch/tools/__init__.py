"""Command-line tools of the port; each runs as ``python -m glom_tpu_torch.tools.<name>``."""
