"""Example scripts of the port (``glom_tpu``'s ``examples/``), each run as
``python -m glom_tpu_torch.examples.<name>``."""
