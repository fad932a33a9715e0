"""Observability of the port: the train step's numerics summary
(``monitors.py``) and the trainer's phase timer (``timing.py``)."""
