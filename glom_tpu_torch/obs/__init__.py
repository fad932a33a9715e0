"""Observability of the port: the train step's numerics summary."""
