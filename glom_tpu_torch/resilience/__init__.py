"""Resilience of the port: checkpoint integrity and newest-valid fallback."""
