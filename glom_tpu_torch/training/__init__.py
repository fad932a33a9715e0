"""Training-side helpers of the port (this slice: the checkpoint loader)."""
