"""Building-block ops of the port: patch embedding, the grouped FF and
consensus attention in plain PyTorch, and the locality mask."""
