"""The synthetic image stream (``glom_tpu/training/data.py::synthetic_batches``).

The same numpy stream as the JAX package's: from one seed, both packages
train on the same images.  Batches are NCHW float32 numpy arrays; the
trainer moves them to the card.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_batches(batch_size: int, image_size: int, channels: int = 3,
                      seed: int = 0) -> Iterator[np.ndarray]:
    """Endless deterministic stream of standard-normal images."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.standard_normal((batch_size, channels, image_size, image_size), dtype=np.float32)
