"""GLOM's part-whole read-out (``glom_tpu/hierarchy/``).

The paper's central claim (``PAPER.md``) is that islands of agreement at
each level are a parse of the scene.  This package holds the model side of
the three workloads ``glom_tpu`` serves on it:

  * :mod:`~glom_tpu_torch.hierarchy.parse`: the islanding post-pass, a
    fixed-trip connected-components labelling over the neighbour-cosine
    agreement maps, packed into one float32 row an image; the index
    forward; the threshold grammar; the frame-to-frame island deltas;
  * :mod:`~glom_tpu_torch.hierarchy.index`: the level-aware
    nearest-neighbour index, stdlib + numpy only.

Serving them (``/parse``, ``/similar``, ``/session/parse``) is the serving
engine's part (``serving/engine.py``).
"""

from glom_tpu_torch.hierarchy.parse import (  # noqa: F401
    island_deltas,
    make_index_fn,
    make_pack_fn,
    parse_row_width,
    parse_thresholds,
    unpack_parse,
)
