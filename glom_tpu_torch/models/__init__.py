"""The GLOM model of the port: the functional core (``glom.py``), the
decoder heads (``heads.py``) and the ``nn.Module`` shim (``shim.py``)."""
