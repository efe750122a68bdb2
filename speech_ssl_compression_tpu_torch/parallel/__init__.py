"""Data- and tensor-parallel training of the port (``multihost.py``,
``mesh.py``). JAX's sequence parallel and pipeline (``seqpar.py``,
``pipeline.py``) are not ported (ROADMAP.md, Queue 1, item 11)."""
