"""Data, tensor, sequence and pipeline parallelism of the port
(``multihost.py``, ``mesh.py``, ``seqpar.py``, ``pipeline.py``)."""
