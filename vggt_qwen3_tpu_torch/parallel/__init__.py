"""Parallelism of the port: the ``(dp, fsdp, tp, pp)`` mesh of ranks
(``mesh.py``), the sharding registry and the gather on use (``sharding.py``),
the GPipe pipeline (``pipeline.py``) and multi-process launch
(``multihost.py``). Imports nothing of JAX."""
