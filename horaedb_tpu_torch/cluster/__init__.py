"""The cluster layer of the port: the partial-grid wire codec and its
canonical fold (`partial.py`), which the regioned engine's scatter-gather
read rides. The router, the region assignment map and the read replicas
of the JAX package's `cluster/` are not ported yet."""
