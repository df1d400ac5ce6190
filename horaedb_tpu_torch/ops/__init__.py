"""Device ops of the port: kernels A (sort.py), B and C (blockagg.py), the
downsample around them (aggregate.py) and the host predicate (filter.py)."""
