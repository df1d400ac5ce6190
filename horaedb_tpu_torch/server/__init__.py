"""Server-side pieces of the port: the metrics registry and the query
batcher (the HTTP server is not ported yet)."""
