"""Online serving of the port: batcher, engine and HTTP server."""
