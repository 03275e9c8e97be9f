"""LM serving of the port: paged engine, model wrapper, HTTP server."""
