"""Serving of the port: LM engine and runtimes, the BERT predictor,
batcher, protocol codecs and the HTTP server."""
