"""Models of the port: the decoder LM and the bridge from JAX params."""
