"""Models of the port: the decoder LM, BERT, the bridge from JAX params
and the HF checkpoint conversion."""
