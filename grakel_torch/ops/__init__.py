"""Tensor ops of the port: WL refinement, counts-Grams, min-intersection
Grams and spectral embeddings."""
