"""Forward error correction: block codes, K=7 convolutional code, dispatch."""
