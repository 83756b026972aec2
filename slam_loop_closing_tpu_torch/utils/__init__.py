"""Host-side utilities: kernel build/load, synthetic video, loop-closure
writers, stage timing, and conversion of the JAX package's arrays."""
