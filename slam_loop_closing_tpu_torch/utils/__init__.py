"""Host-side utilities: kernel build/load, synthetic video, frame IO and
report writers, the KITTI adapter, stage timing and traces, and conversion of
the JAX package's arrays."""
