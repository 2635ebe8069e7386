"""Device compute: the transition-count encoder and the CUDA kernels."""
