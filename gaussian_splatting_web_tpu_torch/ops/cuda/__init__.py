"""Hand-written CUDA kernels: wrappers and the build at first use."""
