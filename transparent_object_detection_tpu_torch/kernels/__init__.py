"""Hand-written CUDA kernels of the port (csrc/), built with nvcc at first use."""
