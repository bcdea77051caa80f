"""Hand-written Hopper kernels: plain versions, CUDA wrappers, build and dispatch."""
