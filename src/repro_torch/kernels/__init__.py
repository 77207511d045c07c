"""CUDA kernels of the port, their plain versions and the lambda-search."""
