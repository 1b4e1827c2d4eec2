"""Hand-written CUDA kernels of the port, their plain PyTorch versions,
the wrappers that choose between them by device, and the routing table."""
