"""The fast path: state layout, the plain PyTorch cycle and runs, the
CUDA kernels' build and binding, the occupancy scheduler, the engine and
the resident-lane session."""
