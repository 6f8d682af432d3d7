"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the validated fronts (``ops``) the core modules call."""
