"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Kernels are built at first use (``build.py``), never at import."""
