"""Hand-written Hopper kernels, one package each, with a plain PyTorch
version beside every kernel."""
