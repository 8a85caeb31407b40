"""rmsnorm: fused RMSNorm over the last dimension, as a CUDA kernel."""
