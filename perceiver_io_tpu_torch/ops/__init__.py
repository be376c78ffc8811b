"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: packed flash attention forward (K2), paged decode attention (K3) and
the LayerNorm forward (K1)."""
