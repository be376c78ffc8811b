"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: packed flash attention forward (K2) and backward (K4a dK/dV, K4b
dQ), paged decode attention (K3), and the LayerNorm forward (K1) and backward
(K5)."""
