"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: packed flash attention forward (K2) and backward (K4a dK/dV, K4b
dQ), its two-segment form for the Perceiver AR cross-attention (K6 forward,
K7a dK/dV, K7b dQ), heads-major flash attention for head dims up to 512 (K8
forward, K9a dK/dV, K9b dQ), paged decode attention (K3), and the LayerNorm
forward (K1) and backward (K5)."""
