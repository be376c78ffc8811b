"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: packed flash attention forward (K2) and backward (K4a dK/dV, K4b
dQ), its two-segment form for the Perceiver AR cross-attention (K6 forward,
K7a dK/dV, K7b dQ), paged decode attention (K3), and the LayerNorm forward
(K1) and backward (K5)."""
