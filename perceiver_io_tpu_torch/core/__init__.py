"""Perceiver AR building blocks in PyTorch: config, positions, adapters, KV
caches, attention and the modules (counterparts of ``perceiver_io_tpu.core``)."""
