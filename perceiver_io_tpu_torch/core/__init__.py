"""Perceiver AR and Perceiver IO building blocks in PyTorch: configs,
positions, adapters, KV caches, attention and the modules (counterparts of
``perceiver_io_tpu.core``)."""
