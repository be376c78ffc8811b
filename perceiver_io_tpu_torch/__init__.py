"""perceiver_io_tpu_torch — the PyTorch/CUDA port of perceiver_io_tpu for one
NVIDIA H100.

The package keeps the JAX package's layout (``core/``, ``ops/``,
``models/text/``, ``models/vision/``, ``generation.py``, ``serving/``,
``training/``) with
PyTorch idiom inside:
``nn.Module``s and plain functions on tensors, an explicit ``device`` and
explicit ``torch.Generator``s. Every TPU kernel on its path is a kernel written
by hand for Hopper (``ops/``), each beside a plain PyTorch version that CPU
tensors take. Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``. It imports neither JAX nor anything of ``perceiver_io_tpu``.
"""

from perceiver_io_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
