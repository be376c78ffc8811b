from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig

__all__ = [
    "SymbolicAudioModel",
    "SymbolicAudioModelConfig",
]
