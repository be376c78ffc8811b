from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig

__all__ = ["CausalLanguageModel", "CausalLanguageModelConfig"]
