"""The port's serving layer: the continuous-batching engine over paged KV
caches and its host-side page allocator."""

from perceiver_io_tpu_torch.serving.engine import EngineConfig, EngineFrontEnd, RequestRecord, RequestSpec
from perceiver_io_tpu_torch.serving.pages import PageAllocator, PageGrant

__all__ = ["EngineConfig", "EngineFrontEnd", "PageAllocator", "PageGrant", "RequestRecord", "RequestSpec"]
