"""Process roles, meshes and sequence parallelism for the port (counterpart
of ``perceiver_io_tpu/parallel/``, under the JAX package's names):
``dist`` (process roles, the group's start), ``mesh`` (the 4-axis
``DeviceMesh``, the batch split, JAX's FSDP placement rule),
``ring_attention`` (the sequence-sharded cross-attention and ring
self-attention) and ``long_context`` (the prefix-sharded CLM). Tensor
parallelism (``param_shardings``) and the overlap step (``overlap.py``) are
ROADMAP A12 part 2."""

from perceiver_io_tpu_torch.parallel.dist import (
    is_main_process,
    main_process_only,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
from perceiver_io_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_SEQ,
    AXIS_TENSOR,
    MESH_AXES,
    fsdp_param_shardings,
    make_mesh,
    shard_batch,
)
from perceiver_io_tpu_torch.parallel.ring_attention import (
    make_ring_cross_attention,
    make_ring_self_attention,
    ring_self_attention,
    seq_sharded_cross_attention,
)

__all__ = [
    "is_main_process",
    "main_process_only",
    "maybe_initialize_distributed",
    "process_count",
    "process_index",
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_SEQ",
    "AXIS_TENSOR",
    "MESH_AXES",
    "fsdp_param_shardings",
    "make_mesh",
    "shard_batch",
    "make_ring_cross_attention",
    "make_ring_self_attention",
    "ring_self_attention",
    "seq_sharded_cross_attention",
]
