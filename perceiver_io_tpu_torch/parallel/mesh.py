"""Device mesh and sharding rules (counterpart of
``perceiver_io_tpu/parallel/mesh.py``): the reference's DDP and FSDP
strategies (SURVEY §2.7) on ``torch.distributed``.

The JAX package runs one SPMD program over a named ``jax.sharding.Mesh`` and
lets GSPMD insert the collectives; the port runs one process per device over a
``torch.distributed`` ``DeviceMesh`` with the same four axis names
(``data``, ``fsdp``, ``tensor``, ``seq``), rank ``r`` at mesh coordinate
``numpy.unravel_index(r, (data, fsdp, tensor, seq))``, as the JAX mesh lays
out its devices:

- **data parallel** (reference: Lightning's DDPStrategy): every rank holds
  its block of the global batch (:func:`shard_batch`) and the gradients are
  averaged;
- **FSDP** (reference: FSDPStrategy + transformer_auto_wrap_policy): the
  parameters and the optimizer's state are sharded over ``fsdp``
  (``training.loop.shard_train_state``, FSDP2's ``fully_shard``), one
  parameter dim each (:func:`fsdp_param_shardings`, JAX's rule);
- **seq** shards the CLM prefix (``parallel.long_context``).

Tensor parallelism (``tensor > 1``) is ROADMAP A12 part 2 and raises.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from perceiver_io_tpu_torch.parallel import dist as pdist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"

MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ)


def make_mesh(data: Optional[int] = None, fsdp: int = 1, tensor: int = 1, seq: int = 1, device="cuda"):
    """A 4-axis ``DeviceMesh`` (data, fsdp, tensor, seq) over the default
    group's ranks; ``data=None`` absorbs every rank left over. With no group
    up it first joins torchrun's (``parallel.dist.maybe_initialize_distributed``);
    with no launcher either, on one process, it starts a one-process group
    (NCCL on the card, gloo for ``device="cpu"``), so a one-card run needs no
    launcher. A ``WORLD_SIZE`` above 1 with no group to join raises: no
    process trains alone. The sizes must multiply to the world size (JAX's
    errors)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if not dist.is_initialized() and not pdist.maybe_initialize_distributed(dev):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE={world} but no process group is up and RANK is not set: launch with "
                               "torchrun, or start the group (parallel.dist.initialize) before make_mesh")
        pdist.initialize(dev)
    n = dist.get_world_size()
    fixed = fsdp * tensor * seq
    if data is None:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fsdp*tensor*seq={fixed}")
        data = n // fixed
    if data * fixed != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor}x{seq} != {n} devices")
    if tensor > 1:
        raise NotImplementedError(f"tensor={tensor}: tensor parallelism (strategies tp and fsdp_tp) waits for "
                                  "ROADMAP A12 part 2")
    return init_device_mesh(dev.type, (data, fsdp, tensor, seq), mesh_dim_names=MESH_AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def mesh_coordinate(mesh) -> Dict[str, int]:
    """This rank's index along each axis."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def batch_shards(mesh) -> int:
    """The number of batch blocks: data x fsdp."""
    return axis_size(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP)


def batch_index(mesh) -> int:
    """This rank's block of the batch over data x fsdp (JAX's
    ``P((data, fsdp))`` order: data major)."""
    c = mesh_coordinate(mesh)
    return c[AXIS_DATA] * axis_size(mesh, AXIS_FSDP) + c[AXIS_FSDP]


def _leaf_name(path) -> str:
    return "".join(f"[{p!r}]" for p in path) or "<root>"


def shard_batch(batch, mesh):
    """This rank's block of the GLOBAL ``batch`` (a dict, list or tuple tree
    of arrays or tensors; other leaves pass): the leading dim split over
    data x fsdp. A leaf whose leading dim does not divide raises naming it
    (JAX's error)."""
    n = batch_shards(mesh)
    b = batch_index(mesh)

    def put(path, x):
        shape = getattr(x, "shape", None)
        if shape is None or len(shape) == 0:
            return x
        if shape[0] % n != 0:
            raise ValueError(
                f"batch leaf {_leaf_name(path)}: leading dim {shape[0]} is not divisible by the data x fsdp "
                f"submesh ({axis_size(mesh, AXIS_DATA)} x {axis_size(mesh, AXIS_FSDP)} = {n} shards) — pad or "
                "resize the batch")
        per = shape[0] // n
        return x[b * per:(b + 1) * per]

    def walk(path, x):
        if isinstance(x, dict):
            return {k: walk(path + (k,), v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(path + (i,), v) for i, v in enumerate(x))
        return put(path, x)

    return walk((), batch)


def _fsdp_dim(shape, fsdp_size: int, min_weight_size: int, exclude=()) -> Optional[int]:
    """JAX's rule: the largest axis divisible by the fsdp size, ties broken
    toward the later axis (None for small or indivisible parameters)."""
    if fsdp_size <= 1 or math.prod(shape) < min_weight_size:
        return None
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True)
    for i in order:
        if i not in exclude and shape[i] % fsdp_size == 0:
            return i
    return None


def _transposed_weights(model: nn.Module) -> set:
    """Names of the parameters held transposed relative to JAX: every
    ``nn.Linear.weight`` ((out, in); Flax's kernel is (in, out))."""
    return {f"{prefix}.weight" if prefix else "weight" for prefix, m in model.named_modules()
            if isinstance(m, nn.Linear)}


def fsdp_param_shardings(model: nn.Module, mesh=None, min_weight_size: int = 2**14,
                         fsdp_size: Optional[int] = None) -> Dict[str, Optional[int]]:
    """``{name: dim or None}``: the dim of each parameter of ``model`` that
    JAX's ``fsdp_param_shardings`` shards over ``fsdp`` (None where it
    replicates). The rule runs on the JAX shape and the dim maps across the
    transpose of a Linear weight: on a square weight JAX shards its output
    axis (the later one of the kernel), which is dim 0 here; the rule run on
    the torch shape would pick the input axis. ``fsdp_size`` stands in for
    the mesh's fsdp size (e.g. on a ``"meta"`` model without a group)."""
    size = axis_size(mesh, AXIS_FSDP) if fsdp_size is None else fsdp_size
    transposed = _transposed_weights(model)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in transposed and len(shape) == 2:
            d = _fsdp_dim(shape[::-1], size, min_weight_size)
            out[name] = None if d is None else 1 - d
        else:
            out[name] = _fsdp_dim(shape, size, min_weight_size)
    return out


def fsdp_placement_fn(model: nn.Module, mesh, min_weight_size: int = 2**14):
    """FSDP2's ``shard_placement_fn``: ``Shard(dim)`` on the dim of
    :func:`fsdp_param_shardings`, ``Shard(0)`` where JAX replicates (FSDP2
    shards every parameter of a unit; the values are the same)."""
    from torch.distributed.tensor import Shard

    dims = fsdp_param_shardings(model, mesh, min_weight_size)
    by_id = {id(p): dims[name] for name, p in model.named_parameters()}

    def placement(param: nn.Parameter):
        d = by_id.get(id(param))
        return Shard(0 if d is None else d)

    return placement


def replicate_group_mesh(mesh):
    """The 2-D ``(replicate, shard)`` mesh FSDP2 shards over: ``fsdp`` is the
    shard dim, and ``data`` with ``seq`` the replicate dim (the gradients are
    averaged over both: the batch blocks of ``data``, and the prefix blocks
    of the sequence-parallel loss, whose replicated latent stack sees each
    rank's upstream gradient n-fold). The same object for the same mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    cached = getattr(mesh, "_pio_fsdp_mesh", None)
    if cached is not None:
        return cached
    ranks = mesh.mesh.reshape(*(axis_size(mesh, a) for a in MESH_AXES))
    d, f, t, s = ranks.shape
    grid = ranks.permute(0, 3, 2, 1).reshape(d * s * t, f)
    if axis_size(mesh, AXIS_SEQ) == 1:
        out = mesh[AXIS_DATA, AXIS_FSDP]
    else:
        out = DeviceMesh(mesh.device_type, grid, mesh_dim_names=("replicate", AXIS_FSDP))
    mesh._pio_fsdp_mesh = out
    return out


def mesh_shape(mesh) -> Dict[str, int]:
    return {a: axis_size(mesh, a) for a in MESH_AXES}


def local_chunk(full: torch.Tensor, dparam) -> torch.Tensor:
    """This rank's block of ``full`` as the DTensor ``dparam`` lays it out
    (``torch.chunk`` along each sharded dim, as FSDP2 and DTensor split; a
    rank past the last chunk holds an empty block)."""
    mesh, coord = dparam.device_mesh, dparam.device_mesh.get_coordinate()
    out = full
    for i, placement in enumerate(dparam.placements):
        if placement.is_shard():
            chunks = torch.chunk(out, mesh.size(i), dim=placement.dim)
            out = chunks[coord[i]] if coord[i] < len(chunks) else out.narrow(placement.dim, 0, 0)
    return out


def gather_full(local: torch.Tensor, dparam) -> torch.Tensor:
    """The whole tensor from every rank's block ``local`` laid out as the
    DTensor ``dparam`` (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    d = DTensor.from_local(local, dparam.device_mesh, dparam.placements, run_check=False, shape=dparam.shape,
                           stride=dparam.stride())
    return d.full_tensor()
