"""Auto-CLI engine: dataclass fields -> ``--section.field`` flags, YAML
defaults, data -> model argument linking, and a shared training runner
(counterpart of ``perceiver_io_tpu/scripts/cli.py``).

The replacement for the reference's LightningCLI stack (reference:
perceiver/scripts/cli.py:13-47, trainer.yaml:1-14): the config dataclasses
that build models drive the CLI, YAML files given with ``--config`` play the
role of ``trainer.yaml`` (whose values, default root dir ``logs`` and one
weights-only checkpoint, are :class:`TrainerArgs`' own defaults here), link
rules replace ``link_arguments``, and the runner wires the port's
``make_optimizer``, ``MetricsLogger`` and ``Trainer`` in place of Lightning's.

The CLI runs on the card (``--trainer.accelerator=gpu``, the default);
``--trainer.accelerator=cpu`` runs the plain versions on the CPU. Across
processes it runs under ``torchrun`` (one process per card; NCCL on the
card, gloo with ``--trainer.accelerator=cpu``): ``torchrun
--nproc_per_node=N -m perceiver_io_tpu_torch.scripts.text.clm fit
--trainer.strategy=fsdp ...``. The strategies ``dp``, ``fsdp``, ``seq`` and
``ring`` build JAX's meshes; ``seq`` takes the explicit prefix-sharded route
of ``ring`` (the port has no GSPMD); ``tp`` and ``fsdp_tp`` wait for ROADMAP
A12 part 2 and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from dataclasses import dataclass, fields, is_dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

# --------------------------------------------------------------------------
# dataclass <-> argparse
# --------------------------------------------------------------------------


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _unwrap_optional(tp):
    """Optional[T] -> (T, True); T -> (T, False)."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _parser_for(tp, optional: bool):
    """Value-parsing callable for a field type."""
    origin = typing.get_origin(tp)
    if origin in (tuple, list):
        elem = (typing.get_args(tp) or (int,))[0]
        elem, _ = _unwrap_optional(elem)
        container = tuple if origin is tuple else list

        def parse_seq(v):
            if optional and v.lower() == "none":
                return None
            return container(elem(x) for x in str(v).replace("(", "").replace(")", "").split(",") if x != "")

        return parse_seq
    base = _str2bool if tp is bool else tp
    if optional:
        return lambda v: None if str(v).lower() == "none" else base(v)
    return base


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str, defaults: Optional[dict] = None) -> None:
    """Flatten ``cls``'s fields (recursing into dataclass-typed fields) into
    ``--{prefix}.{field}`` options. ``defaults`` overrides per-field defaults
    (the analog of the reference's per-task ``set_defaults`` paper presets,
    e.g. perceiver/scripts/text/mlm.py:25-41)."""
    defaults = defaults or {}
    hints = typing.get_type_hints(cls)
    for f in fields(cls):
        tp, optional = _unwrap_optional(hints[f.name])
        dest = f"{prefix}.{f.name}"
        if is_dataclass(tp):
            add_dataclass_args(parser, tp, dest, defaults.get(f.name))
            continue
        if f.name in defaults:
            default = defaults[f.name]
        elif f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        else:
            default = None
        parser.add_argument(f"--{dest}", dest=dest, type=_parser_for(tp, optional), default=default)


def build_dataclass(cls, ns: argparse.Namespace, prefix: str, **overrides):
    """Rebuild a (possibly nested) dataclass from parsed args."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in fields(cls):
        if f.name in overrides:
            kwargs[f.name] = overrides[f.name]
            continue
        tp, _ = _unwrap_optional(hints[f.name])
        dest = f"{prefix}.{f.name}"
        if is_dataclass(tp):
            kwargs[f.name] = build_dataclass(tp, ns, dest)
        elif hasattr(ns, dest):
            kwargs[f.name] = getattr(ns, dest)
    return cls(**kwargs)


# --------------------------------------------------------------------------
# trainer / optimizer arg groups
# --------------------------------------------------------------------------


@dataclass
class TrainerArgs:
    """Host-loop settings (replaces ``--trainer.*`` Lightning flags;
    reference: perceiver/scripts/trainer.yaml:1-14)."""

    max_steps: int = 1000
    log_interval: int = 50
    val_interval: Optional[int] = None
    default_root_dir: str = "logs"
    name: str = "default"
    precision: str = "float32"  # float32 | bfloat16 (params stay f32)
    gradient_clip_val: Optional[float] = None
    accumulate_grad_batches: int = 1
    # dp | fsdp | seq | ring over the processes of the run (torchrun);
    # tp | fsdp_tp wait for ROADMAP A12 part 2 (make_mesh_for raises)
    strategy: str = "dp"
    fsdp_min_weight_size: int = 2**14
    devices: int = -1  # -1 = all visible
    # Lightning's name: gpu (the card, "cuda" too) | cpu (the plain versions)
    accelerator: str = "gpu"
    seed: int = 0
    checkpoint: bool = True
    max_checkpoints: int = 1
    save_weights_only: bool = True
    # mirror the metrics log to TensorBoard where it is installed (Lightning's
    # default TensorBoardLogger); false writes metrics.csv alone
    tensorboard: bool = True
    # false | true (restore latest) | auto (preemption-safe auto-resume:
    # restore the latest VALID checkpoint + fast-forward the data stream +
    # truncate metrics past the restore point)
    resume: str = "false"


@dataclass
class OptimizerArgs:
    """Optimizer + LR schedule flags (replaces ``--optimizer`` /
    ``--lr_scheduler`` CLI wiring; reference: perceiver/scripts/cli.py:37-44,
    lrs.py:7-38)."""

    optimizer: str = "adamw"
    lr: float = 1e-3
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    # "bfloat16" stores Adam moments in bf16 (f32 math); default f32
    moment_dtype: Optional[str] = None
    lr_scheduler: str = "cosine_with_warmup"  # cosine_with_warmup | constant_with_warmup | none
    warmup_steps: int = 0
    min_fraction: float = 0.0
    # None = linked from trainer.max_steps (reference: link_arguments
    # trainer.max_steps -> lr_scheduler.training_steps, scripts/text/clm.py:15)
    training_steps: Optional[int] = None


# --------------------------------------------------------------------------
# YAML defaults
# --------------------------------------------------------------------------


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def apply_yaml_defaults(parser: argparse.ArgumentParser, path) -> None:
    """Apply a YAML file of (nested) dotted keys as argparse defaults
    (the analog of ``default_config_files=[trainer.yaml]``,
    reference: perceiver/scripts/cli.py:15-16)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    flat = _flatten(data)
    known = {a.dest for a in parser._actions}
    unknown = set(flat) - known
    if unknown:
        raise ValueError(f"unknown keys in {path}: {sorted(unknown)}")
    parser.set_defaults(**flat)


# --------------------------------------------------------------------------
# shared parser construction / training runner
# --------------------------------------------------------------------------

COMMANDS = ("fit", "validate")


def cycle(batches):
    """Endless batch iterator over a re-iterable loader (each pass is a new
    epoch; ``Batches`` reshuffles per epoch). A pass that yields no batch
    (a dataset smaller than one batch) raises instead of spinning."""
    while True:
        n = 0
        for batch in batches:
            n += 1
            yield batch
        if n == 0:
            raise ValueError("the training loader yields no batch: the dataset holds fewer examples than "
                             "--data.batch_size")


def make_parser(
    description: str,
    trainer_defaults: Optional[dict] = None,
    optimizer_defaults: Optional[dict] = None,
) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description, allow_abbrev=False)
    parser.add_argument("command", nargs="?", choices=COMMANDS, default="fit")
    parser.add_argument("--config", action="append", default=[], help="YAML defaults file(s)")
    add_dataclass_args(parser, TrainerArgs, "trainer", trainer_defaults)
    add_dataclass_args(parser, OptimizerArgs, "optimizer", optimizer_defaults)
    return parser


def add_smoke_preset(parser: argparse.ArgumentParser, preset: dict) -> None:
    """Register a ``--smoke`` preset: a dict of dotted arg names applied as
    parser defaults when ``--smoke`` is passed (each task reproducible offline
    in minutes). Explicit flags still override."""
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="tiny offline preset (synthetic/local data, small model, few steps)",
    )
    parser._smoke_preset = preset  # applied in parse_args


def parse_args(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Two-pass parse so ``--config`` files (and the ``--smoke`` preset)
    apply as defaults that explicit flags still override.

    Also the multi-process entry point, as the JAX function's: after the
    arguments parse, the default group starts when torchrun's coordinates
    are set (``parallel.dist.maybe_initialize_distributed``: NCCL on the
    card, gloo with ``--trainer.accelerator=cpu``), before any task code
    runs. No-op without them."""
    pre, _ = parser.parse_known_args(argv)
    for cfg in pre.config:
        apply_yaml_defaults(parser, cfg)
    if getattr(pre, "smoke", False):
        preset = getattr(parser, "_smoke_preset", None) or {}
        known = {a.dest for a in parser._actions}
        unknown = set(preset) - known
        if unknown:
            raise ValueError(f"smoke preset has unknown keys: {sorted(unknown)}")
        parser.set_defaults(**preset)
    args = parser.parse_args(argv)
    accelerator = getattr(args, "trainer.accelerator", None)
    if accelerator is not None:
        from perceiver_io_tpu_torch.parallel.dist import maybe_initialize_distributed

        maybe_initialize_distributed(device_for(TrainerArgs(accelerator=accelerator)))
    return args


def activation_dtype(trainer: TrainerArgs) -> torch.dtype:
    name = trainer.precision.lower()
    if name in ("float32", "fp32", "32"):
        return torch.float32
    if name in ("bfloat16", "bf16", "bf16-mixed", "16"):
        return torch.bfloat16
    raise ValueError(f"unknown precision: {trainer.precision}")


def device_for(trainer: TrainerArgs) -> str:
    """``--trainer.accelerator`` -> the device the run builds its model on."""
    name = trainer.accelerator.lower()
    if name in ("gpu", "cuda"):
        return "cuda"
    if name == "cpu":
        return "cpu"
    raise ValueError(f"unknown accelerator: {trainer.accelerator} (expected gpu|cpu)")


STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp", "seq", "ring")


def make_mesh_for(trainer: TrainerArgs):
    """Strategy string -> mesh (reference strategies 'ddp…'/'fsdp…' remapped in
    perceiver/scripts/cli.py:26-35 and clm_fsdp.py:29-36), JAX's meshes over
    the run's processes (one a device; ``torchrun`` starts them, and a
    one-process run needs no launcher): ``dp`` on one process needs no mesh
    (None, as in the JAX function), ``dp`` on more is ``data=n``, ``fsdp``
    ``fsdp=n``, ``seq`` and ``ring`` ``seq=n``. ``tp`` and ``fsdp_tp`` raise
    (ROADMAP A12 part 2). ``--trainer.devices`` must match the process count
    where it is set."""
    if trainer.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy: {trainer.strategy} (expected {'|'.join(STRATEGIES)})")
    if trainer.strategy in ("tp", "fsdp_tp"):
        raise NotImplementedError(f"--trainer.strategy={trainer.strategy}: tensor parallelism waits for ROADMAP A12 "
                                  "part 2")
    import torch.distributed as dist

    from perceiver_io_tpu_torch.device import resolve_device
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh

    device = resolve_device(device_for(trainer))
    n = dist.get_world_size() if dist.is_initialized() else 1
    if trainer.devices not in (-1, 0) and trainer.devices != n:
        raise ValueError(f"--trainer.devices={trainer.devices} but the run has {n} process(es): the port runs one "
                         "process per device (launch with torchrun --nproc_per_node)")
    if trainer.strategy == "dp" and n == 1:
        return None
    if trainer.strategy == "dp":
        return make_mesh(data=n, device=device)
    if trainer.strategy == "fsdp":
        return make_mesh(data=1, fsdp=n, device=device)
    return make_mesh(data=1, seq=n, device=device)


def make_lr_schedule(opt: OptimizerArgs, max_steps: int):
    from perceiver_io_tpu_torch.training import optim

    training_steps = opt.training_steps if opt.training_steps is not None else max_steps
    if opt.lr_scheduler == "cosine_with_warmup":
        return optim.cosine_with_warmup(
            opt.lr, training_steps, warmup_steps=opt.warmup_steps, min_fraction=opt.min_fraction
        )
    if opt.lr_scheduler == "constant_with_warmup":
        return optim.constant_with_warmup(opt.lr, warmup_steps=opt.warmup_steps)
    if opt.lr_scheduler == "none":
        return None
    raise ValueError(f"unknown lr_scheduler: {opt.lr_scheduler}")


def run_training(
    build_model: Callable,
    model_config,
    loss_fn: Callable,
    train_iter,
    val_loader,
    trainer_args: TrainerArgs,
    opt_args: OptimizerArgs,
    command: str = "fit",
    callbacks: Sequence = (),
    frozen_paths: Sequence[str] = (),
    warm_start=None,
    ring_loss_builder=None,
):
    """Shared fit/validate runner for all task CLIs.

    :param build_model: ``(device, generator) -> model``: the model built on
        ``device`` (``--trainer.accelerator``) with its weights drawn from
        ``generator``, a CPU generator seeded ``trainer.seed``.
    :param loss_fn: the port's ``loss_fn(model, batch, generator)``.
    :param warm_start: optional ``model -> None`` hook applied after the
        build (ckpt / encoder warm start, reference: perceiver/model/core/
        lightning.py:145-147, text/classifier/lightning.py:28-36).
    :param ring_loss_builder: ``(model, mesh) -> loss_fn`` for the
        sequence-parallel strategies ``ring`` and ``seq`` (CLM only:
        ``parallel.long_context.make_ring_clm_loss``); other strategies
        ignore it, and ``ring``/``seq`` without one raise (the task has no
        sequence-parallel route).
    :return: ``(state, metrics)``; metrics None after ``fit``.
    """
    from perceiver_io_tpu_torch.obs import clm_train_telemetry
    from perceiver_io_tpu_torch.training.metrics import MetricsLogger
    from perceiver_io_tpu_torch.training.optim import freeze_mask, make_optimizer
    from perceiver_io_tpu_torch.training.loop import shard_train_state
    from perceiver_io_tpu_torch.training.state import TrainState
    from perceiver_io_tpu_torch.training.trainer import Trainer, TrainerConfig

    if trainer_args.strategy in ("ring", "seq") and ring_loss_builder is None:
        raise ValueError(f"strategy {trainer_args.strategy!r} requires a sequence-parallel loss route; this task "
                         "does not provide one (use the CLM CLI, or a dp/fsdp strategy)")
    mesh = make_mesh_for(trainer_args)
    device = device_for(trainer_args)
    model = build_model(device, torch.Generator().manual_seed(trainer_args.seed))
    if warm_start is not None:
        warm_start(model)

    schedule = make_lr_schedule(opt_args, trainer_args.max_steps)
    mask = freeze_mask(model, frozen_paths) if frozen_paths else None
    tx = make_optimizer(
        schedule if schedule is not None else opt_args.lr,
        optimizer=opt_args.optimizer,
        weight_decay=opt_args.weight_decay,
        beta1=opt_args.beta1,
        beta2=opt_args.beta2,
        gradient_clip=trainer_args.gradient_clip_val,
        accumulate_grad_batches=trainer_args.accumulate_grad_batches,
        frozen_mask=mask,
        moment_dtype=opt_args.moment_dtype,
    )
    # the training forwards' draws (prefix keep sets, dropout masks) on the
    # model's device
    state = TrainState.create(model, tx, generator=torch.Generator(device=device).manual_seed(trainer_args.seed))

    run_dir = Path(trainer_args.default_root_dir) / trainer_args.name
    logger = MetricsLogger(str(run_dir), use_tensorboard=trainer_args.tensorboard)
    # analytic per-sample token/FLOP accounting for the MFU/throughput log
    # columns — available for CLM-shaped configs, None (columns off) otherwise
    tokens_per_sample, flops_per_sample = clm_train_telemetry(model_config) or (None, None)
    if trainer_args.strategy in ("ring", "seq"):
        loss_fn = ring_loss_builder(model, mesh)
    trainer = Trainer(
        loss_fn,
        mesh=mesh,
        config=TrainerConfig(
            max_steps=trainer_args.max_steps,
            log_interval=trainer_args.log_interval,
            val_interval=trainer_args.val_interval,
            checkpoint_dir=str(run_dir / "checkpoints") if trainer_args.checkpoint else None,
            max_checkpoints=trainer_args.max_checkpoints,
            save_weights_only=trainer_args.save_weights_only,
            fsdp_min_weight_size=trainer_args.fsdp_min_weight_size,
            tokens_per_sample=tokens_per_sample,
            flops_per_sample=flops_per_sample,
        ),
        logger=logger,
        lr_schedule=schedule,
        callbacks=callbacks,
    )
    try:
        if command == "validate":
            # evaluate the trained weights when a checkpoint exists (the
            # Lightning `validate --ckpt_path` analog); otherwise the fresh
            # init is evaluated and we say so
            if mesh is not None:
                state = shard_train_state(state, mesh, min_weight_size=trainer_args.fsdp_min_weight_size)
            if trainer.checkpoints is not None and trainer.checkpoints.latest_step() is not None:
                state = trainer.checkpoints.restore(state)
            else:
                print("validate: no checkpoint found - evaluating freshly initialized parameters")
            metrics = trainer.validate(state, val_loader or [])
            logger.log(int(state.step), metrics)
            return state, metrics
        resume = trainer_args.resume
        if isinstance(resume, str):
            # tri-state flag: bool-ish strings coerce, "auto" (any case)
            # normalizes to the exact token Trainer.fit dispatches on
            resume = "auto" if resume.lower() == "auto" else _str2bool(resume)
        state = trainer.fit(state, train_iter, val_loader, model_config=model_config, resume=resume)
        return state, None
    finally:
        trainer.close()
        logger.close()
