"""Checkpoints and resume, torch-native (counterpart of
``perceiver_io_tpu/training/checkpoint.py``): configs serialized beside the
weights so a checkpoint alone can rebuild the model, best-k training
checkpoints with torn-save protection, and an in-place restore.

Parity targets (reference: SURVEY §5.4):
- training checkpoints monitored on ``val_loss`` with best-k retention and
  a weights-only option (reference: perceiver/scripts/trainer.yaml:7-12),
- hyperparameters in the checkpoint so restore needs no external files
  (reference: perceiver/model/core/lightning.py:24,108 save_hyperparameters),
- a warm start of a whole model or of one subtree (``load_params_into``),
- an inference-side ``save_pretrained`` / ``load_pretrained`` seam.

What differs from the JAX package, and why:

- The format is torch's (``torch.save``; read back with
  ``torch.load(weights_only=True)``), not orbax's. A JAX checkpoint reaches
  the port only through ``convert``; a JAX run's ``config.json`` loads into
  the port's config class of the same name (:func:`config_from_dict`).
- :meth:`CheckpointManager.restore` copies into the state's EXISTING tensors
  (``copy_``, ``load_state_dict``, ``Generator.set_state``) and returns the
  same ``TrainState``, where the JAX package returns a new state. A train
  step captured as a CUDA graph reads fixed addresses; a restore that
  swapped in new tensors would make it capture again, or replay against
  freed memory. So a rollback in the middle of a fit replays the same graph.
- The payload is the model's ``state_dict``, the optimizer's state tensors
  beyond its parameters (``Optimizer.state_tensors()``: the rule's moments,
  AdamW's steps, accumulation's running mean and counters, the count), the
  step counter and the generator's state.
- The async save snapshots the payload into pinned host buffers with copies
  enqueued on the current stream, so they are ordered before the next step's
  replay, and a writer thread waits on their event and writes the step.
- A sharded state (``training.loop.shard_train_state``) is saved whole:
  every rank gathers the parameters and the optimizer's moments from their
  shards (a collective) and process 0 writes them; a restore reads the whole
  payload on every rank and copies each rank's block into its shards. The
  step records the mesh's shape; a restore onto a mesh of another shape
  raises, as do the sharding fingerprint and the elastic reshard (ROADMAP
  A12 part 2).

On disk, a step is a directory ``<step>/`` holding ``state.pt``. It is
written into a tmp directory, renamed into place, and committed by the
marker ``_CHECKPOINT_METADATA`` (its metrics, whether it carries the
optimizer, and each tensor's shape and dtype) written last. ``integrity.json``
records each committed step's file count and bytes and its metrics. A
manager's startup sweep moves tmp leftovers and uncommitted step directories
into ``_quarantine/``; a committed step whose files no longer match its
record is quarantined when found, and restore falls back to the next valid
step.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pickle
import shutil
import threading
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from perceiver_io_tpu_torch.parallel.dist import is_main_process

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "model.pt"  # save_pretrained's weights
STATE_FILE = "state.pt"  # a training step's payload
QUARANTINE_DIR = "_quarantine"
INTEGRITY_FILE = "integrity.json"
COMMIT_MARKER = "_CHECKPOINT_METADATA"  # written last: a step without it is uncommitted
TMP_TAG = ".tmp-"  # a step written into "<step>.tmp-<id>/" and renamed
_JAX_PACKAGE, _PORT_PACKAGE = "perceiver_io_tpu.", "perceiver_io_tpu_torch."


class ResumePreflightError(RuntimeError):
    """A checkpoint is structurally incompatible with the state (or config)
    it is being restored into: raised by :meth:`CheckpointManager.preflight`
    with every detected problem in one actionable message, instead of the
    error a blind restore would die on.

    ``problems`` holds the individual findings (machine-readable)."""

    def __init__(self, directory: str, step, problems: list):
        self.directory = directory
        self.step = step
        self.problems = list(problems)
        lines = "\n".join(f"  - {p}" for p in self.problems)
        super().__init__(
            f"resume preflight failed for checkpoint step {step} under "
            f"{directory}:\n{lines}\n(the checkpoint belongs to a different "
            "model/config; fix the config, point at the right run dir, or "
            "start fresh with resume=False)"
        )


# ---------------------------------------------------------------------------
# config (de)serialization — nested dataclasses tagged with their class path
# ---------------------------------------------------------------------------


def config_to_dict(config) -> dict:
    """Recursively convert a config dataclass to a JSON-safe dict; each
    dataclass is tagged with its import path so ``config_from_dict`` can
    rebuild the exact class (including encoder/decoder subclasses)."""
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        d = {f.name: config_to_dict(getattr(config, f.name)) for f in dataclasses.fields(config)}
        d["__config_class__"] = f"{type(config).__module__}.{type(config).__qualname__}"
        return d
    if isinstance(config, (list, tuple)):
        return [config_to_dict(v) for v in config]
    if isinstance(config, dict):
        return {k: config_to_dict(v) for k, v in config.items()}
    if isinstance(config, (np.integer,)):
        return int(config)
    if isinstance(config, (np.floating,)):
        return float(config)
    return config


def _port_class_path(path: str) -> str:
    """The port's class for a tagged path: a JAX package class maps to the
    port's class of the same module path and name."""
    if path.startswith(_JAX_PACKAGE):
        path = _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    return path


def _coerce_tuples(cls, kwargs: dict) -> dict:
    """JSON has no tuples; restore list values to tuples for fields annotated
    as (or defaulting to) tuples, e.g. ``image_shape``."""
    import typing

    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    for f in dataclasses.fields(cls):
        v = kwargs.get(f.name)
        if not isinstance(v, list):
            continue
        origin = typing.get_origin(hints.get(f.name))
        default_is_tuple = isinstance(f.default, tuple) if f.default is not dataclasses.MISSING else False
        if origin is tuple or default_is_tuple:
            kwargs[f.name] = tuple(v)
    return kwargs


def config_from_dict(d: Any):
    """Inverse of :func:`config_to_dict`. A class tagged under the JAX
    package (``perceiver_io_tpu.models.text.clm.CausalLanguageModelConfig``)
    is rebuilt as the port's class of the same path and name, without
    importing the JAX package; fields the port's class lacks are dropped.
    Only the port's classes are built."""
    if isinstance(d, dict) and "__config_class__" in d:
        path = _port_class_path(d["__config_class__"])
        if not path.startswith(_PORT_PACKAGE):
            raise ValueError(f"config class {d['__config_class__']!r} is not one of the port's")
        module_name, _, class_name = path.rpartition(".")
        cls = getattr(importlib.import_module(module_name), class_name)
        kwargs = {k: config_from_dict(v) for k, v in d.items() if k != "__config_class__"}
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = _coerce_tuples(cls, {k: v for k, v in kwargs.items() if k in field_names})
        return cls(**kwargs)
    if isinstance(d, list):
        return [config_from_dict(v) for v in d]
    if isinstance(d, dict):
        return {k: config_from_dict(v) for k, v in d.items()}
    return d


def save_config(directory: str, config) -> None:
    """``config.json`` (process 0 alone writes)."""
    if not is_main_process():
        return
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, CONFIG_FILE), "w") as f:
        json.dump(config_to_dict(config), f, indent=2)


def load_config(directory: str):
    with open(os.path.join(directory, CONFIG_FILE)) as f:
        return config_from_dict(json.load(f))


# ---------------------------------------------------------------------------
# pretrained (inference) seam: weights + config in one directory
# ---------------------------------------------------------------------------


def save_pretrained(directory: str, model: torch.nn.Module, config=None) -> None:
    """Weights-only artifact for inference: the model's ``state_dict`` (as
    CPU tensors) in ``model.pt`` + ``config.json``. Process 0 alone writes."""
    if not is_main_process():
        return
    os.makedirs(directory, exist_ok=True)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(weights, os.path.join(directory, WEIGHTS_FILE))
    if config is not None:
        save_config(directory, config)


def load_pretrained(directory: str, model: Optional[torch.nn.Module] = None):
    """Returns ``(state_dict, config)``; ``config`` is None when absent. With
    ``model``, the weights are also loaded into it in place (strict).

    Accepts a ``save_pretrained`` artifact or a training checkpoint
    directory (a run's checkpoint root, or the run dir holding it under
    ``checkpoints/``): the best retained step by ``val_loss``, else the
    latest."""
    path = os.path.join(directory, WEIGHTS_FILE)
    if os.path.exists(path):
        weights = torch.load(path, map_location="cpu", weights_only=True)
        config = load_config(directory) if os.path.exists(os.path.join(directory, CONFIG_FILE)) else None
    else:
        weights, config = _load_training_pretrained(directory)
    if model is not None:
        model.load_state_dict(weights, strict=True)
    return weights, config


def _has_steps(root: str) -> bool:
    return os.path.isdir(root) and any(n.isdigit() and os.path.isdir(os.path.join(root, n)) for n in os.listdir(root))


def _load_training_pretrained(directory: str):
    root = os.path.abspath(directory)
    if not _has_steps(root):
        nested = os.path.join(root, "checkpoints")
        if not _has_steps(nested):
            raise FileNotFoundError(f"{directory} has neither {WEIGHTS_FILE} nor checkpoint steps")
        root = nested
    mngr = CheckpointManager(root, max_to_keep=None, monitor="val_loss", mode="min")
    step = mngr.best_step()
    if step is None:
        step = mngr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint steps under {root}")
    payload = mngr._load_payload(step)
    config = load_config(root) if os.path.exists(os.path.join(root, CONFIG_FILE)) else None
    return payload["model"], config


def load_params_into(params: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor],
                     subtree: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Warm start on ``state_dict``s: a new dict equal to ``params`` with the
    entries under the prefix ``subtree`` (``"encoder"`` covers
    ``"encoder.*"``), or every entry when ``subtree`` is None, taken from
    ``source``. ``params`` is not mutated; shapes must agree. Mirrors the
    classifier's encoder-only init from an MLM checkpoint (reference:
    text/classifier/lightning.py:28-36)."""
    if subtree is None:
        names = list(params)
    else:
        prefix = subtree + "."
        if not any(k.startswith(prefix) for k in source):
            available = sorted({k.split(".")[0] for k in source})
            raise KeyError(f"subtree {subtree!r} not found; available: {available}")
        names = [k for k in params if k.startswith(prefix)]
    missing = [k for k in names if k not in source]
    if missing:
        raise KeyError(f"source has no {missing}")
    out = dict(params)
    for k in names:
        if tuple(source[k].shape) != tuple(params[k].shape):
            raise ValueError(f"{k}: shape {tuple(source[k].shape)} != {tuple(params[k].shape)}")
        out[k] = source[k]
    return out


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------


def _optimizer_tensors(state) -> List[torch.Tensor]:
    """The optimizer's state tensors beyond its parameters (which the
    model's ``state_dict`` carries)."""
    return state.optimizer.state_tensors()[len(state.optimizer.params):]


def _optimizer_owners(state) -> list:
    """For each of :func:`_optimizer_tensors`, the sharded parameter it
    mirrors (a DTensor: its shape and layout), None where the state is not
    sharded or the tensor mirrors none."""
    opt = state.optimizer
    n = len(opt.params)
    if getattr(opt, "dparams", None) is None:
        return [None] * (len(opt.state_tensors()) - n)
    return [None if o is None else opt.dparams[o] for o in opt.state_owners()[n:]]


def _optimizer_shapes(state) -> list:
    """The whole shape of each of :func:`_optimizer_tensors`."""
    return [tuple(t.shape) if d is None else tuple(d.shape)
            for t, d in zip(_optimizer_tensors(state), _optimizer_owners(state))]


def _mesh_shape(state) -> Optional[dict]:
    mesh = getattr(state, "mesh", None)
    if mesh is None:
        return None
    from perceiver_io_tpu_torch.parallel.mesh import mesh_shape

    return mesh_shape(mesh)


def _whole_payload(state, weights_only: bool) -> tuple:
    """The model's ``state_dict`` and the optimizer's state tensors, whole:
    on a sharded state gathered from the ranks' shards (a collective: every
    rank calls it)."""
    model = state.model.state_dict()
    optimizer = [] if weights_only else _optimizer_tensors(state)
    if getattr(state, "mesh", None) is None:
        return model, optimizer
    from torch.distributed.tensor import DTensor

    from perceiver_io_tpu_torch.parallel.mesh import gather_full

    model = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in model.items()}
    owners = _optimizer_owners(state)
    return model, [t if d is None else gather_full(t, d) for t, d in zip(optimizer, owners)]


def _tensor_spec(state, weights_only: bool) -> Dict[str, Dict]:
    """Shape and dtype of every tensor a payload of ``state`` holds, by name:
    the model's ``state_dict`` names and ``optimizer[i]`` (whole shapes on a
    sharded state)."""
    spec = {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in state.model.state_dict().items()}
    if not weights_only:
        for i, (t, shape) in enumerate(zip(_optimizer_tensors(state), _optimizer_shapes(state))):
            spec[f"optimizer[{i}]"] = {"shape": list(shape), "dtype": str(t.dtype)}
    return spec


def _generator_kind(state) -> Optional[str]:
    """The device type of ``state.generator`` (None without one): a
    generator's state restores only into a generator of its kind."""
    return None if state.generator is None else state.generator.device.type


def _diff_config_dicts(saved: dict, current: dict, prefix: str = "config") -> list:
    """Named field-level differences between two ``config_to_dict`` trees
    (preflight's config-compatibility leg); class tags compare by their
    port class."""
    problems = []
    if isinstance(saved, dict) and isinstance(current, dict):
        for key in sorted(set(saved) | set(current)):
            path = f"{prefix}.{key}"
            if key not in saved:
                problems.append(f"{path}: absent in checkpoint, current={current[key]!r}")
            elif key not in current:
                problems.append(f"{path}: checkpoint={saved[key]!r}, absent in current config")
            elif key == "__config_class__":
                if _port_class_path(saved[key]) != _port_class_path(current[key]):
                    problems.append(f"{path}: checkpoint={saved[key]!r} != current={current[key]!r}")
            else:
                problems.extend(_diff_config_dicts(saved[key], current[key], path))
        return problems
    # tuples serialize as lists; compare loosely
    s = list(saved) if isinstance(saved, (list, tuple)) else saved
    c = list(current) if isinstance(current, (list, tuple)) else current
    if s != c:
        problems.append(f"{prefix}: checkpoint={saved!r} != current={current!r}")
    return problems


def _diff_tensor_specs(saved: dict, target: dict) -> list:
    """Tensors that differ between a saved spec and the restore target:
    missing and extra model tensors, and shape/dtype mismatches of the
    tensors both carry (optimizer tensors only when both carry them: the
    weights-only and full-state layouts restore into each other)."""
    problems = []
    for name in sorted(set(saved) | set(target)):
        model_tensor = not name.startswith("optimizer[")
        if name not in saved:
            if model_tensor:
                problems.append(f"tensor {name} absent in checkpoint")
            continue
        if name not in target:
            if model_tensor or any(k.startswith("optimizer[") for k in target):
                problems.append(f"checkpoint tensor {name} has no target in the state")
            continue
        s, t = saved[name], target[name]
        if list(s["shape"]) != list(t["shape"]):
            problems.append(f"{name}: shape checkpoint={s['shape']} != state={t['shape']}")
        elif s["dtype"] != t["dtype"]:
            problems.append(f"{name}: dtype checkpoint={s['dtype']} != state={t['dtype']}")
    return problems


def _monitor_value(metrics: Optional[dict], monitor: str, mode: str) -> float:
    """Sanitized monitor value for best-step comparison: NaN or missing
    becomes the WORST possible value for ``mode``, so it never wins."""
    worst = float("inf") if mode == "min" else float("-inf")
    if not metrics:
        return worst
    try:
        v = float(metrics.get(monitor, worst))
    except (TypeError, ValueError):
        return worst
    return v if v == v else worst  # NaN != NaN


def _dir_stats(path: str) -> dict:
    """File count + total byte size under ``path`` — the integrity signature
    a torn step dir fails (missing or truncated files)."""
    n_files = 0
    n_bytes = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                n_bytes += os.path.getsize(os.path.join(root, name))
                n_files += 1
            except OSError:
                continue
    return {"files": n_files, "bytes": n_bytes}


def _write_json_atomic(path: str, data) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, default=str)
    os.replace(tmp, path)  # atomic on POSIX


def _quarantine_path(directory: str, name: str) -> str:
    qdir = os.path.join(directory, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    k = 0
    while True:
        target = os.path.join(qdir, name if k == 0 else f"{name}.{k}")
        if not os.path.exists(target):
            return target
        k += 1


def _load_sharded(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """``load_state_dict(weights, strict=True)`` into a sharded model: each
    DTensor parameter's block copied into its local shard, in place."""
    from torch.distributed.tensor import DTensor

    from perceiver_io_tpu_torch.parallel.mesh import local_chunk

    targets = dict(model.named_parameters(remove_duplicate=False))
    targets.update(model.named_buffers(remove_duplicate=False))
    expected = set(model.state_dict())
    if set(weights) != expected:
        raise RuntimeError(f"state_dict keys differ: missing {sorted(expected - set(weights))[:5]}, unexpected "
                           f"{sorted(set(weights) - expected)[:5]}")
    for name, full in weights.items():
        t = targets[name]
        if isinstance(t, DTensor):
            t._local_tensor.copy_(local_chunk(full, t))
        else:
            t.copy_(full)


class CheckpointManager:
    """Best-k training checkpoints monitored on a metric, with torn-save
    protection (the sweep, integrity records, the valid-step fallback; see
    the module docstring) and an in-place restore.

    Reference semantics: ModelCheckpoint(monitor=val_loss, mode=min,
    save_weights_only) (reference: perceiver/scripts/trainer.yaml:7-12), plus
    full-state (optimizer included) checkpoints for exact resume.
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: Optional[int] = 1,
        monitor: Optional[str] = "val_loss",
        mode: str = "min",
        save_weights_only: bool = False,
        enable_async: bool = False,
        retry=None,
        event_sink=None,
    ):
        """``enable_async=True`` overlaps the write with continued training
        (the Trainer turns it on): ``save`` returns once the copies of the
        state into pinned host buffers are enqueued, and a writer thread
        writes the step when they are done. One write is in flight at a time
        (the next ``save`` joins it first, as every read-side method and
        ``close`` do), and a write that failed raises at that join.

        ``max_to_keep=None`` retains every step (the Trainer's preemption
        saves use this so a final save never evicts the best-val step). With
        a ``monitor``, retention keeps the ``max_to_keep`` best steps by it
        (NaN or missing counts as worst) and every step whose metrics lack
        the monitor (forced saves); without one, the latest ``max_to_keep``.

        ``retry`` — a ``training.faults.RetryPolicy`` (or True for the
        default policy) around each step's write and read: a transient
        filesystem error is retried with bounded backoff, each attempt
        emitted as a ``fault.ckpt_retry`` event through ``event_sink``.
        ``FileNotFoundError`` is never retried: it is the torn-checkpoint
        fallback ladder's control signal, not a transient fault.

        ``event_sink`` — an ``obs.events.EventLog`` (or any ``emit(kind,
        **fields)`` sink). Process 0 alone writes; other processes read."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.save_weights_only = save_weights_only
        self.enable_async = enable_async
        if retry is True:
            from perceiver_io_tpu_torch.training.faults import RetryPolicy

            retry = RetryPolicy(max_retries=2, base_delay=0.2, max_delay=5.0)
        self.retry = retry
        self.event_sink = event_sink
        self._retry_sleep: Callable[[float], None] = time.sleep  # injectable (tests)
        # a barrier over the processes of a sharded run (the Trainer sets
        # it): a restore waits there for process 0's last write to commit
        self.sync: Optional[Callable[[], None]] = None
        self._config_written = False
        self._main_process = is_main_process()
        if self._main_process:
            os.makedirs(self.directory, exist_ok=True)
        self._pending_integrity: dict = {}
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._pinned: Dict[int, torch.Tensor] = {}  # snapshot buffers, by payload position
        # one row a save: the step, the seconds the caller was blocked in
        # save(), the writer's seconds and the payload's bytes on disk
        self.saves: List[dict] = []
        # what the last restore read: its step, and whether it carried the
        # optimizer's state (a weights-only restore zeroes it in place)
        self.last_restore: Optional[dict] = None
        self.quarantined: list = self._sweep() if self._main_process else []
        self._integrity = self._read_integrity()

    # -- integrity bookkeeping -------------------------------------------

    def _integrity_path(self) -> str:
        return os.path.join(self.directory, INTEGRITY_FILE)

    def _read_integrity(self) -> dict:
        try:
            with open(self._integrity_path()) as f:
                data = json.load(f)
            return dict(data.get("steps", {}))
        except (OSError, ValueError):
            return {}

    def _write_integrity(self) -> None:
        """Merge this manager's records into the file (another manager over
        the same directory, the Trainer's preemption save, may have added
        its own), keeping only steps whose directories exist."""
        if not self._main_process:
            return
        merged = {**self._read_integrity(), **self._integrity}
        self._integrity = {s: r for s, r in merged.items() if os.path.isdir(self._step_path(int(s)))}
        try:
            _write_json_atomic(self._integrity_path(), {"steps": self._integrity})
        except OSError as e:
            warnings.warn(f"checkpoint integrity record not written: {e}")

    def _flush_integrity(self) -> None:
        """Record integrity signatures for saves that have committed, then
        apply retention. Runs after every join of the writer."""
        if not self._pending_integrity:
            return
        done = []
        for step, rec in self._pending_integrity.items():
            path = self._step_path(step)
            if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
                continue
            self._integrity[str(step)] = {**_dir_stats(path), **rec}
            done.append(step)
        for step in done:
            self._pending_integrity.pop(step, None)
        if done:
            self._write_integrity()
            self._apply_retention()

    def _apply_retention(self) -> None:
        if self.max_to_keep is None or not self._main_process:
            return
        steps = [s for s in self._committed_steps() if self._step_valid(s)]
        if self.monitor:
            ranked = [s for s in steps if self.monitor in (self._metrics(s) or {})]
            sign = 1.0 if self.mode == "min" else -1.0
            # best first; among equals the newer first
            ranked.sort(key=lambda s: (sign * _monitor_value(self._metrics(s), self.monitor, self.mode), -s))
            drop = ranked[self.max_to_keep:]
        else:
            drop = steps[:-self.max_to_keep] if self.max_to_keep else steps
        for step in drop:
            shutil.rmtree(self._step_path(step), ignore_errors=True)
            self._integrity.pop(str(step), None)
        if drop:
            self._write_integrity()

    # -- torn-checkpoint detection / quarantine ---------------------------

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _committed_steps(self) -> List[int]:
        """Steps whose directories carry the commit marker (ascending)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, COMMIT_MARKER)))

    def _sweep(self) -> list:
        """Quarantine tmp leftovers and step directories without the commit
        marker (a save torn before its marker, a step dir half-copied onto
        shared storage). Returns the quarantined names."""
        moved = []
        for name in sorted(os.listdir(self.directory)):
            path = os.path.join(self.directory, name)
            if name == QUARANTINE_DIR or not os.path.isdir(path):
                continue
            if TMP_TAG in name or (name.isdigit() and not os.path.exists(os.path.join(path, COMMIT_MARKER))):
                self._quarantine(path)
                moved.append(name)
        return moved

    def _quarantine(self, path: str) -> None:
        target = _quarantine_path(self.directory, os.path.basename(path))
        shutil.move(path, target)
        warnings.warn(
            f"quarantined checkpoint dir {os.path.basename(path)!r} -> {target} "
            "(torn save — tmp leftover, missing commit marker, integrity "
            "mismatch — or a weights-only commit superseded by a forced "
            "full-state save)"
        )

    def _meta(self, step: int) -> Optional[dict]:
        try:
            with open(os.path.join(self._step_path(step), COMMIT_MARKER)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _metrics(self, step: int) -> Optional[dict]:
        rec = self._integrity.get(str(int(step)))
        if rec is not None:
            return rec.get("metrics")
        meta = self._meta(step)
        return None if meta is None else meta.get("metrics")

    def _step_valid(self, step: int) -> bool:
        """A step is restorable iff its dir carries the commit marker AND
        (when an integrity record exists) its file count/bytes match it."""
        path = self._step_path(step)
        if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
            return False
        rec = self._integrity.get(str(int(step)))
        if rec is None:
            return True  # unrecorded: the commit marker is all we have
        stats = _dir_stats(path)
        return stats["files"] == rec.get("files") and stats["bytes"] == rec.get("bytes")

    def _payload_has_opt_state(self, step: int) -> bool:
        """Whether a committed step carries the optimizer's state; an
        unreadable marker reads as False (for a forced full-state save,
        replacing an ambiguous commit with a known full payload is the safe
        direction)."""
        meta = self._meta(step)
        return bool(meta) and not meta.get("weights_only", True)

    def _quarantine_step(self, step: int) -> None:
        if self._main_process and os.path.isdir(self._step_path(step)):
            self._quarantine(self._step_path(step))
        self._integrity.pop(str(int(step)), None)
        self._write_integrity()

    def valid_steps(self) -> list:
        """Committed, integrity-clean steps (ascending). Invalid steps found
        here are quarantined so no later read can select them."""
        self.wait_until_finished()
        self._integrity = {**self._read_integrity(), **self._integrity}
        steps = []
        for step in self._committed_steps():
            if self._step_valid(step):
                steps.append(step)
            else:
                self._quarantine_step(step)
        return steps

    # -- event + transient-I/O-retry plumbing ------------------------------

    def _emit(self, kind: str, **fields) -> None:
        """Best-effort event emission (telemetry must never take a
        checkpoint op down); no-op without a sink."""
        if self.event_sink is None:
            return
        try:
            self.event_sink.emit(kind, **fields)
        except Exception:  # noqa: BLE001 — telemetry-only
            pass

    def _io_with_retry(self, fn: Callable, op: str):
        """Run one write or read under the retry policy (None = no retry).
        A ``FileNotFoundError`` propagates at once (it drives the torn-step
        fallback in :meth:`restore`), and exhaustion re-raises the ORIGINAL
        error."""
        policy = self.retry
        if policy is None:
            return fn()
        for attempt in range(policy.max_retries + 1):
            try:
                return fn()
            except policy.retry_on as e:  # noqa: PERF203 — retry loop
                if isinstance(e, FileNotFoundError) or attempt >= policy.max_retries:
                    raise
                delay = policy.delay(attempt)
                self._emit("fault.ckpt_retry", op=op, attempt=int(attempt), error=str(e),
                           delay_s=round(delay, 6))
                self._retry_sleep(delay)

    # -- save ----------------------------------------------------------------

    def _snapshot(self, tensors: List[torch.Tensor]) -> tuple:
        """Host copies of ``tensors``: card tensors into pinned buffers (kept
        for the next save) by copies enqueued on the current stream, so they
        read the state before any later work on that stream overwrites it;
        CPU tensors cloned. Returns the copies and the event their writer
        waits for (None when nothing came from a card)."""
        out, event = [], None
        for i, t in enumerate(tensors):
            t = t.detach()
            if t.is_cuda:
                buf = self._pinned.get(i)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = self._pinned[i] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                event = event or torch.cuda.Event()
            else:
                buf = t.clone()
            out.append(buf)
        if event is not None:
            event.record()
        return out, event

    def save(self, state, metrics: Optional[dict] = None, config=None, force: bool = False) -> bool:
        """Save ``state`` at ``state.step``. A step at or before the latest
        committed one is not saved (returns False), unless ``force``: the
        Trainer's preemption save, which needs no monitored metric and
        replaces a weights-only commit of the same step (exact resume needs
        the optimizer), but never a full-state one."""
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        if self.monitor and self.monitor not in metrics and not force:
            raise ValueError(f"metrics must contain monitored key {self.monitor!r}")
        # a sharded state is gathered on every process before any returns
        model, optimizer = _whole_payload(state, self.save_weights_only)
        if not self._main_process:
            return False
        self.wait_until_finished()
        step = int(state.step)
        if force:
            if os.path.exists(os.path.join(self._step_path(step), COMMIT_MARKER)):
                if self.save_weights_only or self._payload_has_opt_state(step):
                    return False
                self._quarantine_step(step)
        else:
            committed = self._committed_steps()
            if committed and committed[-1] >= step:
                return False
        copies, event = self._snapshot(list(model.values()) + optimizer)
        payload = {"step": step, "model": dict(zip(model, copies[:len(model)])),
                   "generator": None if state.generator is None else state.generator.get_state()}
        if not self.save_weights_only:
            payload["optimizer"] = copies[len(model):]
        meta = {"step": step, "weights_only": self.save_weights_only, "metrics": metrics,
                "tensors": _tensor_spec(state, self.save_weights_only), "generator": _generator_kind(state),
                "mesh": _mesh_shape(state)}
        row = {"step": step}
        self.saves.append(row)

        def job():
            if event is not None:
                event.synchronize()
            w0 = time.perf_counter()
            try:
                self._io_with_retry(lambda: self._write_step(step, payload, meta), "save")
            except BaseException as e:  # noqa: BLE001 — raised on the caller's thread at the next join
                self._write_error = e
                return
            row["write_s"] = time.perf_counter() - w0
            row["bytes"] = os.path.getsize(os.path.join(self._step_path(step), STATE_FILE))

        self._pending_integrity[step] = {"metrics": metrics}
        if self.enable_async:
            self._writer = threading.Thread(target=job, name=f"checkpoint-{step}", daemon=True)
            self._writer.start()
        else:
            job()
        if not self.enable_async:
            self.wait_until_finished()
        if config is not None and not self._config_written:
            # config.json must never exist without a committed checkpoint
            # (warm-start tooling reads config then restores): wait for the
            # first save to commit before the one-time config write
            self.wait_until_finished()
            save_config(self.directory, config)
            self._config_written = True
        row["block_s"] = time.perf_counter() - t0
        return True

    def _write_step(self, step: int, payload: dict, meta: dict) -> None:
        """One attempt: the payload into a fresh tmp dir, renamed into place,
        then the commit marker. A failed attempt leaves no tmp dir and no
        uncommitted step dir behind."""
        final = self._step_path(step)
        tmp = f"{final}{TMP_TAG}{uuid.uuid4().hex[:8]}"
        try:
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            if os.path.isdir(final):
                if os.path.exists(os.path.join(final, COMMIT_MARKER)):
                    raise FileExistsError(f"checkpoint step {step} under {self.directory} is already committed")
                shutil.rmtree(final)  # an earlier attempt's uncommitted rename
            os.rename(tmp, final)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        _write_json_atomic(os.path.join(final, COMMIT_MARKER), meta)

    def wait_until_finished(self) -> None:
        """Join the in-flight write (raising its error, if it failed), record
        the integrity of what committed, and apply retention."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            self._pending_integrity.clear()
            raise err
        self._flush_integrity()

    # -- read ----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """Best valid step by the monitored metric; NaN/missing-metric steps
        NEVER win. Returns None when nothing has a finite metric (callers
        fall back to ``latest_step``)."""
        if not self.monitor:
            return None
        candidates = []
        for step in self.valid_steps():
            v = _monitor_value(self._metrics(step), self.monitor, self.mode)
            if v == v and abs(v) != float("inf"):
                candidates.append((v, step))
        if not candidates:
            return None
        pick = min(candidates) if self.mode == "min" else max(candidates)
        return pick[1]

    def _load_payload(self, step: int) -> dict:
        """The payload of a committed step, on the CPU. A missing payload, or
        one that still cannot be read after the retries, raises
        ``FileNotFoundError``, the fallback ladder's signal for a torn step."""
        path = os.path.join(self._step_path(step), STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"checkpoint step {step} payload is missing (no {path})")
        try:
            return self._io_with_retry(lambda: torch.load(path, map_location="cpu", weights_only=True), "restore")
        except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
            raise FileNotFoundError(f"checkpoint step {step} payload is torn: {e}") from e

    def restore(self, state, step: Optional[int] = None):
        """Restore IN PLACE into ``state``'s tensors and return the same
        ``state``: the model's parameters and buffers, the optimizer's state
        tensors, ``state.step`` and ``state.generator``'s state. Every tensor
        keeps its storage, so a captured step replays without capturing
        again. ``step=None`` restores the latest VALID step: a torn step
        found on the way is quarantined and the next-newest tried.

        Restores what the checkpoint contains: a weights-only checkpoint sets
        the weights, step and generator and zeroes the optimizer's state in
        place (what a fresh ``make_optimizer`` holds); ``last_restore``
        says which it was.

        A sharded state restores on every process (each copies its blocks);
        onto a mesh of another shape than the step's it raises
        ``NotImplementedError`` (the reshard is ROADMAP A12 part 2)."""
        self.wait_until_finished()
        if self.sync is not None:
            self.sync()
        if step is not None:
            if not self._step_valid(step):
                raise FileNotFoundError(f"checkpoint step {step} under {self.directory} is missing or torn")
            return self._restore_step(state, step)
        candidates = self.valid_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        last_err: Optional[Exception] = None
        for step in reversed(candidates):
            try:
                return self._restore_step(state, step)
            except FileNotFoundError as e:
                last_err = e
                self._quarantine_step(step)
        raise FileNotFoundError(f"every checkpoint under {self.directory} failed to restore; last: {last_err}")

    def _restore_step(self, state, step: int):
        saved_mesh, mesh = (self._meta(step) or {}).get("mesh"), _mesh_shape(state)
        if saved_mesh != mesh:
            raise NotImplementedError(
                f"checkpoint step {step} was saved on the mesh {saved_mesh} and the state lies on {mesh}: a restore "
                "onto a mesh of another shape (the elastic reshard) waits for ROADMAP A12 part 2")
        payload = self._load_payload(step)
        saved = payload.get("optimizer")
        target = _optimizer_tensors(state)
        owners = _optimizer_owners(state)
        if saved is not None:
            wrong = [i for i, (t, shape, s) in enumerate(zip(target, _optimizer_shapes(state), saved))
                     if shape != tuple(s.shape) or t.dtype != s.dtype]
            if len(saved) != len(target) or wrong:
                raise ValueError(f"checkpoint step {step}'s optimizer state ({len(saved)} tensors) does not fit "
                                 f"the state's ({len(target)} tensors; mismatched at {wrong[:5]})")
        with torch.no_grad():
            if mesh is None:
                state.model.load_state_dict(payload["model"], strict=True)
            else:
                _load_sharded(state.model, payload["model"])
            if saved is None:
                for t in target:
                    t.zero_()
            else:
                from perceiver_io_tpu_torch.parallel.mesh import local_chunk

                for t, s, d in zip(target, saved, owners):
                    t.copy_(s if d is None else local_chunk(s, d))
        state.step = int(payload["step"])
        if payload.get("generator") is not None and state.generator is not None:
            state.generator.set_state(payload["generator"])
        self.last_restore = {"step": int(step), "optimizer": saved is not None}
        return state

    def preflight(self, state, step: Optional[int] = None, model_config=None) -> Optional[dict]:
        """Resume preflight: cheap compatibility checks BEFORE reading the
        payload, so an incompatible resume fails with one actionable
        :class:`ResumePreflightError` naming every problem:

        - **config**: ``model_config`` against the run's ``config.json``,
          each differing field named;
        - **tensors**: the step's recorded tensor names, shapes and dtypes
          against ``state``'s, each missing, extra or mismatched tensor named
          (the optimizer's only where both carry it);
        - **generator**: a checkpoint generator state with no generator in
          ``state``, or the reverse.

        Returns ``{"step": step}`` (None when there is nothing to resume
        from)."""
        if step is None:
            steps = self.valid_steps()
            if not steps:
                return None
            step = steps[-1]
        problems = []
        if model_config is not None:
            cfg_path = os.path.join(self.directory, CONFIG_FILE)
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    saved_cfg = json.load(f)
                problems.extend(_diff_config_dicts(saved_cfg, config_to_dict(model_config)))
        meta = self._meta(step) or {}
        if "tensors" in meta:
            problems.extend(_diff_tensor_specs(meta["tensors"], _tensor_spec(state, False)))
        if "generator" in meta and meta["generator"] != _generator_kind(state):
            problems.append(f"generator: checkpoint={meta['generator']!r} != state={_generator_kind(state)!r}")
        if problems:
            raise ResumePreflightError(self.directory, step, problems)
        return {"step": int(step)}

    def load_config(self):
        return load_config(self.directory)

    def close(self):
        """Join the in-flight write and release the pinned snapshot buffers."""
        self.wait_until_finished()
        self._pinned.clear()
