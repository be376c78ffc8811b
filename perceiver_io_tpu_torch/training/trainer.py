"""Trainer — the host-side loop around the port's train and eval steps
(counterpart of ``perceiver_io_tpu/training/trainer.py``: ``TrainerConfig``,
``Trainer.validate``, ``Trainer.fit``, ``Trainer.close``).

The loop is the JAX package's: periodic validation, best-k checkpointing
monitored on ``val_loss``, learning-rate and throughput logging, callbacks
after each validation, auto-resume, the preemption guard, the divergence
sentinel's skip -> rollback -> halt ladder and poison-batch quarantine. The
steps are the port's ``make_train_step`` and ``make_eval_step``: CUDA graphs
when the model lies on the card, eager on the CPU.

What the card changes:

- A rollback restores the checkpoint into the state's own tensors
  (``CheckpointManager.restore``), so the captured step replays on.
- The input double buffer enqueues the NEXT batch's host-to-device copies
  (from pinned memory) on a copy stream right after the current step is
  dispatched; the next iteration makes the current stream wait on their
  event and marks the tensors as used there (``record_stream``) before the
  step copies them into its graph's buffers.
- A step's metrics stay device tensors until the log boundary, except where
  the sentinel reads the loss and the skip flag on the host every step.
- Probes (``TrainerConfig.probes``, ``obs/probes.py``): each step's snapshot
  is a copy of the captured step's outputs (``graphs.CapturedStep`` returns
  copies), parked in a ring of ``ProbeConfig.ring`` entries without a host
  sync; the latest goes out as a ``probe`` row at each log boundary, and a
  sentinel skip, rollback or halt emits ``probe.blast`` (the first
  non-finite scope of the earliest snapshot in the ring) inside the step's
  span and clears the ring.

- A mesh (``Trainer(mesh=parallel.make_mesh(...))``, one process per
  device): ``fit`` shards the state (``training.loop.shard_train_state``),
  every batch is cut to the rank's block of the global batch
  (``parallel.mesh.shard_batch``, the leading dim over data x fsdp; the
  sequence-parallel loss slices its own prefix block, so the token dim is
  not cut), the steps run eagerly, the train and validation losses are the
  global batch's means, host writes (metrics, events, checkpoints) are
  process 0's, checkpoints hold the gathered state, and a barrier orders a
  restore after process 0's last write.

Options the port has no counterpart for yet raise ``NotImplementedError``:
the overlap step (ROADMAP A12 part 2, slice 2), ``graphlint`` and ``graphcheck``
(A14, analyses of JAX programs; off by default here).
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from perceiver_io_tpu_torch.obs.events import EventLog, write_run_manifest
from perceiver_io_tpu_torch.obs import probes as obs_probes
from perceiver_io_tpu_torch.obs.mfu import GoodputTracker, device_peak_flops
from perceiver_io_tpu_torch.obs.recompile import RecompileTracker
from perceiver_io_tpu_torch.obs.trace import Tracer, maybe_span
from perceiver_io_tpu_torch.training.checkpoint import CheckpointManager
from perceiver_io_tpu_torch.training.faults import (
    DivergenceHalt,
    DivergenceSentinel,
    PreemptionGuard,
    QuarantineIterator,
    SentinelConfig,
)
from perceiver_io_tpu_torch.parallel.mesh import batch_shards, shard_batch
from perceiver_io_tpu_torch.training.loop import make_eval_step, make_train_step, shard_train_state
from perceiver_io_tpu_torch.training.metrics import MetricsLogger
from perceiver_io_tpu_torch.training.state import TrainState


def _leading_dim(batch) -> int:
    """Batch size of a batch dict: the leading dim of its first array value
    in sorted key order (0 when it carries no arrays) — telemetry multiplies
    the per-sample token/FLOP accounting by this."""
    for key in sorted(batch):
        shape = getattr(batch[key], "shape", None)
        if shape:
            return int(shape[0])
    return 0


def _host_tensor(x):
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


class _Staged:
    """A batch prepared one step ahead: the raw batch (parked for a later fit
    if this one never consumes it), the step's batch (on the card, device
    tensors whose copies were enqueued on the copy stream) and the copies'
    event (None on the CPU)."""

    def __init__(self, raw, batch, event):
        self.raw, self.batch, self.event = raw, batch, event


@dataclass
class TrainerConfig:
    max_steps: int = 1000
    log_interval: int = 50
    val_interval: Optional[int] = None  # None = validate only at the end
    checkpoint_dir: Optional[str] = None
    max_checkpoints: int = 1
    monitor: str = "val_loss"
    mode: str = "min"
    save_weights_only: bool = False
    metric_prefix_train: str = "train_"
    metric_prefix_val: str = "val_"
    # the port's addition: make_train_step's microbatch (equal chunks of the
    # batch, one optimizer update), which the JAX trainer leaves at 1
    microbatch: int = 1
    # host-side batch production overlapped with device compute via a
    # producer thread (data/loader.py PrefetchIterator); 0 disables
    prefetch_batches: int = 2
    # device-side input double-buffering (see the module docstring); log rows
    # carry ``input_wait_ms``, the host time BLOCKED waiting for the consumed
    # batch, near zero when the buffer hits. On the CPU a batch is used where
    # it lies
    input_double_buffer: bool = True
    # the overlap-scheduled data x fsdp step: ROADMAP A12 part 2, slice 2 (raises when True)
    overlap: bool = False
    # parameters smaller than this JAX keeps replicated on a mesh (FSDP2
    # shards every parameter of a unit; the values are the same)
    fsdp_min_weight_size: int = 2**14
    # --- robustness (training/faults.py) ---------------------------------
    # SIGTERM/SIGINT request a final checkpoint at the next step boundary
    # and a clean return (the save itself needs checkpoint_dir). Installed
    # per fit, main thread only.
    preemption_save: bool = True
    # divergence sentinel: True (default thresholds) or a SentinelConfig;
    # the in-step skip compiles into the train step, the host-side ladder
    # walks skip -> rollback-to-last-checkpoint -> halt, every trip a
    # ``fault.*`` event
    sentinel: "bool | SentinelConfig" = False
    # drop batches carrying non-finite float leaves before they reach the
    # step, emitting ``fault.poison_batch`` with the offending leaf path
    quarantine_poison_batches: bool = False
    # numerics probes (obs/probes.py): True (the default ProbeConfig) or a
    # ProbeConfig; the stats are outputs of the train step, parked in a ring
    # on the device, emitted as a ``probe`` row at each log boundary, and a
    # sentinel skip/rollback/halt emits a ``probe.blast`` naming the first
    # non-finite scope, inside the step's span
    probes: "bool | object" = False
    # --- telemetry (obs/) --------------------------------------------------
    # events.jsonl + run_manifest.json next to metrics.csv (written only
    # when a logger is attached)
    events: bool = True
    # host spans (obs/trace.py): ``fit``, ``step``, ``eval``, ``checkpoint``
    # and ``resume``; every fault.*/resume/compile event emitted inside one
    # carries its span_id. Rows are flushed at log boundaries and fit exits
    spans: bool = True
    # analytic per-sample accounting for the tokens_per_sec /
    # model_flops_per_sec / mfu columns (obs.mfu.clm_train_telemetry);
    # None disables them
    tokens_per_sample: Optional[int] = None
    flops_per_sample: Optional[float] = None
    # peak FLOP/s of the card for the MFU denominator; None = look the card
    # up in obs.mfu.PEAK_FLOPS (none on the CPU: no mfu column)
    peak_flops_per_device: Optional[float] = None
    # the JAX package's jaxpr analyses of the train step (graphlint rules,
    # graph fingerprints): ROADMAP A14 (raise when True; the JAX trainer
    # defaults both to True)
    graphlint: bool = False
    graphcheck: bool = False


_UNPORTED = {
    "overlap": "the overlap-scheduled data x fsdp step waits for ROADMAP A12 part 2, slice 2",
    "graphlint": "graphlint (jaxpr lint rules) waits for ROADMAP A14",
    "graphcheck": "graphcheck (jaxpr fingerprints) waits for ROADMAP A14",
}


class Trainer:
    """``Trainer(loss_fn, ...).fit(state, train_iter, val_loader)``.

    - ``loss_fn(model, batch, generator) -> (loss, metrics)`` — the port's
      loss signature (``training.clm_loss_fn``), differentiated by the step.
    - ``eval_loss_fn(model, batch, generator)`` — run without gradient for
      validation, with ``generator=None``; by default ``loss_fn`` with
      ``deterministic=True`` when it takes that keyword, else ``loss_fn``.
    - ``mesh`` — optional ``DeviceMesh`` from ``parallel.make_mesh``: the
      state is sharded over it and every batch split (module docstring).
    - ``callbacks`` — callables ``cb(trainer, state, step)`` run after each
      validation.
    """

    def __init__(
        self,
        loss_fn: Callable,
        eval_loss_fn: Optional[Callable] = None,
        mesh=None,
        config: Optional[TrainerConfig] = None,
        logger: Optional[MetricsLogger] = None,
        lr_schedule: Optional[Callable] = None,
        callbacks: Sequence[Callable] = (),
    ):
        self.config = config or TrainerConfig()
        self.mesh = mesh
        for name, why in _UNPORTED.items():
            if getattr(self.config, name):
                raise NotImplementedError(f"TrainerConfig.{name}: {why}")
        self.logger = logger
        self.lr_schedule = lr_schedule
        self.callbacks = list(callbacks)
        # wraps the steps ONCE so the capture counts persist across fits
        self.recompiles = RecompileTracker()
        self._events: Optional[EventLog] = None
        self._manifest_written = False
        # the in-step half of the sentinel compiles into the step; the host
        # ladder is made fresh each fit
        self._sentinel_cfg = None
        if self.config.sentinel:
            self._sentinel_cfg = (self.config.sentinel if isinstance(self.config.sentinel, SentinelConfig)
                                  else SentinelConfig())
        in_step_skip = self._sentinel_cfg is not None and self._sentinel_cfg.in_graph_skip
        # the probes' selection, resolved once; the ring lives in fit()
        self._probe_cfg = None
        if self.config.probes:
            self._probe_cfg = (self.config.probes if isinstance(self.config.probes, obs_probes.ProbeConfig)
                               else obs_probes.ProbeConfig())
        self._train_step = self.recompiles.wrap(
            make_train_step(loss_fn, microbatch=self.config.microbatch, sentinel=in_step_skip,
                            probes=self._probe_cfg), "train_step")
        # the fit-scoped preemption guard, exposed so tests can trip it
        self._preempt_guard = None
        # dropout off during validation (Lightning model.eval() parity)
        deterministic = eval_loss_fn is None and "deterministic" in inspect.signature(loss_fn).parameters
        eval_fn = eval_loss_fn or loss_fn

        def eval_metrics(model, batch):
            if deterministic:
                return loss_fn(model, batch, None, deterministic=True)[1]
            return eval_fn(model, batch, None)[1]

        self._eval_step = self.recompiles.wrap(make_eval_step(eval_metrics, mesh=mesh), "eval_step")
        # batches a fit pulled but never consumed, re-injected by the next fit
        # on the SAME iterator (resume, curriculum phases); drained lazily
        self._residual_batches: deque = deque()
        self._residual_src = None  # weakref to the iterator they came from
        self._pending_prefetch = None  # a close()d prefetch whose producer was still alive
        self._copy_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self.checkpoints: Optional[CheckpointManager] = None
        if self.config.checkpoint_dir is not None:
            self.checkpoints = CheckpointManager(
                self.config.checkpoint_dir,
                max_to_keep=self.config.max_checkpoints,
                monitor=self.config.monitor,
                mode=self.config.mode,
                save_weights_only=self.config.save_weights_only,
                # the write overlaps training; fit() joins it before returning
                enable_async=True,
                retry=True,
            )
            if mesh is not None:
                self.checkpoints.sync = dist.barrier

    # -- helpers ----------------------------------------------------------

    def _prepare_batch(self, batch, device: torch.device, ahead: bool = False):
        """A batch for the step on ``device``, numpy arrays as host tensors.
        With ``ahead``, a :class:`_Staged` batch: on the card its arrays and
        CPU tensors go through pinned memory to the card on the copy stream
        (card tensors stay where they are); on the CPU it is the host batch.
        On a mesh, the rank's block of the global batch."""
        raw = batch
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        if not ahead:
            return tree_map(_host_tensor, batch)
        if device.type != "cuda":
            return _Staged(raw, tree_map(_host_tensor, batch), None)
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = torch.cuda.Stream(device)

        def to_device(x):
            if isinstance(x, np.ndarray) or (isinstance(x, torch.Tensor) and not x.is_cuda):
                return torch.as_tensor(x).pin_memory().to(device, non_blocking=True)
            return x

        with torch.cuda.stream(stream):
            staged = tree_map(to_device, batch)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(raw, staged, event)

    @staticmethod
    def _consume(staged: _Staged, device: torch.device):
        """The staged batch; on the card its copies ordered before the
        current stream's next work and its tensors marked as used on that
        stream (so the allocator keeps their memory until the step has read
        them)."""
        if staged.event is None:
            return staged.batch
        current = torch.cuda.current_stream(device)
        current.wait_event(staged.event)

        def mark(x):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(current)
            return x

        return tree_map(mark, staged.batch)

    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        if self.logger is not None:
            self.logger.log(step, metrics)

    def _ensure_events(self) -> Optional[EventLog]:
        """The run's event sink (events.jsonl beside metrics.csv), created on
        first use; None when telemetry is off or no logger is attached."""
        if not self.config.events or self.logger is None:
            return None
        if self._events is None:
            self._events = EventLog(self.logger.log_dir, main_process=getattr(self.logger, "_active", None))
        return self._events

    # -- API --------------------------------------------------------------

    def validate(self, state: TrainState, val_loader: Iterable) -> Dict[str, float]:
        """Mean of the per-batch metrics over the loader."""
        device = next(state.model.parameters()).device
        sums: Dict[str, float] = {}
        count = 0
        for batch in val_loader:
            metrics = self._eval_step(state.model, self._prepare_batch(batch, device))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        if count == 0:
            return {}
        return {self.config.metric_prefix_val + k: v / count for k, v in sums.items()}

    def fit(
        self,
        state: TrainState,
        train_iter,
        val_loader: Optional[Iterable] = None,
        model_config=None,
        resume: "bool | str" = False,
    ) -> TrainState:
        """``resume=False`` starts fresh; ``resume=True`` restores the latest
        checkpoint into ``state`` (no data-stream alignment);
        ``resume="auto"`` is the preemption-safe mode — restore the latest
        VALID checkpoint when one exists (fresh start otherwise), fast-forward
        the data iterator by the restored step count so the stream realigns,
        truncate ``metrics.csv`` rows past the restore point, and emit a
        ``resume`` event. With a restartable iterator a preempted and
        auto-resumed run reproduces the uninterrupted run (the generator's
        state rides in the checkpoint). Every restore writes into ``state``'s
        own tensors and the same ``state`` is returned. Auto-resume drops
        residual batches parked by a previous fit on this Trainer: they
        encode the OLD stream position, which the fast-forward replaces."""
        cfg = self.config
        if self.mesh is not None:
            # idempotent: a state placed on this mesh already is returned as is
            state = shard_train_state(state, self.mesh, min_weight_size=cfg.fsdp_min_weight_size)
            dist.barrier()
        device = next(state.model.parameters()).device
        # a rank's batch is its block of the global batch: telemetry counts the global batch
        shards = 1 if self.mesh is None else batch_shards(self.mesh)
        auto_resume = resume == "auto"
        fast_forward_n = 0
        resume_info = None
        if resume and self.checkpoints is None:
            raise ValueError("resume requires checkpoint_dir")

        # --- telemetry: event sink, run manifest, goodput, MFU inputs -----
        events = self._ensure_events()
        goodput = GoodputTracker()
        self.recompiles.events = events
        self.recompiles.goodput = goodput
        if self.checkpoints is not None:
            self.checkpoints.event_sink = events
        if events is not None and not self._manifest_written:
            write_run_manifest(self.logger.log_dir, model_config=model_config, trainer_config=cfg,
                               main_process=getattr(self.logger, "_active", None))
            self._manifest_written = True
        peak = cfg.peak_flops_per_device
        if peak is None:
            peak = device_peak_flops(device)
        tracer = None
        fit_span = None
        span_stack = contextlib.ExitStack()
        if events is not None and cfg.spans:
            tracer = Tracer(events)
            fit_span = span_stack.enter_context(tracer.span("fit", ambient=True))

        if resume:
            try:
                with maybe_span(tracer, "resume"):
                    if auto_resume:
                        self._residual_batches.clear()
                        if self.checkpoints.latest_step() is not None:
                            pre_step = int(state.step)
                            self.checkpoints.preflight(state, model_config=model_config)
                            with goodput.measure("checkpoint"):
                                state = self.checkpoints.restore(state)
                            fast_forward_n = max(0, int(state.step) - pre_step)
                            resume_info = {
                                "from_step": pre_step,
                                "to_step": int(state.step),
                                "fast_forward_batches": fast_forward_n,
                            }
                            if self.logger is not None:
                                self.logger.truncate_after(int(state.step))
                    elif self.checkpoints.latest_step() is not None:
                        state = self.checkpoints.restore(state)
            except BaseException:
                # restore/preflight died BEFORE fit_start: close + flush the
                # fit span so the stream stays well-formed, then propagate
                span_stack.close()
                if tracer is not None:
                    tracer.flush()
                raise
        if fit_span is not None:
            fit_span.set("start_step", int(state.step))

        if events is not None:
            events.emit("fit_start", start_step=int(state.step), max_steps=cfg.max_steps)
            if resume_info is not None:
                events.emit("resume", **resume_info)

        sentinel = DivergenceSentinel(self._sentinel_cfg) if self._sentinel_cfg is not None else None
        # the last ring-length probe snapshots, on the device: fetched only at
        # log boundaries (``probe``) and on sentinel trips (``probe.blast``)
        probe_ring = deque(maxlen=max(int(self._probe_cfg.ring), 1)) if self._probe_cfg is not None else None
        guard = None
        if cfg.preemption_save:
            guard = PreemptionGuard()
            guard.install()
            self._preempt_guard = guard
        preempted = False

        # a fit_start is always paired with a fit_end, and an aborted run
        # still gets its goodput/recompile audit
        try:
            train_iter = iter(train_iter)
            src = train_iter
            if fast_forward_n:
                # consume the batches the pre-preemption run already trained on
                for _ in itertools.islice(train_iter, fast_forward_n):
                    pass
            if self._pending_prefetch is not None:
                # a previous fit's producer outlived its bounded close() join
                self._pending_prefetch.close()
                if self._pending_prefetch.alive():
                    raise RuntimeError(
                        "the previous fit's prefetch producer is still blocked inside the training "
                        "iterator; a second fit on it would race the producer thread"
                    )
                self._residual_batches.extend(self._pending_prefetch.residual)
                self._pending_prefetch = None
            same_src = self._residual_src is not None and self._residual_src() is src
            if not same_src:
                self._residual_batches.clear()
            residual_dq = self._residual_batches if same_src else None
            if residual_dq:

                def _drain(dq=residual_dq):
                    while dq:
                        yield dq.popleft()

                # lazy drain: unconsumed items REMAIN in the deque for the next fit
                train_iter = itertools.chain(_drain(), train_iter)
            if cfg.quarantine_poison_batches:
                # upstream of the prefetch: the scan runs in the producer thread

                def _on_poison(path, n, _ev=events):
                    if _ev is not None:
                        _ev.emit("fault.poison_batch", leaf=path, n_quarantined=n)

                train_iter = QuarantineIterator(train_iter, on_quarantine=_on_poison)
            prefetch = None
            start_step = int(state.step)
            if cfg.prefetch_batches > 0 and start_step < cfg.max_steps:
                # only when steps will actually run — a no-op fit must not pull
                # (and discard) items from a shared stateful iterator
                from perceiver_io_tpu_torch.data.loader import PrefetchIterator

                train_iter = prefetch = PrefetchIterator(train_iter, depth=cfg.prefetch_batches)
            window: list = []
            window_samples = 0
            pending: Optional[_Staged] = None
            pending_exc = None
            input_wait_s = 0.0
            # the open per-iteration span, closed at the NEXT iteration's top,
            # so an iteration's log/eval/checkpoint tail stays inside it
            step_span = None
            t0 = time.perf_counter()
            window_overhead0 = goodput.overhead()
            try:
                i = start_step
                while i < cfg.max_steps:
                    if guard is not None and guard.requested:
                        # the last consistent point to stop; the final save
                        # follows the prefetch cleanup below
                        preempted = True
                        break
                    if tracer is not None:
                        if step_span is not None:
                            tracer.end(step_span)
                        step_span = tracer.start("step")
                    t_in = time.perf_counter()
                    if pending_exc is not None:
                        # a deferred iterator failure surfaces where the
                        # unbuffered loop would have hit it
                        exc, pending_exc = pending_exc, None
                        raise exc
                    if pending is not None:
                        batch, pending = self._consume(pending, device), None
                    else:
                        batch = self._prepare_batch(next(train_iter), device)
                    step_wait_s = time.perf_counter() - t_in
                    input_wait_s += step_wait_s
                    if step_span is not None:
                        step_span.set("input_wait_ms", round(step_wait_s * 1e3, 3))
                    t_dispatch = time.perf_counter()
                    state, metrics = self._train_step(state, batch)
                    if probe_ring is not None and "probes" in metrics:
                        # park the snapshot (device tensors, copies of the
                        # graph's outputs) with the post-step counter, and
                        # keep the metrics clean for the log window
                        metrics = dict(metrics)
                        probe_ring.append((int(state.step), metrics.pop("probes")))
                    if step_span is not None:
                        step_span.set("dispatch_ms", round((time.perf_counter() - t_dispatch) * 1e3, 3))
                    if cfg.input_double_buffer and i + 1 < cfg.max_steps:
                        # the step above is queued on the card: enqueue the NEXT
                        # batch's copies now so they ride under it. Any
                        # iterator failure is deferred to the next iteration
                        try:
                            pending = self._prepare_batch(next(train_iter), device, ahead=True)
                        except StopIteration:
                            pending = None
                        except Exception as e:  # noqa: BLE001 — re-raised next iteration
                            pending, pending_exc = None, e
                    window.append(metrics)
                    window_samples += _leading_dim(batch) * shards
                    step = i = int(state.step)
                    if step_span is not None:
                        step_span.set("step", step)

                    if sentinel is not None:
                        decision = self._sentinel_decide(sentinel, events, metrics, step)
                        skipped_now = float(metrics.get("sentinel_skipped", 0.0)) > 0.5
                        if skipped_now and window:
                            # the held step's non-finite metrics must not
                            # poison the log-window mean
                            window.pop()
                            window_samples -= _leading_dim(batch) * shards
                        # blast-radius attribution: a trip with snapshots on
                        # record names the first scope of the earliest ring
                        # entry that went non-finite, inside the open step span
                        trigger = None
                        if decision is not None and decision.action in ("rollback", "halt"):
                            trigger = decision.action
                        elif skipped_now:
                            trigger = "skip"
                        if trigger is not None and probe_ring is not None and events is not None:
                            report = obs_probes.blast_report(probe_ring)
                            if report is not None:
                                events.emit("probe.blast", trigger=trigger, **report)
                                # an attributed incident is done: a later trip
                                # attributes to its own origin
                                probe_ring.clear()
                        if decision is not None and decision.action == "rollback":
                            from_step = step
                            # back to the last valid checkpoint, in place; the
                            # restored count rewinds the LR schedule with it
                            with goodput.measure("rollback"):
                                state = self.checkpoints.restore(state)
                            # a weights-only checkpoint zeroed the optimizer's
                            # state: the fresh optimizer, not the diverged one
                            opt_reinit = not self.checkpoints.last_restore["optimizer"]
                            step = i = int(state.step)
                            sentinel.reset_window()
                            if events is not None:
                                events.emit(
                                    "fault.rollback",
                                    from_step=from_step,
                                    to_step=step,
                                    reason=decision.reason,
                                    rollbacks=sentinel.rollbacks,
                                    opt_reinit=opt_reinit,
                                    **decision.detail,
                                )
                            # the window spans the diverged steps
                            window, window_samples, t0 = [], 0, time.perf_counter()
                            input_wait_s = 0.0
                            window_overhead0 = goodput.overhead()
                            if probe_ring is not None:
                                # the snapshots left describe the rolled-back
                                # trajectory: the replay starts fresh
                                probe_ring.clear()
                            continue
                        if decision is not None and decision.action == "halt":
                            if events is not None:
                                events.emit("fault.halt", step=step, reason=decision.reason, **decision.detail)
                            raise DivergenceHalt(
                                f"divergence sentinel halted the run at step {step} ({decision.reason})"
                            )

                    if (step % cfg.log_interval == 0 or step == cfg.max_steps) and window:
                        avg = {
                            cfg.metric_prefix_train + k: float(np.mean([float(m[k]) for m in window]))
                            for k in window[-1]
                        }
                        if self.lr_schedule is not None:
                            avg["lr"] = float(self.lr_schedule(step))
                        # throughput/MFU over GROSS window wall time; the
                        # goodput column says how much of it was overhead
                        elapsed = max(time.perf_counter() - t0, 1e-9)
                        avg["steps_per_sec"] = len(window) / elapsed
                        if cfg.tokens_per_sample:
                            avg["tokens_per_sec"] = cfg.tokens_per_sample * window_samples / elapsed
                        if cfg.flops_per_sample:
                            flops_per_sec = cfg.flops_per_sample * window_samples / elapsed
                            avg["model_flops_per_sec"] = flops_per_sec
                            if peak:
                                avg["mfu"] = flops_per_sec / peak
                        avg["input_wait_ms"] = input_wait_s * 1e3 / len(window)
                        window_overhead = goodput.overhead() - window_overhead0
                        avg["goodput"] = min(max(elapsed - window_overhead, 0.0) / elapsed, 1.0)
                        self._log(step, avg)
                        if events is not None:
                            events.emit("log", step=step, **avg)
                            if probe_ring:
                                # the log boundary is the agreed host sync:
                                # the LATEST snapshot only, in one copy
                                s_step, snap = probe_ring[-1]
                                events.emit("probe", step=s_step, scopes=obs_probes.snapshot_to_host(snap))
                        if tracer is not None:
                            tracer.flush()  # span rows land once per window
                        window, window_samples, t0 = [], 0, time.perf_counter()
                        input_wait_s = 0.0
                        window_overhead0 = goodput.overhead()

                    at_val = cfg.val_interval is not None and step % cfg.val_interval == 0
                    if (at_val or step == cfg.max_steps) and val_loader is not None:
                        # eval bucket = wall time MINUS any eval-step capture
                        # the recompile tracker booked as compile
                        eval_t0 = time.perf_counter()
                        compile_s0 = self.recompiles.total_compile_s
                        with maybe_span(tracer, "eval"):
                            val_metrics = self.validate(state, val_loader)
                        goodput.add("eval", (time.perf_counter() - eval_t0)
                                    - (self.recompiles.total_compile_s - compile_s0))
                        self._log(step, val_metrics)
                        if events is not None:
                            events.emit("eval", step=step, **val_metrics)
                        if self.checkpoints is not None:
                            with goodput.measure("checkpoint"), maybe_span(tracer, "checkpoint"):
                                self.checkpoints.save(state, metrics=val_metrics, config=model_config)
                        for cb in self.callbacks:
                            cb(self, state, step)
            finally:
                if step_span is not None:
                    tracer.end(step_span)
                    step_span = None
                parked = False
                if prefetch is not None:
                    prefetch.close()
                    # the prefetch pulled items ahead of the step loop — they
                    # precede anything still parked in the deque
                    self._residual_batches.extendleft(reversed(prefetch.residual))
                    if prefetch.alive():
                        self._pending_prefetch = prefetch
                    parked = True
                if pending is not None:
                    # a buffered batch pulled but never consumed: it came out
                    # of train_iter BEFORE anything recovered from the prefetch
                    self._residual_batches.appendleft(pending.raw)
                    pending = None
                    parked = True
                if parked:
                    try:
                        self._residual_src = weakref.ref(src)
                    except TypeError:  # not weakref-able (e.g. plain list_iterator)
                        self._residual_src = None
                # commit any in-flight async save even when the loop raises
                if self.checkpoints is not None:
                    with goodput.measure("checkpoint"):
                        self.checkpoints.wait_until_finished()
            if preempted:
                if events is not None:
                    events.emit("fault.preempt", step=int(state.step),
                                signals=0 if guard is None else guard.signal_count)
                if cfg.checkpoint_dir is not None:
                    # final preemption save: a monitor-free KEEP-ALL manager
                    # over the same directory — full state, no fresh val
                    # metric required, and retention can never evict the
                    # best-val step
                    with goodput.measure("checkpoint"), maybe_span(tracer, "checkpoint"):
                        pm = CheckpointManager(cfg.checkpoint_dir, max_to_keep=None, monitor=None, retry=True,
                                               event_sink=events)
                        pm.save(state, metrics={"preempted": 1.0}, config=model_config, force=True)
                        pm.close()
            elif val_loader is None and self.checkpoints is not None:
                # no validation: a final latest-state checkpoint via a
                # monitor-free manager (Lightning save-last parity)
                final_mngr = CheckpointManager(
                    cfg.checkpoint_dir,
                    max_to_keep=cfg.max_checkpoints,
                    monitor=None,
                    save_weights_only=cfg.save_weights_only,
                    retry=True,
                    event_sink=events,
                )
                with goodput.measure("checkpoint"), maybe_span(tracer, "checkpoint"):
                    final_mngr.save(state, config=model_config)
                    final_mngr.close()
        except BaseException:
            self._release_guard(guard)
            span_stack.close()
            if tracer is not None:
                tracer.flush()
            if events is not None:
                events.emit("fit_end", step=int(state.step), aborted=True, recompiles=self.recompiles.counts(),
                            **goodput.summary())
            raise
        self._release_guard(guard)
        span_stack.close()
        if tracer is not None:
            tracer.flush()
        if events is not None:
            events.emit("fit_end", step=int(state.step), aborted=False, preempted=preempted,
                        recompiles=self.recompiles.counts(), **goodput.summary())
        if self.mesh is not None:
            # process 0's writes (checkpoints, logs) are done before any rank returns
            dist.barrier()
        return state

    def _release_guard(self, guard) -> None:
        if guard is not None:
            guard.uninstall()
            if self._preempt_guard is guard:
                self._preempt_guard = None

    def _sentinel_decide(self, sentinel, events, metrics, step: int):
        """Feed one completed step to the sentinel (a host read of the loss
        and the skip flag); handle the skip/spike rungs (events only) inline
        and return the decision when the trainer must act (rollback/halt),
        escalating rollback to halt when there is no checkpoint."""
        skipped = False
        loss_val = None
        if "sentinel_skipped" in metrics:
            skipped = float(metrics["sentinel_skipped"]) > 0.5
        if "loss" in metrics:
            loss_val = float(metrics["loss"])
        decision = sentinel.observe(step, loss_val, skipped)
        if decision.action == "skip":
            if events is not None:
                events.emit("fault.skip", step=step, reason=decision.reason, skips=sentinel.skips)
            return None
        if decision.action == "ok":
            if decision.reason == "spike-noted" and events is not None:
                events.emit("fault.spike", step=step, **decision.detail)
            return None
        if decision.action == "rollback" and (self.checkpoints is None or self.checkpoints.latest_step() is None):
            decision = sentinel.notify_rollback_unavailable()
        return decision

    def close(self) -> None:
        """Release the checkpoint manager (waits for an in-flight save)."""
        if self.checkpoints is not None:
            self.checkpoints.close()
            self.checkpoints = None
        if self._events is not None:
            self._events.close()
