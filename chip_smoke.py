#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

Usage, from the root of a checkout: ``python3 chip_smoke.py`` (one card).

Phases, each fatal on failure (nothing is caught to keep the exit code 0):

1. device: the card's name and power limit as ``nvidia-smi`` reports them;
2. build: every CUDA kernel of the serving, training and image paths is
   compiled from the sources in ``perceiver_io_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all at once; the Triton kernels compile at their
   first launch), with each kernel's registers and spills from ptxas (no
   kernel may spill) and the tensor-core instructions of K2's, K4a's,
   K4b's, K6's, K7a's, K7b's, K8's, K9a's and K9b's builds from
   ``cuobjdump -sass`` (TF32 in every f32 build of K2, K4a, K6, K7a and K8,
   f64 DMMA in every f32 build of K4a, K4b, K7a, K7b, K9a and K9b, bf16 in
   the bf16 builds of all nine);
3. kernel parity: each kernel against its plain PyTorch version on the card
   at the flagship's serving and training shapes and the image classifier's,
   with the tolerance stated beside each case, and its median device time
   (``time_ms``: operands evicted from L2, the card kept busy across the
   start event) beside the plain version's, the PyTorch library call's where
   one computes the same function, the least time the card could take
   (``bound_ms``; f32 attention at the split-TF32 rate), and the host's
   dispatch time of one call (``dispatch_ms``):
   K2 packed flash forward, K3 paged decode (at the serve's CA and latent
   SA pools, the CA pool with a retired slot of length 0 whose table row
   points at the scratch page, and one profiled call that must show K3's
   walk and merge and no other device op), K1 LayerNorm forward (with and
   without its statistics), K4a/K4b packed flash backward, K5 LayerNorm
   backward, K6/K7a/K7b two-segment flash, K8/K9a/K9b heads-major flash
   (the classifier's cross-attention, 512 latents over 50176 pixels with one
   264-wide head, and odd-width, causal, pad-mask and split-walk cases);
   and the bf16 builds of the bf16 CLM's path (K2 at the serve's, the
   shared-prefix prefill's (512 latents over the filled slots of a
   contiguous cache) and the train step's cross-attention, its kv split timed against the unsplit
   walk, K3 at the serve's CA and SA pools and ``ca_retired``, K4a/K4b at
   the train step's cross- and self-attention, K6/K7a/K7b at the twoseg
   cases above, K1/K5 at 16384 x 512 and 15360 x 512) and of the bf16 image
   step's
   (K8/K9a/K9b at the image CA, batch 16 and a split batch 2; K2/K4a/K4b at
   its self-attention; K1/K5 at 8192 x 1024), each held by ``check_bf16`` to the
   plain version evaluated in f64 on the same bf16 inputs (no further than
   1.25x the bf16 plain version, 1.0x for K3, in L2) and within 2e-2 (K3
   1e-2) of the bf16 plain version's largest magnitude, with the library
   yardsticks in bf16 and bounds at half the bytes and the bf16 tensor-core
   rate;
4. serve: the flagship-width Perceiver AR CLM (seeded random weights)
   answers six greedy requests through ``EngineFrontEnd``, its decode step
   the CUDA graph captured at construction (whose kernel nodes must hold
   K3's walk and merge 9 times and K1 as often as the eager step launches
   them, and no K2); every served stream must equal the sequential
   ``make_decode_fns`` stream up to the first step where the sequential
   logits' top-2 gap is a near tie (the paged and contiguous decodes sum in
   different orders); the page allocators must end empty, every kernel of
   the serving path must have launched during the serve, and K3 exactly 9
   times a decode step (the CA and 8 SA layers); the same requests through
   the eager step must give the same streams token for token over the same
   decode steps (at least 64); then a profiled serve on each step; the
   sequential streams come from ``make_decode_fns``' captured step;
5. train: the flagship at full width and depth (16384 tokens, 1024 latents,
   8 layers, seeded random weights) takes five AdamW steps (lr 1e-3, f32
   moments, global clip 1.0) on one fixed batch of 4 in 2 chunks, with a
   fresh host-sampled prefix keep set per step, as one CUDA graph a step
   (its nodes holding K1/K5 38, K2/K4a/K4b 18 times); every loss must be
   finite, the fifth below the first, no step skipped by the non-finite
   sentinel, and every kernel of the training path must have launched; a
   step whose loss is NaN must hold parameters, moments and counts bit for
   bit; then one more step and one profiled step; all again eagerly, the
   graph's losses and parameters within ``GRAPH_RTOL`` of the eager run's;
6. train_twoseg: the same (graph and eager) from the same seed, weights,
   batch and keep sets under ``fast_kernels({"twoseg"})``, where each
   chunk's cross-attention takes the two-segment kernels (K6 forward,
   K7a/K7b backward; 2 launches each per step) and K2/K4 run the 16
   self-attention layers only; every loss must equal the concat route's
   within a stated tolerance;
7. eval_twoseg: one cache-free, no-grad forward of the flagship at its full
   window (15360 prefix rows, 1024 latents) on each route; the logits must
   agree within 1e-4;
8. gradient check: one train-step gradient of a full-width model (512
   channels, 8 heads; 2048 tokens, 256 latents, 2 layers) on the card
   against the same gradient on the CPU (plain versions), from the same
   weights, batch and keep set, and the optimizer update each side makes
   from it; once on the concat route, once under "twoseg";
9. serve_bf16: the serve with bf16 compute (``dtype=torch.bfloat16``, f32
   parameters) and bf16 page pools through the captured decode step: K3's
   bf16 build 9 times a decode step and no f32 build, its graph's nodes,
   TTFT and decode tok/s, every stream equal to the sequential bf16 stream
   up to its first top-2 gap under ``NEAR_TIE_BF16``; then
   serve_admission_bf16, the same model behind the admission tier (ROADMAP
   A6): a 16-request fault plan under a ``ManualClock`` (``admission_drive``:
   a kill, a prefill failure, a stall past a deadline, a cancel of a live
   slot, the five shed reasons, a poisoned prefill, one breaker cycle, a
   drain) booked exactly as planned, its events valid, its ok streams the
   sequential ones, one capture, K3's bf16 build 9 times a step, the
   parameters unchanged; then the front end's cost (events and breaker on
   and off, in turns) and an open loop at twice the closed loop's rate;
   then serve_share_evict_bf16 (ROADMAP A7 + A8), the same model and
   engine geometry: six requests sharing a 12288-token document (five
   prefix hits of 768 pages, every shared prefill K2 bf16 9 times, the
   sharing audit clean mid-run and at drain, TTFT beside an unshared
   engine's), eight requests under page pressure (evictions, as many
   resumes by prefill replay, each replay K2 bf16 9 times) and a journal
   recovered by a fresh engine after the first was dropped mid-decode (the
   journal's books across both engines, a second recover all skipped);
   every stream the sequential one up to its first near tie, and no dense
   attention call on the card while an engine serves;
10. train_bf16: the train phase (concat) with bf16 compute and bf16 Adam
    moments, graph and eager, equal bit for bit, every launch a bf16 build;
    its step ms, tokens/s and busy share beside the f32 step's;
11. grad_check_bf16: grad_check's gradient in bf16 on the card against the
    CPU's f32 gradient, per parameter no further (L2) than 1.5x the CPU's
    bf16 gradient;
12. train_twoseg_bf16: train_bf16 under "twoseg" (K6/K7a/K7b's bf16
    builds 2 launches each a step, K2/K4a/K4b's 16), graph and eager equal
    bit for bit, each loss within ``TWOSEG_LOSS_TOL_BF16`` of train_bf16's;
13. eval_twoseg_bf16: eval_twoseg in bf16, the two routes' logits within
    ``TWOSEG_EVAL_L2_BF16`` (L2, relative), only bf16 builds launched;
14. grad_check_twoseg_bf16: grad_check_bf16 under "twoseg" on the card and
    the CPU;
15. decode_pair: ``generate``/``make_decode_fns`` at full width, its step
    the captured CUDA graph: 128 greedy tokens after one 8192-token prompt
    (batch 1) and after four serve prompts (batch 4), in f32 and in bf16
    with f32 and bf16 caches, each stream equal to the eager step's token
    for token and to ``generate``'s, tok/s of both, the graph's nodes K1
    only;
16. image_eval: the Perceiver IO image classifier of ``bench.py``'s image
   bench (224x224x3, 64 bands, 512 x 1024 latents, 6 x 8 shared SA layers,
   1000 classes; seeded random weights, f32) classifies 16 random images
   through ``make_eval_step`` (a CUDA graph) on the split-kv route and on
   the standard route: finite logits that agree within
   ``IMAGE_ROUTE_TOL``, a replay's within ``GRAPH_RTOL`` of the eager
   forward's, and K8 1, K2 48, K1 101 launches a forward, exactly;
17. image_train: five AdamW steps (lr 1e-3, clip 1.0) of that classifier on
    one fixed batch of 16 random images and labels, as a CUDA graph and
    eagerly: every loss finite, the second below the first, no step
    skipped, each step launching K8, K9a, K9b once, K2, K4a, K4b 48 times
    and K1, K5 101 times, exactly; the graph's losses within
    ``GRAPH_RTOL`` of the eager run's; then one profiled step of each;
18. image gradient check: the classifier at full width on 32x32 images and
    one block of 2 layers, the card's gradient and optimizer update against
    the CPU's;
19. image_trajectory: five train steps of that reduced classifier at lr
    1e-3 on the card (a CUDA graph) and on the CPU, the losses compared step
    by step;
20. image_eval_bf16: image_eval with bf16 compute (``dtype=torch.bfloat16``,
    f32 parameters), the JAX package's image benchmark default: every
    launch a bf16 build (the standard route's kv_norm reads the f32 joined
    input: one f32 K1), a replay equal to the eager forward bit for bit,
    the two routes within ``IMAGE_ROUTE_TOL_BF16`` and each within
    ``IMAGE_BF16_TOL`` of the f32 forward's logits (L2, relative);
21. image_train_bf16: image_train with bf16 compute and f32 Adam moments,
    graph and eager, equal bit for bit, the first step lowering the loss,
    K8, K9a and K9b's bf16 builds once a step and no f32 build; its step
    ms, images/s and busy share beside the f32 step's;
22. image_grad_check_bf16: image_grad_check's classifier in bf16 on the
    card against the CPU's f32 gradient, per parameter no further (L2) than
    1.5x the CPU's bf16 gradient;
23. serve_spec_bf16 (ROADMAP A9): serve_bf16's model and engine in the
    speculative slot mode (``spec_k`` 4, ``spec_depth`` 6): (a) serve's six
    greedy requests, (b) the same with eviction at pool headroom 0.5, each
    through the span step captured at construction (its graph's nodes: K3's
    walk and merge 35 times, K1, no K2) with K3's bf16 build exactly 35
    times a step (the drafter's 5 steps over its CA and 6 SA pools; none on
    the verify, whose span attention takes the gather route), K2 9 times a
    prefill, one capture, the books, audit and pages clean, every stream the
    sequential bf16 stream up to its first near tie; decode tok/s beside
    serve_bf16's engine on the same requests, acceptance, tokens a step,
    TTFT, one profiled step's busy share, the verify's gather and attend ms,
    the pools' memory and the peak; (c) the speculative pair against the
    graphed sequential pair and ``generate`` (batch 1, 8192 tokens, 128 new);
24. beam_bf16 (A10): ``beam_search`` of the bf16 flagship over a
    4096-token prompt, 64 new tokens, one beam (equal to the sequential
    stream up to its first near tie) and four (one captured step a call, K1
    nodes only), tok/s beside ``generate``'s;
25. load_bf16 (A11.2): ``obs.loadgen.run_load`` through the instrumented
    pair at the flagship (bf16), each prompt length's capture paid before
    the window, then 128 warm requests of a closed loop at concurrency 2 and
    128 of an open loop at half the closed loop's service rate, TTFT, TPOT
    and tok/s,
    each log's ``build_slo_report`` agreeing with ``summarize_load``; a
    ``FlightRecorder`` bound under the measured TTFT writes exactly one dump
    naming the breaching request; an ``ObsServer`` answers ``/metrics``,
    ``/slo`` and ``/healthz`` over an ``EngineFrontEnd`` while it serves (K3
    launches, books balanced); then profile_rollup (A11.3):
    ``obs.profiler.rollup`` of one eager bf16 train step (K2, K4a, K4b, K1
    under ``train_step``) and one graphed serve (K3 under
    ``decode_paged``).

The probes (ROADMAP A11.3): train_probes_bf16 (after fit_bf16) runs
train_bf16's graphed step with ``ProbeConfig()`` (losses equal bit for bit,
train_bf16's hand-written kernel nodes plus the stats' reductions, each
step's snapshot a copy, step ms beside train_bf16's) and a probed, sentineled
``Trainer.fit`` whose NaN batch emits one ``probe.blast`` naming a gradient
bucket; decode_probes_bf16 (after decode_pair) runs decode_pair's batch-1
prompt in bf16 with ``probes=True`` (the unprobed stream token for token,
every ``kv_cache_frac`` the host's, tok/s beside the unprobed pair's), and a
``RequestFrontEnd(FrontEndConfig(probes=True))`` request on poisoned weights
opens the breaker through the ``nonfinite-logits`` sentinel.

The training options (ROADMAP A4), each a train pair (graph and eager, from
the same seed, weights, batch and keep sets) of the flagship:

- train_remat (f32, after train_twoseg's phases), train_remat_bf16 and
  train_offload_bf16 (after grad_check_twoseg_bf16): activation
  checkpointing or offloading; losses, gradients and parameters after the
  five steps equal to train's / train_bf16's bit for bit, graph against
  graph and eager against eager; at a lower peak of device memory, both the
  step's peak over what was allocated before its first call and a chunk's
  forward and backward peak (``chunk_activation_gb``); K1 and K2 launch twice
  a step (the backward's recompute);
- train_mask_bf16 and train_mask_twoseg_bf16: the "mask" prefix-dropout
  mode (all 15360 prefix rows, the 7680 dropped ones masked), K2/K4 (or
  K6/K7 and K2/K4 for the latents) at 1024 x 16384 with a scattered kv
  bias; each loss within ``MASK_LOSS_TOL_BF16`` of train_bf16's on the same
  keep sets; the mask-mode kernel cases (``ca_mask_bf16``,
  ``train_ca_mask_bf16``) hold those kernels to their plain versions;
- train_dropout_bf16: post-attention and residual dropout 0.1 from a CUDA
  generator (the dense attention route: no attention kernel), the loss
  falling, graph equal to eager bit for bit; then its step at lr 0 on one
  batch and keep set: two replays draw other masks (other losses), the
  eager steps give the same three losses;
- optim: Adam (f32 and bf16 moments), Lamb, SGD, AdamW with accumulation
  and a frozen layer, Lamb with accumulation: graph against eager bit for
  bit, and the card's update against the CPU's;
- image_train_remat_bf16 (after image_train_bf16): the classifier with
  checkpointing (the standard route, as the JAX package's gate sends it),
  ``IMAGE_STEP_REMAT_BF16``'s launches exactly, each loss within
  ``IMAGE_REMAT_LOSS_TOL`` of image_train_bf16's, at a lower peak.

The trainer (ROADMAP A5), after optim: fit_bf16, ``Trainer.fit`` around
train_bf16's captured step (seed, weights, batch of 4 in 2 chunks, host keep
sets, bf16 moments; a 2-step warmup, clip 1.0) for 8 steps with the
sentinel, prefetch 2, the input double buffer, a log row every 2 steps and
validation and a checkpoint every 4: the fit's losses and parameters equal a
bare loop of the step bit for bit; a fit preempted at step 4 and resumed by a
fresh Trainer into a fresh state equals it bit for bit (losses, parameters,
optimizer tensors, generator); a sentinel ladder (a skip, then a rollback to
the step-4 checkpoint written into the same tensors, no recapture); the
fit's launches exactly train_bf16's a step plus the validations'; its ms a
step against the bare step's (sentinel on and off), input wait, async-save
block and write times, restore time, checkpoint bytes, peak memory and mfu.

The Perceiver IO task models (ROADMAP A13, part 1), after
image_grad_check_bf16, each at the full width of a published configuration
with seeded random weights: mlm_fill and mlm_fill_bf16 (the masked LM at
deepmind/language-perceiver's width, 201,108,230 parameters: a batch of 8
byte sequences of 2048 tokens, 15% masked, four rows right-padded, through
``make_eval_step``; its launches and graph nodes exactly, the replay against
the eager forward, two rows' logits against the port on the CPU; in f32
``MaskFiller`` on four samples, its top-1 fills the CPU's up to a near tie);
mlm_train_bf16 and text_clf_train_bf16 (that model and the text classifier
over its encoder, AdamW, 5 steps on one batch of 8, graph and eager bit for
bit, then a gradient check in bf16 and a 3-step f32 loss trajectory against
the CPU at 2 self-attention layers); flow and flow_bf16 (optical flow at
deepmind/optical-flow-perceiver's width: one 368 x 496 pair against the same
forward with every kernel on its plain version on the card, then
``OpticalFlowProcessor.process`` on one patch and on a 400 x 560 pair of 4
blended patches); timeseries_train (scripts/timeseries.py's defaults, f32,
batch 8, graph and eager, the gradient and trajectory against the CPU at
full size). Their kernel geometries join the kernel parity cases: K8/K9 at
the masked LM encoder's 8 heads of q/k 32 and v 160, at optical flow's
cross-attention (2048 x 182,528, one head of 322) and decoder (182,528 x
2048, 512; forward only) and at the time series' heads of 256; K2/K4 at the
masked LM decoder's 2048 x 256, 8 heads of 32/96, non-causal, and (bf16) at
the text classifier decoder's one query over 256 latents, 8 heads of 32; K2
at optical flow's self-attention; K1/K5 at C 768, 1280 and 322, K1 with its
statistics at the time series' C 256. The image classifier's and the task
models' train steps, gradient checks and trajectories run one routine each
over a ``TrainTask`` (``TASKS``). Busy shares count kernels, copies and
memsets, not the GPU-side copies of the port's profiler ranges.

The symbolic audio model, the inference tier and the CLI (ROADMAP A13,
part 2), after flow_bf16 (``a13_phases``), files under a temporary
directory: sam_generate and sam_generate_bf16 (the SAM at the GiantMIDI-
Piano geometry, 97,072,517 parameters, saved by ``save_pretrained`` and
served by ``pipeline("symbolic-audio-generation", model_dir=...)``: a
6000-token prompt of ``midi.encode_notes`` over seeded notes, 512 tokens at
top_k 15, 1904 latents, both windows sliding; the prefill's K2 and K1, the
decode step's graph, one seed one stream, the ids below ``PAD_ID`` and
decoded to notes, the greedy stream against the plain versions' up to the
first near tie, the graphed stream against the eager one, prefill ms,
decode tok/s and memory at three prompt lengths); lightning_roundtrip (the
f32 SAM exported to reference names and imported back bit for bit, the
same ids through the pipeline); sam_train_bf16 (``TASKS["sam"]``: batch 16
of the synthetic motif corpus, graph and eager bit for bit, the gradient
and trajectory against the CPU at one layer) and sam_cli_fit_bf16
(``scripts/audio/symbolic.py fit`` at train.sh's flags, 4 steps, its
metrics log read back); pipelines (text-generation sampled and with two
beams, fill-mask, sentiment-analysis, image-classification, optical-flow,
each at depth 2 through ``pipeline(task, model_dir=...)`` and equal to the
same model called directly); mnist_fit (``scripts/vision/
image_classifier.py fit --smoke``, 20 steps) and timeseries_fit
(``scripts/timeseries.py fit`` at its defaults on a CSV written here).
Their kernel geometries join the parity cases: K2/K4 at the SAM's 8 heads
of 96 (prefill CA 1904 x 6000 and SA, train CA 2048 x 4096 and SA at batch
16 in bf16, batch 2 in f32) and MNIST's self-attention and decoder, K8/K9
at MNIST's CA (one head of 131), K1/K5 at C 768 and MNIST's C 131.

The text data, the text CLIs, the fleet router and the simulator (ROADMAP
A13, part 3), after a13_phases (``a13_text_phases``), files under a
temporary directory: text_clm_cli_fit_bf16 (``scripts/text/clm.py fit`` at
its paper preset, ``TEXT_CLM``: 4096 tokens, 512 latents x 512, 8 heads of
64, 8 layers, batch 8, prefix dropout 0.5, bf16, on ``textfile`` data: the
repository's ``docs/*.md`` joined, ``README.md`` for validation, whose end
generates a sample on the card; K1, K2, K4a, K4b and K5 bf16 launch;
K2's, K4a's and K4b's launches over the train steps alone, by kv rows,
exactly once a step for the CA and 8 times for the SA; steps/s and the
peak recorded);
text_mlm_cli_fit_bf16 (``scripts/text/mlm.py fit`` at its defaults on the
synthetic corpus, then ``save_pretrained``) and text_classifier_cli_fit
(``scripts/text/classifier.py fit`` on the synthetic ``clf`` corpus, its
encoder warm-started from that artifact and frozen: bit for bit the
artifact's after the fit), each taking K2/K4 and K1/K5 and no other
kernel; serve_fleet_bf16 (a ``FleetRouter`` over two
``EngineFrontEnd`` replicas of serve_bf16's model and engine, each with a
journal, 12 greedy requests, r0 killed mid-decode and its journal replayed
onto r1: the fleet's books balanced with one failover, its audit empty,
one terminal outcome a request, r0's journal closed by handoff, K3, K2 and
K1 bf16 launched, every stream and one engine's on the same requests equal
to the sequential stream up to its first near tie, the failover's seconds
and the fleet's tok/s beside one engine's, the dropped fleet's memory given
back). After load_bf16, sim_bf16 (host work only): ``ServiceTimeModel.
from_load_doc`` fitted to load_bf16's closed-loop document, ``run_sim``
with two tenants at serve_bf16's ``EngineConfig`` and ``run_fleet_sim``
over two replicas: books balanced, allocator audits empty, the SIM
document written and logged with the fit beside the card. Its traffic has
no published source and only checks the books and audits: its results are
no finding, only its host seconds are. K2, K4a and K4b
bf16 join the kernel parity cases at the text CLM's train shapes
(``text_clm_ca_bf16``: 512 latents over 1792 kept prefix rows + the
latents; ``text_clm_sa_bf16``: 512²; 8 heads of 64, batch 8), each with its
launches a step as text_clm_cli_fit_bf16 counted them.

Training across processes (ROADMAP A12, part 1), last (``a12_phases``): the
card holds one process, so the group is NCCL at world size 1. dist_nccl
(``parallel.make_mesh`` starts the NCCL group itself; its backend, world
size and mesh; one all-reduce on the card); fsdp_clm_bf16 (the flagship in
bf16 with dropout off at batch 2, ``DIST_STEPS`` eager train steps under
``shard_train_state`` on a (data 1, fsdp 1) mesh against the same steps
unsharded from a copy of the same weights: losses and parameters within
``DIST_LOSS_RTOL`` / ``DIST_PARAM_ATOL``, the distances printed; peak
memory; K1, K2, K4a, K4b and K5 bf16 launches exactly ``DIST_PER_STEP`` a
step; then ``DIST_TIMED_STEPS`` steps of each kind interleaved for the step
times); ring_clm_bf16 (``make_ring_clm_loss`` on a (seq 1) mesh on the
same model and batch, deterministic: its loss and gradient against the dense
``clm_loss_fn``'s, each held to ``RING_RULE``: the ring's distance from the
f32 dense evaluation at most 1.5 times the dense bf16 one's plus a slack;
then ``RING_STEPS`` train steps through ``make_train_step`` on the sharded
state, their ms and peak, K2/K4a/K4b bf16 8 and K1/K5 19 launches: the latent stack, the
cross-attention's blocks being plain matmuls as in JAX); and
text_clm_cli_fsdp_bf16 (``scripts/text/clm.py fit`` at the paper preset
with ``--trainer.strategy=fsdp`` for ``CLI_STEPS["text_clm_fsdp"]`` steps,
its checkpoint resumed on the same mesh for 2 more, then
``--trainer.strategy=ring`` for ``CLI_STEPS["text_clm_ring"]``: finite
losses, the kernels launched).

The last three lines of standard output are the ``graph_nodes`` JSON line
(each captured graph's kernel nodes and launches), the ``kernels`` JSON line
and the result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, the script exits non-zero and prints
no result. Parity phases run with TF32 off for matrix products; an error
that is not finite fails every check.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import time
import typing

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(
    vocab_size=262, max_seq_len=16384, max_latents=1024, num_channels=512, num_heads=8,
    num_self_attention_layers=8, cross_attention_dropout=0.5,
)
NUM_LATENTS = 512
N_REQUESTS = 6
SERVE_SLOTS = 4
SERVE_GEOMETRY = dict(slots=SERVE_SLOTS, page_size=16, max_ca_tokens=16384, max_sa_tokens=1024)
NEAR_TIE = 1e-4
# decode_pair: greedy tokens after the prompt, and the batch-1 prompt's length
DECODE_NEW_TOKENS, DECODE_PROMPT = 128, 8192
# paged_phase's K3 cases at heads wider than 128: (heads, head dim)
WIDE_HEADS = ((2, 192), (2, 256), (1, 512))
# wide_serve_check: a small f32 model with heads of 256, its engine geometry
# and latents
WIDE_SERVE = (dict(vocab_size=262, max_seq_len=2048, max_latents=128, num_channels=512, num_heads=2,
                   num_self_attention_layers=2, cross_attention_dropout=0.5),
              dict(slots=4, page_size=16, max_ca_tokens=2048, max_sa_tokens=128), 64)
# serve_bf16's near tie: bf16 logits (|logit| < 2 at these random weights)
# have steps of 2^-8 to 2^-7, and the engine's K3 (f32 softmax weights) and
# the sequential decode's dense attention (weights rounded to bf16, as the
# JAX package rounds them) differ by a few such steps after 9 layers; a top-2
# gap under 0.05 (6 to 12 steps) may flip between the two
NEAR_TIE_BF16 = 5e-2
# the suffix under which build.LAUNCHES counts a kernel's bf16 build
BF16 = "_bf16"
# serve_admission_bf16, part 1: the fault plan's 16 requests (prompts of
# 2048-8192 tokens, budgets of 16-32) and the outcome each must book
# (admission_drive says why); the poisoned request (11) books ok, its stream
# is not compared (NaN logits)
ADMISSION_PROMPTS, ADMISSION_BUDGETS = (2048, 8192), (16, 32)
ADMISSION_OUTCOMES = {0: "error", 1: "error", 2: "timeout", 3: "shed", 4: "shed", 5: "cancelled", 6: "shed",
                      7: "error", 8: "error", 9: "shed", 10: "ok", 11: "ok", 12: "ok", 13: "ok", 14: "ok", 15: "shed"}
ADMISSION_SHEDS = {3: "deadline_unmeetable", 4: "kv_pages_exhausted", 6: "queue_full", 9: "breaker_open",
                   15: "draining"}
# serve_share_evict_bf16: part 1's shared document (768 pages of 16) and the
# distinct suffixes after it, budgets 32-64; part 2's eight prompts of
# 4096-8192 tokens and the pool headroom that makes a queued request evict
# (the SA pool then holds three requests' latent streams of 544-576 tokens);
# part 3's six requests, decoded this many steps before the engine is dropped
SHARE_DOC, SHARE_SUFFIXES, SHARE_BUDGETS = 12288, (1024, 3072), (32, 64)
EVICT_PROMPTS, EVICT_BUDGETS, EVICT_HEADROOM, EVICT_REQUESTS = (4096, 8192), (32, 64), 0.5, 8
RECOVER_PROMPTS, RECOVER_BUDGETS, RECOVER_REQUESTS, RECOVER_STEPS = (2048, 4096), (16, 32), 6, 5
ADMISSION_POISONED = 11
# serve_spec_bf16: bench.py's committed A/B geometry (k = 4 drafts a span from
# a 6-layer self-drafter); beam_bf16: beams, prompt and new tokens
SPEC_K, SPEC_DEPTH = 4, 6
BEAM_WIDTH, BEAM_PROMPT, BEAM_NEW_TOKENS = 4, 4096, 64
# the train phase: batch 4 in chunks of 2, five steps
TRAIN_BATCH, TRAIN_MICROBATCH, TRAIN_STEPS, TRAIN_LR = 4, 2, 5, 1e-3
TRAIN_CHUNK = TRAIN_BATCH // TRAIN_MICROBATCH
PREFIX_LEN = FLAGSHIP["max_seq_len"] - FLAGSHIP["max_latents"]
KEEP = PREFIX_LEN - int(PREFIX_LEN * FLAGSHIP["cross_attention_dropout"])  # kept prefix rows: 7680
SERVE_KERNELS = ("flash_packed_fwd", "paged_decode", "layer_norm_fwd")
TRAIN_KERNELS = ("layer_norm_fwd", "flash_packed_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq", "layer_norm_bwd")
# the phases that run the bf16 builds, by kernel: serve_bf16 K3,
# image_train_bf16 K8, K9a and K9b, train_bf16 the rest
TWOSEG_KERNELS = ("flash_2seg_fwd", "flash_2seg_bwd_dkv", "flash_2seg_bwd_dq")
BF16_PHASE = {**{k + BF16: "train_bf16" for k in TRAIN_KERNELS}, "paged_decode" + BF16: "serve_bf16",
              **{k + BF16: "train_twoseg_bf16" for k in TWOSEG_KERNELS},
              **{k + BF16: "image_train_bf16" for k in ("flash_heads_fwd", "flash_heads_bwd_dkv",
                                                          "flash_heads_bwd_dq")}}
ROUTE_FEATURES = {"concat": frozenset(), "twoseg": frozenset({"twoseg"})}
# per flagship train step (2 chunks): one CA and 8 SA layers per chunk;
# 3 CA + 16 SA LayerNorms per chunk on either route
PER_STEP = {"concat": {"flash_packed": 18, "flash_2seg": 0, "layer_norm": 38},
            "twoseg": {"flash_packed": 16, "flash_2seg": 2, "layer_norm": 38}}
# |loss(twoseg) - loss(concat)| per step of the five: about four times the
# largest difference measured on the card, 4.8e-7 (one f32 step at 5.6, in
# the fifth step; the first four were equal): the routes differ only in
# GEMM shapes and in the order of the K/V weight-gradient sums
TWOSEG_LOSS_TOL = 2e-6
# the same in bf16 (train_twoseg_bf16 against train_bf16): K6 and K2 sum
# the online softmax over other tiles at the seam, so a bf16 output may
# round to its other neighbour, and an Adam step moves a parameter by about
# lr * sign(g), whose sign a gradient within bf16 rounding of 0 may flip;
# 1e-2 (0.2% of a loss of 5.6) allows a few such flips, where a route that
# computed another function would be off by the loss's own steps (0.1-0.2)
TWOSEG_LOSS_TOL_BF16 = 1e-2
# eval_twoseg_bf16: the two routes' bf16 logits, L2 distance relative to
# the concat route's. K6 runs K2's bf16 tiles, and at the flagship the seam
# (15360 prefix rows) falls on a 64-row tile boundary, so the two walks
# visit the same tiles in the same order: measured 0.0 on an H100. 1e-3
# leaves room for a bf16 step (2^-8 relative) in a few logits, where a
# route that computed another function would be off by far more
TWOSEG_EVAL_L2_BF16 = 1e-3
# the train variants: the flagship config's training options, by variant
# name (the phases train_<variant>[_twoseg][_bf16])
TRAIN_VARIANTS = {
    "": {},
    "remat": dict(activation_checkpointing=True),
    "offload": dict(activation_offloading=True),
    "mask": dict(prefix_dropout_mode="mask"),
    "dropout": dict(post_attention_dropout=0.1, residual_dropout=0.1),
}
# train_mask_bf16 (and under twoseg) against train_bf16 (the gather mode) on
# the same keep sets, per step: the mask mode walks all 16384 keys with the
# dropped ones masked, so K2 (K6) sums the online softmax over other tiles,
# a bf16 output may round to its other neighbour, and an Adam step may flip
# the sign of a gradient within bf16 rounding of 0, as for
# TWOSEG_LOSS_TOL_BF16; a mode that kept other rows would be off by the
# loss's own steps (0.1-0.2)
MASK_LOSS_TOL_BF16 = 1e-2
# the Perceiver IO image classifier of bench.py:300-316 (image_bench): 224x224x3
# images with 64 Fourier bands (261 input channels), 512 latents x 1024
# channels, one cross-attention head, 8 self-attention heads, 6 layers x 8
# weight-shared blocks, 1000 classes; f32, seeded random weights
IMAGE_ENCODER = dict(image_shape=(224, 224, 3), num_frequency_bands=64, num_cross_attention_heads=1,
                     num_self_attention_heads=8, num_self_attention_layers_per_block=6,
                     num_self_attention_blocks=8, first_self_attention_block_shared=True)
IMAGE_DECODER = dict(num_classes=1000, num_output_query_channels=1024, num_cross_attention_heads=1)
IMAGE_LATENTS, IMAGE_CHANNELS = 512, 1024
IMAGE_PIXELS = 224 * 224
IMAGE_D = 264  # the cross-attention's one head: 261 channels zero-padded to a multiple of 8
# image_train: five steps on one batch of 16 in one chunk. Memory reckoning
# (f32): the 48 SA layers keep ~12 (16, 512, 1024) tensors each for the
# backward (~19 GB), the split-kv route ~4 (16, 50176, 264) tensors (~3.4
# GB), weights and AdamW moments ~1.4 GB: ~25 GB of the card's 80, so no
# microbatch chunks
IMAGE_BATCH, IMAGE_STEPS = 16, 5
# bench.py's rate. AdamW at 1e-3 overshoots on one memorized batch: the loss
# falls at the first step and rises later, on the card and on the CPU's
# plain versions alike (image_trajectory holds the card to the CPU step by
# step), so image_train checks the first step's fall, not the fifth's
IMAGE_LR = 1e-3
# |loss(card) - loss(CPU)| / loss(CPU) at each of image_trajectory's steps:
# the card's gradients differ from the CPU's by a few 1e-6 relative
# (image_grad_check); the overshoot it rules out as the port's is of order 1
IMAGE_TRAJECTORY_TOL = 1e-4
# image_grad_check's and image_trajectory's classifier: full width, 32x32x3
# images, one block of 2 layers
IMAGE_SMALL = dict(image_shape=(32, 32, 3), num_self_attention_layers_per_block=2, num_self_attention_blocks=1)
HEADS_KERNELS = ("flash_heads_fwd", "flash_heads_bwd_dkv", "flash_heads_bwd_dq")
# per classifier forward on the split route: K8 once (the encoder's CA), K2
# 48 times (6 x 8 SA layers), K1 101 times (the CA's q_norm and MLP norm, 2
# per SA layer, the decoder's q_norm, kv_norm and MLP norm; the CA's kv_norm
# is folded into the split K/V projection); a train step adds each
# backward once per forward launch
IMAGE_FORWARD = {"flash_heads_fwd": 1, "flash_packed_fwd": 48, "layer_norm_fwd": 101}
IMAGE_STEP = dict(IMAGE_FORWARD, flash_heads_bwd_dkv=1, flash_heads_bwd_dq=1, flash_packed_bwd_dkv=48,
                  flash_packed_bwd_dq=48, layer_norm_bwd=101)
# the bf16 classifier (image_eval_bf16, image_train_bf16): the same launches,
# every one a bf16 build (the latent stream is bf16 from the query array on,
# so every LayerNorm reads bf16), and no f32 build
IMAGE_FORWARD_BF16 = {**{k + BF16: n for k, n in IMAGE_FORWARD.items()}, **dict.fromkeys(IMAGE_FORWARD, 0)}
IMAGE_STEP_BF16 = {**{k + BF16: n for k, n in IMAGE_STEP.items()}, **dict.fromkeys(IMAGE_STEP, 0)}
# image_train_remat_bf16: checkpointing refuses the split route (as the JAX
# package's gate does), so the encoder's CA takes the standard route: the
# joined f32 input's kv_norm (one f32 K1, and its K5 for the weights) and K8
# bf16 on the 261-wide head; the backward recomputes every layer's forward
# (K1, K2, K8 twice a step); the backward kernels run once
IMAGE_STEP_REMAT_BF16 = dict(IMAGE_STEP_BF16, flash_heads_fwd_bf16=2, flash_packed_fwd_bf16=96,
                             layer_norm_fwd_bf16=202, layer_norm_fwd=2, layer_norm_bwd=1)
# |loss(image_train_remat_bf16) - loss(image_train_bf16)| / loss per step:
# the standard route against the split route, which round at other points
# in bf16 (image_eval_bf16 holds their logits within IMAGE_ROUTE_TOL_BF16 in
# L2); over five steps at lr 1e-3 the bf16 steps compound that
IMAGE_REMAT_LOSS_TOL = 2e-2
# |logits(split) - logits(standard)| at the flagship: the routes differ only
# in the order of the K/V projections' f32 sums (see image_eval_phase)
IMAGE_ROUTE_TOL = 1e-4
# image_eval_bf16, L2 distances relative to the f32 forward's logits: the
# bf16 split route against the bf16 standard route, which round at other
# points (the split route's bf16 K/V formula, the standard route's kv_norm
# then the bf16 projection), and each bf16 route against the f32 forward;
# about four times the distances measured on an H100 (5.7e-3 and 9.1e-3,
# PERF.md)
IMAGE_ROUTE_TOL_BF16 = 2e-2
IMAGE_BF16_TOL = 4e-2
# the bf16 gradient checks (model_grad_check_phase): the key-projection bias
# gradients (0 in exact arithmetic) of both bf16 evaluations, relative to
# the largest f32 gradient
ZERO_GRAD_BF16 = 1e-3
# the Perceiver IO task models (ROADMAP A13, part 1), seeded random weights:
# the masked LM at deepmind/language-perceiver's width (hf/convert.py of the
# JAX package maps PerceiverConfig(qk_channels=256, v_channels=1280) so:
# vocab 262, 2048 tokens of 768 channels, 256 latents x 1280, 8 cross- and 8
# self-attention heads of q/k 32 and v 160, 26 self-attention layers, a
# decoder of 2048 queries with 8 heads of 32/96 and no attention residual,
# tied logits; 201,108,230 parameters), its fill at batch 8 and its bf16
# train step at batch 8 (dropout 0.0, EncoderConfig's default)
MLM_ENCODER = dict(vocab_size=262, max_seq_len=2048, num_input_channels=768, num_cross_attention_heads=8,
                   num_cross_attention_qk_channels=256, num_cross_attention_v_channels=1280,
                   num_self_attention_heads=8, num_self_attention_qk_channels=256,
                   num_self_attention_v_channels=1280, num_self_attention_layers_per_block=26)
MLM_DECODER = dict(vocab_size=262, max_seq_len=2048, num_cross_attention_heads=8, num_cross_attention_qk_channels=256,
                   num_cross_attention_v_channels=768, cross_attention_residual=False)
MLM_QUERIES, MLM_INPUT, MLM_LATENTS, MLM_CHANNELS, MLM_BATCH = 2048, 768, 256, 1280, 8
MLM_PARAMS = 201_108_230
# the text classifier: that encoder with docs/model-construction.md's
# decoder (2 classes, one query of 256 channels, 8 heads of 32)
TEXT_CLF_DECODER = dict(num_classes=2, num_output_query_channels=256)
# optical flow at deepmind/optical-flow-perceiver's width (hf/convert.py:
# 368 x 496 frame pairs of 27 patch channels, 64 hidden + 258 Fourier = 322
# input channels, 2048 latents x 512, one cross-attention head of 322, 16
# self-attention heads of 32, 24 layers, a decoder of one head of 512
# without attention residual over one query a pixel), batch 1
FLOW_SHAPE, FLOW_LATENTS, FLOW_CHANNELS, FLOW_WIDTH = (368, 496), 2048, 512, 322
FLOW_PIXELS = FLOW_SHAPE[0] * FLOW_SHAPE[1]
FLOW_ENCODER = dict(image_shape=FLOW_SHAPE, num_cross_attention_heads=1, num_self_attention_heads=16,
                    num_self_attention_qk_channels=512, num_self_attention_v_channels=512,
                    num_self_attention_layers_per_block=24)
FLOW_DECODER = dict(image_shape=FLOW_SHAPE, num_cross_attention_heads=1, num_cross_attention_qk_channels=512,
                    num_cross_attention_v_channels=512, cross_attention_residual=False)
# a generated pair larger than one patch (the processor's grid: 2 x 2
# overlapping patches), through OpticalFlowProcessor.process
FLOW_BIG = (400, 560)
# the time series at scripts/timeseries.py's defaults: 7 channels, 4096 input
# and 5000 output steps, 64 bands, 256 latents x 256, one head everywhere, 8
# weight-shared one-layer self-attention blocks, batch 8, f32
TS_ENCODER = dict(num_input_channels=7, in_len=4096, num_frequency_bands=64, num_cross_attention_heads=1,
                  num_self_attention_heads=1, num_self_attention_layers_per_block=1, num_self_attention_blocks=8)
TS_DECODER = dict(out_len=5000, num_output_channels=7, num_cross_attention_heads=1)
TS_IN, TS_OUT, TS_LATENTS, TS_CHANNELS, TS_BATCH = 4096, 5000, 256, 256, 8
# launches a forward: the masked LM's K8 27 (its cross-attention and 26
# self-attention layers), K2 1 (the decoder), K1 58 (3 a cross-attention
# layer, 2 a self-attention layer); the text classifier's the same (its
# one-query decoder's heads of 32 take K2); optical flow's K8 2 (the encoder's
# and the decoder's cross-attention), K2 24, K1 54, and in bf16 the two
# LayerNorms that read its f32 adapted input stay f32 builds; the time
# series' K8 10, K1 22. A train step adds each backward once a forward launch
MLM_FORWARD = {"flash_heads_fwd": 27, "flash_packed_fwd": 1, "layer_norm_fwd": 58}
FLOW_FORWARD = {"flash_heads_fwd": 2, "flash_packed_fwd": 24, "layer_norm_fwd": 54}
FLOW_FORWARD_BF16 = {"flash_heads_fwd" + BF16: 2, "flash_packed_fwd" + BF16: 24, "layer_norm_fwd" + BF16: 52,
                     "layer_norm_fwd": 2, "flash_heads_fwd": 0, "flash_packed_fwd": 0}
TS_FORWARD = {"flash_heads_fwd": 10, "layer_norm_fwd": 22}
# the symbolic audio model at the GiantMIDI-Piano geometry of
# examples/training/sam/train.sh:8-12 (6144 tokens, 2048 latents, 768
# channels, 12 self-attention layers; the rest SymbolicAudioModelConfig's
# defaults: vocab 389, 8 heads of 96, absolute positions; 97,072,517
# parameters); its generation prompt (6000 tokens of midi.encode_notes over
# seeded notes, 512 new tokens at top_k 15, so both windows slide and the
# pipeline raises num_latents to 1904), the prompt lengths whose prefill and
# decode are timed, and its train step at train.sh's batch 16 (the gather
# mode keeps 2048 of the 4096 prefix rows), at the task models' rate
SAM = dict(max_seq_len=6144, max_latents=2048, num_channels=768, num_self_attention_layers=12)
SAM_PARAMS = 97_072_517
SAM_PROMPT, SAM_NEW, SAM_TOP_K, SAM_PROMPT_LATENTS = 6000, 512, 15, 1904
SAM_PROMPT_LENGTHS = (2048, 4096, 6000)
SAM_BATCH, SAM_KEEP = 16, 2048
SAM_HEADS, SAM_D = 8, 96
# a SAM forward: K2 13 times (the cross-attention and 12 self-attention
# layers), K1 27 (3 in the cross-attention layer, 2 a self-attention layer)
SAM_FORWARD = {"flash_packed_fwd": 13, "layer_norm_fwd": 27}
# the SAM's gradient check and loss trajectory against the CPU: full width
# and window, one self-attention layer
SAM_CHECK_LAYERS = 1
# the CLI fits: steps of each, the SAM fit's synthetic corpus (pieces enough
# for one batch of 16 windows of 6145 tokens in each split) and the time
# series' CSV (rows of 7 channels: 11 windows of 4096 + 5000 at stride 1000)
CLI_STEPS = {"sam": 4, "mnist": 20, "timeseries": 4}
SAM_CORPUS_PIECES, TS_CSV_ROWS = 160, 20000
# the non-SAM pipelines at reduced depth (their full-depth forwards run in
# the phases above): layers of the CLM, the masked LM and the text
# classifier, the image classifier's blocks and optical flow's layers
PIPELINE_DEPTH = 2
PIPELINE_PROMPT, PIPELINE_NEW, PIPELINE_BEAM_NEW = 4000, 64, 32
# MNIST's image classifier (scripts/vision/image_classifier.py's presets):
# 28 x 28 x 1 images with 32 bands (131 input channels, one CA head), 32
# latents x 128, 8 SA heads of 16, batch 64
MNIST_BATCH, MNIST_PIXELS, MNIST_D, MNIST_LATENTS, MNIST_CHANNELS = 64, 784, 131, 32, 128
# the text CLIs (ROADMAP A13, part 3). scripts/text/clm.py's paper preset, its
# defaults: 4096 tokens, 512 latents x 512 channels, 8 heads of 64, 8
# self-attention layers, batch 8, prefix dropout 0.5 (1792 of the 3584 prefix
# rows kept); its validation end generates from TEXT_SAMPLE_PROMPT
TEXT_CLM = dict(max_seq_len=4096, max_latents=512, num_channels=512, num_heads=8, num_self_attention_layers=8,
                cross_attention_dropout=0.5)
TEXT_CLM_BATCH = 8
TEXT_CLM_KEEP = (4096 - 512) - int((4096 - 512) * 0.5)
# the text CLM's attentions in a train step by kv rows: the cross-attention
# over the kept prefix rows and the latents, the self-attention over the
# latents. K2, K4a and K4b each launch once a step for the CA and once a
# layer for the SA: text_clm_cli_fit_bf16 counts them over its train steps
# (build.LAUNCHES_BY_KV), checks them against TEXT_CLM_PER_STEP and writes
# them into the rows of the kernel cases at those shapes (TEXT_CLM_ROWS:
# case, kernel, row)
TEXT_CLM_KV = {"text_clm_ca_bf16": TEXT_CLM_KEEP + TEXT_CLM["max_latents"],
               "text_clm_sa_bf16": TEXT_CLM["max_latents"]}
TEXT_CLM_PER_STEP = {"text_clm_ca_bf16": 1, "text_clm_sa_bf16": TEXT_CLM["num_self_attention_layers"]}
TEXT_CLM_ROWS: list = []
TEXT_SAMPLE_PROMPT, TEXT_SAMPLE_TOKENS = "The Perceiver AR model attends", 128
CLI_STEPS.update(text_clm=6, text_mlm=4, text_clf=4)
# serve_fleet_bf16: two replicas of serve_bf16's engine behind a FleetRouter,
# 12 greedy requests (prompts of 2048-8192 tokens, budgets of 32-64) at 8
# live fleet-wide, r0 killed at its 24th drive step (mid-decode of its first
# four requests); a dropped fleet must give back its pools and graphs (all
# but FLEET_LEAK_BYTES of what it took)
FLEET_REQUESTS, FLEET_PROMPTS, FLEET_BUDGETS, FLEET_KILL_STEP = 12, (2048, 8192), (32, 64), 24
FLEET_LEAK_BYTES = 64 << 20
# sim_bf16, a check of the simulator's books and audits, not a traffic mix
# with a source: two tenants on serve_bf16's engine geometry, offered 0.5
# and 0.25 of the fitted engine's capacity (one over a request's p50
# prefill and its share of the slots' p50 decode steps), with load_bf16's
# prompt lengths and budget (the range the fit was measured on), the second
# sharing a preamble shorter than its shortest prompt; the fleet run at
# twice the rates over two replicas
SIM_REQUESTS, SIM_RATE_SHARES, SIM_SHARED_PREFIX = (1200, 300), (0.5, 0.25), 1024
# training across processes (ROADMAP A12, part 1): the flagship in bf16 with
# dropout off at batch 2, 3 eager steps sharded and unsharded; each step one
# CA and 8 SA layers through K2/K4a/K4b and 19 LayerNorms through K1/K5; the
# ring step's CA blocks are plain matmuls (JAX's einsums), so 8 of each
DIST_BATCH, DIST_STEPS = 2, 3
# after them, DIST_TIMED_STEPS steps of each kind, interleaved, for the step
# times (one warm step each first); RING_STEPS train steps of the ring loss
DIST_TIMED_STEPS, RING_STEPS = 10, 3
DIST_PER_STEP = {"flash_packed_fwd": 9, "flash_packed_bwd_dkv": 9, "flash_packed_bwd_dq": 9, "layer_norm_fwd": 19,
                 "layer_norm_bwd": 19}
RING_PER_STEP = dict(DIST_PER_STEP, flash_packed_fwd=8, flash_packed_bwd_dkv=8, flash_packed_bwd_dq=8)
# one process: FSDP's gather and reduce are copies, so the sharded steps
# differ from the unsharded only by the clip's norm (its squares summed in
# f64 across the shard group)
DIST_LOSS_RTOL, DIST_PARAM_ATOL = 1e-5, 1e-5
# ring_clm_bf16: the ring's loss and gradient no further from the f32 dense
# evaluation than RING_RULE[0] times the dense bf16 route's, plus RING_RULE[1]
# of the f32 value's size (the ring rounds p to bf16 once, JAX's einsum law;
# K2 bf16 keeps it in two bf16 parts)
RING_RULE = (1.5, 1e-3)
CLI_STEPS.update(text_clm_fsdp=20, text_clm_ring=3)


def step_launches(forward: dict) -> dict:
    """A train step's launches from its forward's: each backward as often as
    its forward kernel launches."""
    back = {"flash_heads_fwd": ("flash_heads_bwd_dkv", "flash_heads_bwd_dq"),
            "flash_packed_fwd": ("flash_packed_bwd_dkv", "flash_packed_bwd_dq"),
            "layer_norm_fwd": ("layer_norm_bwd",)}
    return dict(forward, **{b: n for k, n in forward.items() for b in back[k]})


def as_bf16(launches: dict) -> dict:
    """The same launches, every one a bf16 build, and no f32 build."""
    return {**{k + BF16: n for k, n in launches.items()}, **dict.fromkeys(launches, 0)}


# the task models' train steps: AdamW at this rate, clip 1.0, 5 steps on one
# fixed batch; their gradient checks and trajectories at reduced depth (2
# self-attention layers for the text models; the time series at full size)
# and batch 2, against the CPU's plain versions. The rate is the text
# classifier's and the time series' script default (scripts/text/
# classifier.py:46, scripts/timeseries.py:95); the MLM script's 1e-3
# (scripts/text/mlm.py:76) comes after a 1000-step warmup. At 1e-3 from step
# one, Adam's first step (lr * sign(g) an element) raised all three losses on
# the card and on the CPU alike
TASK_LR, TASK_STEPS, TASK_TRAJECTORY_STEPS, TASK_CHECK_LAYERS = 1e-4, 5, 3, 2
# the time series' f32 gradient against the CPU's (model_grad_check_phase),
# max abs difference relative to the parameter's largest gradient: its
# weight gradients sum 8 x 4096 input rows and 8 x 5000 output rows, in
# another order on each side (K9's f64 products and cuBLAS on the card, the
# plain versions on the CPU); measured 1.267e-5 on an H100 (the input
# adapter's position projection; 1.06e-5 the decoder's q projection), the
# same in every run; about twice it
TS_GRAD_TOL = 3e-5
# |logits(card) - logits(CPU)| / max |logits(CPU)| of the f32 fill; the
# f32 card's kernels and cuBLAS sum in other orders than the CPU's plain
# versions through 26 layers
MLM_FILL_REL_TOL = 1e-4
# flow (f32): |flow(kernels) - flow(plain versions)| / max |flow(plain)| on
# the card, the same weights and pair
FLOW_REL_TOL = 1e-4
# flow_bf16, check_bf16's element rule: |flow(kernels) - flow(plain)| within
# this share of the plain bf16 flow's largest magnitude. The flow is the head's
# output over 100 (at most 6.5e-4 on these weights), after ~100 bf16
# roundings on the way; the two bf16 evaluations round at other points and
# measured 1.199e-5 apart, 1.84% of the largest 6.52e-4 (an H100, the same
# in two runs), so the kernels' default 2e-2 sits at the measurement; near
# the 1.5x margin of the L2 rule
FLOW_BF16_REL = 3e-2
# the mask filler's samples (the reference's example and three more)
MLM_SAMPLES = ("I have watched this [MASK] and it was awesome.",
               "The capital of France is [MASK][MASK][MASK][MASK][MASK].",
               "[MASK] is a [MASK] language model.", "Perceiver IO works on [MASK] [MASK] and audio.")
# peak rates of one H100 SXM (NVIDIA data sheet, dense). An f32-accurate
# product on the tensor cores takes three TF32 products (the operands split
# into a TF32 "big" and "small" part), so every f32 attention kernel is
# bounded at a third of the TF32 rate; the byte-bound kernels (LayerNorm,
# the paged decode) keep the CUDA cores' f32 rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32_cuda_cores": 67e12, "split_tf32": 495e12 / 3, "bf16_tensor": 989e12}
# the timer: before every timed call a 256 MB write (five times the 50 MB L2)
# evicts the call's operands, as the main path finds them, then a GPU sleep
# of at least 1 ms (2e6 cycles at the H100's 1.98 GHz top clock) keeps the
# card busy while the host dispatches the call, so the events time the
# device work alone
FLUSH_BYTES = 256 << 20
CUSHION_CYCLES = 2_000_000
_FLUSH = []
# label -> median host-clock ms of one call's dispatch, the card kept busy
DISPATCH_MS = {}
# the kernels one counted launch (``build.LAUNCHES``) runs, by the names
# their nodes carry in a captured CUDA graph: K3 a walk and a merge, K5 two
# passes (a split walk of K2, K6 or K8 adds a merge, K9b's a reduce)
GRAPH_KERNELS = {
    "flash_packed_fwd": ("flash_packed_kernel",), "paged_decode": ("paged_walk_kernel", "paged_merge_kernel"),
    "layer_norm_fwd": ("_layer_norm_fwd_kernel",), "flash_packed_bwd_dkv": ("flash_bwd_dkv_kernel",),
    "flash_packed_bwd_dq": ("flash_bwd_dq_kernel",),
    "layer_norm_bwd": ("_layer_norm_bwd_dx_kernel", "_layer_norm_bwd_dwdb_kernel"),
    "flash_2seg_fwd": ("flash_2seg_fwd_kernel",), "flash_2seg_bwd_dkv": ("flash_2seg_bwd_dkv_kernel",),
    "flash_2seg_bwd_dq": ("flash_2seg_bwd_dq_kernel",), "flash_heads_fwd": ("heads_fwd_kernel",),
    "flash_heads_bwd_dkv": ("heads_bwd_dkv_kernel",), "flash_heads_bwd_dq": ("heads_bwd_dq_kernel",),
    # the bf16 builds: K4's and K7's kernels carry names of their own; K2's,
    # K3's, K6's and the Triton kernels' share their f32 builds' names, so a
    # node of one of those counts for the launches of both builds together
    "flash_packed_fwd" + BF16: ("flash_packed_kernel",),
    "paged_decode" + BF16: ("paged_walk_kernel", "paged_merge_kernel"),
    "layer_norm_fwd" + BF16: ("_layer_norm_fwd_kernel",),
    "flash_packed_bwd_dkv" + BF16: ("flash_bwd_dkv_bf16_kernel",),
    "flash_packed_bwd_dq" + BF16: ("flash_bwd_dq_bf16_kernel",),
    "layer_norm_bwd" + BF16: ("_layer_norm_bwd_dx_kernel", "_layer_norm_bwd_dwdb_kernel"),
    "flash_2seg_fwd" + BF16: ("flash_2seg_fwd_kernel",),
    "flash_2seg_bwd_dkv" + BF16: ("flash_2seg_bwd_dkv_bf16_kernel",),
    "flash_2seg_bwd_dq" + BF16: ("flash_2seg_bwd_dq_bf16_kernel",),
    "flash_heads_fwd" + BF16: ("heads_fwd_bf16_kernel",),
    "flash_heads_bwd_dkv" + BF16: ("heads_bwd_dkv_bf16_kernel",),
    "flash_heads_bwd_dq" + BF16: ("heads_bwd_dq_bf16_kernel",),
}
# graph name -> its kernel nodes by name and the launches its capture counted
GRAPH_NODES = {}
# metric -> {"graph": x, "eager": y}, both measured in this run
TIMES = {}
# (compute dtype, channels, cache dtype, weight dtype, budget, prompt shape,
# prompt bytes) -> the sequential stream and its logits (check_streams)
SEQUENTIAL = {}
# |graph - eager| / |eager| allowed for a train step's losses and parameters
# (the same kernels on the same inputs; cuBLAS may choose other algorithms
# under capture), printed beside each comparison
GRAPH_RTOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, dispatch: str = None) -> float:
    """The card's time for one call of ``fn``: the median over ``iters`` calls
    of CUDA-event time, each call queued behind an L2 flush and a GPU sleep
    that outlasts its dispatch, so the events see the device work from cold
    L2 and not the host's dispatch. With ``dispatch`` (a label), also logs
    and keeps in ``DISPATCH_MS`` the median host-clock time of the call
    itself, taken while the card sleeps: the host's cost of a launch."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda"))
    flush = _FLUSH[0]
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(CUSHION_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    if dispatch is not None:
        DISPATCH_MS[dispatch] = statistics.median(host)
        log(f"dispatch {dispatch}: host_ms={DISPATCH_MS[dispatch]:.4f} (median of {iters}, card busy)")
    return statistics.median(s.elapsed_time(e) for s, e in events)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def max_err64(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max_err`` with the difference taken in f64 (for an f64 reference)."""
    return float((a.double() - b.double()).abs().max())


def l2_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The L2 norm of ``a - b``, in f64."""
    return float((a.double() - b.double()).norm())


def check_bf16(name: str, kernel, plain, f64, margin: float, slack: float = 0.0, rel: float = 2e-2) -> dict:
    """A bf16 build's rule: its output (a tensor or a tuple of them) no
    further from the plain version evaluated in f64 on the same bf16 inputs
    than ``margin`` x the bf16 plain version's distance (L2 over the whole
    output; plus ``slack`` x the f64 output's L2 size), and within ``rel`` of
    the plain version's largest magnitude, element by element. Returns the
    measured distances."""
    flat = lambda ts: torch.cat([t.double().reshape(-1) for t in (ts if isinstance(ts, tuple) else (ts,))])  # noqa: E731
    k, p, e = flat(kernel), flat(plain), flat(f64)
    out = {"l2_kernel_f64": l2_err(k, e), "l2_plain_f64": l2_err(p, e), "margin": margin, "slack": slack,
           "max_abs_err": float((k - p).abs().max()), "rel_tol": rel * float(p.abs().max())}
    bound = margin * out["l2_plain_f64"] + slack * float(e.norm())
    ok = within(out["l2_kernel_f64"], bound) and within(out["max_abs_err"], out["rel_tol"])
    log(f"bf16 {name}: {json.dumps(out)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"bf16 kernel parity failed: {name}: {out}")
    return out


def within(err: float, tol: float) -> bool:
    """``err <= tol`` for a finite error (a NaN error never passes)."""
    return math.isfinite(err) and err <= tol


def check(name: str, err: float, tol: float) -> None:
    status = "ok" if within(err, tol) else "FAIL"
    log(f"parity {name}: max_abs_err={err:.3e} tol={tol:.1e} {status}")
    if not within(err, tol):
        raise SystemExit(f"kernel parity failed: {name} max_abs_err {err} > {tol}")


def check_graph(name: str, graph, warm_up: dict, want: dict) -> None:
    """A captured step's graph holds the hand-written kernels it should: its
    capture counted the launches of the eager warm-up step (``warm_up``),
    which include ``want`` exactly (launches a step; 0 = none), and its
    kernel nodes run each kernel as often as those launches say (K3's walk
    and merge each once a launch) and no other hand-written kernel."""
    names = list(dict.fromkeys(k for ks in GRAPH_KERNELS.values() for k in ks))
    nodes = graph.kernel_nodes(names)
    GRAPH_NODES[name] = {"nodes": nodes, "launches": graph.launches}
    log(f"graph {name}: {json.dumps(GRAPH_NODES[name])}")
    if graph.launches != warm_up:
        raise SystemExit(f"graph {name}: its capture counted {graph.launches}, the eager step {warm_up}")
    off = {k: graph.launches.get(k, 0) for k, v in want.items() if graph.launches.get(k, 0) != v}
    if off:
        raise SystemExit(f"graph {name}: launches a step {off}, expected {want}")
    want_nodes = dict.fromkeys(names, 0)
    for launch, ks in GRAPH_KERNELS.items():
        for node in ks:
            want_nodes[node] += graph.launches.get(launch, 0)
    wrong = {node: nodes[node] for node, n in want_nodes.items() if nodes[node] != n}
    if wrong:
        raise SystemExit(f"graph {name}: kernel nodes {wrong}, expected one per launch of {graph.launches}")


def rel_diff(got, want) -> float:
    """max |got - want| / max |want| over tensors or numbers (0 where both
    are 0)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


def wall_ms(fn, iters: int = 5) -> float:
    """Median host-clock ms of ``fn()`` run to the card's end (host and
    device together, as a caller sees a step)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def free_card() -> None:
    """Drop the last phase's models, graphs and their memory pools."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def bound(n_bytes: float, n_ops: float, rate: str) -> tuple:
    """(least ms, "bytes" or "operations") for ``n_bytes`` moved and
    ``n_ops`` done at the peak ``PEAK_OPS[rate]``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[rate]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def by_batch(fn, b: int, rows: int = 4):
    """``fn(lo, hi)`` over batch rows ``[lo, hi)`` in runs of ``rows``, its
    outputs (a tensor or a tuple) joined along dim 0: an f64 plain version
    at a batch-16 training shape one quarter at a time."""
    parts = [fn(lo, min(lo + rows, b)) for lo in range(0, b, rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(ts) for ts in zip(*parts))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------


def _sdpa_keep(nq: int, nkv: int, pad) -> torch.Tensor:
    """The right-aligned causal + pad keep mask of one SDPA call."""
    i = torch.arange(nq, device="cuda")[:, None]
    j = torch.arange(nkv, device="cuda")[None, :]
    keep = (j <= i + (nkv - nq))[None, None]
    return keep if pad is None else keep & ~pad[:, None, None, :]


def flash_fwd_case(name: str, q, k, v, pad, h: int, tol: float, path: str, causal: bool = True,
                   scattered: bool = False) -> dict:
    """K2 against its plain version on one case (out and logsumexp), with its
    time beside the plain version's, one SDPA call's with the same mask, and
    the bound. ``path`` names the path whose shapes these are; ``scattered``:
    ``pad`` masks prefix keys (the "mask" prefix-dropout mode), which the
    bound counts no work for."""
    from torch.nn.functional import scaled_dot_product_attention

    from perceiver_io_tpu_torch.ops.flash_attention import (
        _fwd_cuda,
        bias_row,
        flash_attention_packed,
        flash_attention_packed_reference,
        packed_kv_splits,
    )

    (b, nq, c), nkv, d = q.shape, k.shape[1], q.shape[2] // h
    cv, dv = v.shape[2], v.shape[2] // h  # the value heads' width (the masked LM decoder's 96 to q/k's 32)
    # the kernel's kv split, in either build
    splits = packed_kv_splits(b, h, nq, nkv, max(d, dv), torch.cuda.get_device_properties(0).multi_processor_count,
                              q.dtype)
    o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=causal)
    err = max_err(o, ro)
    if tol is not None:  # None: a bf16 case held by check_bf16 alone
        check(f"flash_packed_fwd {name} out", err, tol)
    check(f"flash_packed_fwd {name} lse", max_err(lse, rlse), 1e-4)
    # where the rule splits the walk, the unsplit walk too: its output held
    # as the split one's, its time beside it
    bias = bias_row(pad, b, nkv, q.device)
    unsplit = lambda: _fwd_cuda(q, k, v, h, bias, causal, 1.0, nsplit=1)  # noqa: E731
    bf16 = None
    if q.dtype == torch.bfloat16:
        eo = by_batch(lambda lo, hi: flash_attention_packed_reference(
            q[lo:hi].double(), k[lo:hi].double(), v[lo:hi].double(), h,
            pad_mask=None if pad is None else pad[lo:hi], causal=causal)[0], b)
        bf16 = check_bf16(f"flash_packed_fwd {name}", o, ro, eo, 1.25)
        if splits > 1:
            check_bf16(f"flash_packed_fwd {name} unsplit", unsplit()[0], ro, eo, 1.25)
        del eo
    elif splits > 1 and tol is not None:
        check(f"flash_packed_fwd {name} unsplit out", max_err(unsplit()[0], ro), tol)
    ms = time_ms(lambda: flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal),
                 dispatch=f"flash_packed_fwd {name}")
    unsplit_ms = time_ms(unsplit) if splits > 1 else None
    plain_ms = time_ms(lambda: flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=causal), 3)
    # the library yardstick: one SDPA call on heads-major views with the
    # same right-aligned causal + pad mask
    qh, kh, vh = (t.reshape(b, -1, h, t.shape[2] // h).transpose(1, 2) for t in (q, k, v))
    keep = _sdpa_keep(nq, nkv, pad) if causal else None
    library_ms = time_ms(lambda: scaled_dot_product_attention(qh, kh, vh, attn_mask=keep))
    el = q.element_size()
    visible = b * visible_pairs(nq, nkv, causal) - (nq * int(pad.sum()) if scattered else 0)
    n_bytes = (el * b * (nq * c + nkv * c + nkv * cv + nq * cv) + 4 * b * nq * h
               + (4 * b * nkv if pad is not None else 0))
    bound_ms, bound_by = bound(n_bytes, 2 * (d + dv) * h * visible,
                               "bf16_tensor" if q.dtype == torch.bfloat16 else "split_tf32")
    pads = 0 if pad is None else int(pad[0].sum())
    dims = f"D={d}" if d == dv else f"Dqk={d} Dv={dv}"
    row = dict(case=f"{name} batch={b} nq={nq} nkv={nkv} H={h} {dims} "
                    f"{'masked' if scattered else 'left_pads'}={pads} "
                    f"{'causal' if causal else 'full'} {str(q.dtype)[6:]}", path=path,
               max_abs_err=err, tol="check_bf16 (1.25x)" if tol is None else tol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               dispatch_ms=DISPATCH_MS[f"flash_packed_fwd {name}"], kv_splits=splits, unsplit_ms=unsplit_ms,
               dtype=str(q.dtype)[6:], bf16_rule=bf16)
    log(f"time flash_packed_fwd {name}: {json.dumps(row)}")
    return row


def flash_phase(gen: torch.Generator) -> dict:
    """K2 at the serving prefill's shapes (batch 1, 512 latents)."""
    h, c = FLAGSHIP["num_heads"], FLAGSHIP["num_channels"]
    d = c // h
    cases = {  # name: (nq, nkv, dtype, left pads, tolerance)
        "ca_f32": (512, 16384, torch.float32, 0, 1e-5),
        "sa_f32": (512, 512, torch.float32, 0, 1e-5),
        "ca_bf16": (512, 16384, torch.bfloat16, 0, 5e-4),
        "ca_f32_leftpad": (512, 16384, torch.float32, 3001, 1e-5),
    }
    out = {"cases": []}
    for name, (nq, nkv, dtype, pads, tol) in cases.items():
        q = (torch.randn(1, nq, c, generator=gen) * d**-0.5).cuda().to(dtype)
        k = torch.randn(1, nkv, c, generator=gen).cuda().to(dtype)
        v = torch.randn(1, nkv, c, generator=gen).cuda().to(dtype)
        pad = None
        if pads:
            pad = torch.zeros(1, nkv, dtype=torch.bool, device="cuda")
            pad[:, :pads] = True
        out["cases"].append(flash_fwd_case(name, q, k, v, pad, h, tol,
                                           "serve" + (BF16 if dtype == torch.bfloat16 else "")))
    # the shared-prefix prefill's cross-attention (serve_share_evict_bf16):
    # 512 latents over the filled slots of a contiguous bf16 cache, the keys
    # and values the leading rows of its (capacity, C) buffers
    nkv = SHARE_DOC + SHARE_SUFFIXES[0]
    q = (torch.randn(1, NUM_LATENTS, c, generator=gen) * d**-0.5).cuda().to(torch.bfloat16)
    k, v = (torch.randn(1, nkv + SHARE_BUDGETS[1], c, generator=gen).cuda().to(torch.bfloat16) for _ in range(2))
    out["cases"].append(flash_fwd_case("ca_shared_bf16", q, k[:, :nkv], v[:, :nkv], None, h, 5e-4,
                                       "serve_share_evict" + BF16))
    # optical flow's latent self-attention (2048 latents, 16 heads of 32,
    # batch 1), the flow forward's K2 in f32 and bf16
    for dtype, path, tol in ((torch.float32, "flow", 1e-5), (torch.bfloat16, "flow" + BF16, None)):
        q = (torch.randn(1, FLOW_LATENTS, FLOW_CHANNELS, generator=gen) * 32**-0.5).cuda().to(dtype)
        k, v = (torch.randn(1, FLOW_LATENTS, FLOW_CHANNELS, generator=gen).cuda().to(dtype) for _ in range(2))
        out["cases"].append(flash_fwd_case(f"flow_sa_{str(dtype)[6:]}", q, k, v, None, 16, tol, path, False))
    # the symbolic audio model's prefill (sam_generate): 1904 latents over a
    # 6000-token prompt and over themselves, causal, 8 heads of 96 (the 128
    # tile), batch 1, in f32 and bf16
    for dtype, sfx, tol in ((torch.float32, "", 1e-5), (torch.bfloat16, BF16, None)):
        for kind, nkv in (("ca", SAM_PROMPT), ("sa", SAM_PROMPT_LATENTS)):
            q = (torch.randn(1, SAM_PROMPT_LATENTS, SAM["num_channels"], generator=gen) * SAM_D**-0.5).cuda().to(dtype)
            k, v = (torch.randn(1, nkv, SAM["num_channels"], generator=gen).cuda().to(dtype) for _ in range(2))
            out["cases"].append(flash_fwd_case(f"sam_prefill_{kind}_{str(dtype)[6:]}", q, k, v, None, SAM_HEADS, tol,
                                               "sam_generate" + sfx))
    # 512 latents x 8 heads give 64 q blocks: the prefill fills the card by
    # splitting the kv walk
    if out["cases"][0]["kv_splits"] < 2:
        raise SystemExit(f"flash_packed_fwd: the serving prefill took no kv split: {out['cases'][0]}")
    return out


def paged_phase(gen: torch.Generator, dtype: torch.dtype = torch.float32) -> dict:
    """K3 at the serve's pool geometries: the CA pool (4 slots of 16384
    tokens in pages of 16), the same with slot 0 retired (length 0, its
    table row all at the scratch page 0: K3 averages its capacity) and a
    latent SA pool (4 slots of 1024), each with the engine's pad/window mask
    and without; then one CA call under ``torch.profiler``, which must show
    K3's two kernels and nothing else. With ``dtype`` bf16, K3's bf16 build
    over bf16 pools (serve_bf16's), held to its bf16 plain version within
    1e-2 of its largest magnitude and to no more distance from the f64
    evaluation than the plain version's (L2, plus 1e-6 of the output's size
    for the f32 sums' rounding); no profiled call. In both dtypes, the CA
    pool's lengths and mask at heads wider than 128 (2 x 192, 2 x 256 and
    1 x 512 channels: 8 or 16 channels a lane), at the same tolerances; and
    in f32 one engine serve of a small model with heads of 256
    (:func:`wide_serve_check`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
    from perceiver_io_tpu_torch.ops.paged_attention import (
        kernel_plan,
        paged_attention_reference,
        paged_decode_attention,
    )

    from perceiver_io_tpu_torch.core.cache import PagedKVCache

    slots, page, tol = 4, 16, 1e-5
    bf16 = dtype == torch.bfloat16
    suffix, el = (BF16, 2) if bf16 else ("", 4)
    rows, calls = [], []
    # pool: (tokens a slot, lengths, {slot: leading masked tokens}); the CA's
    # left pads in slot 2 and expired window slots in slot 3, the SA's
    # expired latents (generation.py's sa_idx < sa_start) in every slot;
    # every slot keeps a real key
    # (heads, head dim): the flagship's, then the wide heads
    flagship = (FLAGSHIP["num_heads"], FLAGSHIP["num_channels"] // FLAGSHIP["num_heads"])
    ca = (FLAGSHIP["max_seq_len"], [1, 2085, 9000, 16320], {2: 300, 3: 40})
    pools = {
        "ca": ca + flagship,
        "ca_retired": (FLAGSHIP["max_seq_len"], [0, 2085, 9000, 16320], {2: 300, 3: 40}) + flagship,
        "sa": (FLAGSHIP["max_latents"], [513, 600, 777, 1024], {0: 1, 1: 88, 2: 265, 3: 512}) + flagship,
        **{f"wide_{h}x{d}": ca + (h, d) for h, d in WIDE_HEADS},
    }
    for pool, (tokens, lengths, masked, h, d) in pools.items():
        c = h * d
        wide = pool.startswith("wide")
        pps = tokens // page
        num_pages = slots * pps + 1
        cache = init_paged_kv_cache(slots, num_pages, page, pps, c, c, dtype=dtype, device="cuda")
        cache.k.copy_(torch.randn(num_pages, page, c, generator=gen))
        cache.v.copy_(torch.randn(num_pages, page, c, generator=gen))
        # each slot owns a random permutation of disjoint pages
        perm = (torch.randperm(num_pages - 1, generator=gen) + 1).reshape(slots, pps)
        retired = [s for s, n in enumerate(lengths) if n == 0]
        perm[retired] = 0  # a retired slot's row points at the scratch page
        cache.page_table = perm.to(torch.int32).cuda()
        cache.length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        qh = (torch.randn(slots, h, d, generator=gen) * d**-0.5).cuda().to(dtype)
        mask = torch.zeros(slots, cache.capacity, dtype=torch.bool, device="cuda")
        for slot, n in masked.items():
            mask[slot, :n] = True
        plan = kernel_plan(torch.cuda.current_device(), slots, h, d, d, page, dtype)
        log(f"plan paged_decode{suffix} {pool}: {json.dumps(plan._asdict())}")
        tokens_read = sum(lengths)
        pages_read = sum(-(-n // page) for n in lengths)
        names = {"ca": ("pad_window_mask", "validity_only"),
                 "ca_retired": ("ca_retired_pad_window_mask", "ca_retired_validity_only"),
                 "sa": ("sa_window_mask", "sa_validity_only")}.get(pool, (f"{pool}_pad_window_mask",))
        for name, m in zip(names, (mask, None)):
            name += suffix
            o = paged_decode_attention(qh, cache, m)
            torch.cuda.synchronize()
            plain = paged_attention_reference(qh, cache, m)
            err, rule = max_err(o, plain), None
            if bf16:
                c64 = PagedKVCache(cache.k.double(), cache.v.double(), cache.page_table, cache.length)
                rule = check_bf16(f"paged_decode {name}", o, plain, paged_attention_reference(qh.double(), c64, m),
                                  1.0, slack=1e-6, rel=1e-2)
                del c64
            else:
                check(f"paged_decode {name}", err, tol)
            del plain
            ms = time_ms(lambda: paged_decode_attention(qh, cache, m), dispatch=f"paged_decode {name}")
            plain_ms = time_ms(lambda: paged_attention_reference(qh, cache, m), 3)
            # K/V rows of the valid tokens, q and out (el bytes an element),
            # int32 table entries walked and lengths; under a mask, its bool
            # entries of those tokens; a retired slot's V rows of its one
            # (scratch) page and its table row
            n_bytes = el * (2 * tokens_read * c + 2 * slots * c) + 4 * (pages_read + slots) + (
                tokens_read if m is not None else 0) + len(retired) * (el * page * c + 4 * pps)
            bound_ms, bound_by = bound(n_bytes, 4 * d * h * tokens_read, "f32_cuda_cores")
            row = dict(case=f"{name} slots={slots} page={page} lengths={lengths} heads={h}x{d} {str(dtype)[6:]}",
                       path=("wide_heads" if wide else "serve") + suffix, max_abs_err=err,
                       tol=tol if not bf16 else "check_bf16 (1.0x)",
                       bf16_rule=rule, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                       bound_by=bound_by, dispatch_ms=DISPATCH_MS[f"paged_decode {name}"], grid=plan.grid,
                       stages=plan.stages, dtype=str(dtype)[6:])
            log(f"time paged_decode {name}: {json.dumps(row)}")
            rows.append(row)
        if not calls:
            calls.append((qh, cache, mask))
        del cache
    if bf16:
        return {"cases": rows}
    wide_serve_check()
    # one profiled call at the CA: K3's walk and merge, and no other device op
    qh, cache, mask = calls[0]
    paged_decode_attention(qh, cache, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        paged_decode_attention(qh, cache, mask)
        torch.cuda.synchronize()
    device = [(e.key, e.count) for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    log(f"profile paged_decode pad_window_mask: device ops {json.dumps(device)}")
    if not device or sum(n for _, n in device) > 2 or any("paged_" not in key for key, _ in device):
        raise SystemExit(f"paged_decode: one call launched {device}, not K3's walk and merge alone")
    return {"cases": rows}


def wide_serve_check() -> None:
    """One engine serve of a small f32 model with heads of 256 (512
    channels in 2 heads; ``WIDE_SERVE``): K3 serves its pools (launched
    once a pool a decode step), and every stream equals the sequential
    ``make_decode_fns`` stream up to its first near tie."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    config, geometry, latents = WIDE_SERVE
    model = CausalLanguageModel(CausalLanguageModelConfig(**config), device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 20)
    specs = []
    for i in range(4):
        n = int(rng.integers(300, 1900))
        specs.append(RequestSpec(index=i, prompt_len=n, max_new_tokens=int(rng.integers(16, 33)),
                                 input_ids=rng.integers(0, config["vocab_size"], size=(1, n)), rng_seed=i))
    engine = EngineFrontEnd(model, num_latents=latents, engine_config=EngineConfig(**geometry), device="cuda")
    run = serve_run(engine, specs)
    launches, steps, n_sa = run["launches"], run["steps"], config["num_self_attention_layers"]
    log(f"wide_serve heads=2x256 launches: {json.dumps(launches)} decode steps={steps}")
    if launches["paged_decode"] != (1 + n_sa) * steps or not engine.books()["balanced"] or \
            engine.books()["ok"] != len(specs):
        raise SystemExit(f"wide_serve: K3 launched {launches['paged_decode']} times in {steps} steps "
                         f"(not {1 + n_sa} a step) or books {engine.books()}")
    check_streams("wide_serve", model, specs, dict(engine.served_tokens), NEAR_TIE, num_latents=latents)
    del engine, model
    free_card()


def _ln_inputs(gen: torch.Generator, rows: int, c: int):
    x = (torch.randn(rows, c, generator=gen) * 2 + 0.5).cuda()
    w = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
    b = (0.1 * torch.randn(c, generator=gen)).cuda()
    return x, w, b


def layernorm_phase(gen: torch.Generator) -> dict:
    from torch.nn.functional import layer_norm as torch_layer_norm

    from perceiver_io_tpu_torch.ops.layernorm import (
        layer_norm,
        layer_norm_cuda,
        layer_norm_reference,
        layer_norm_reference_stats,
    )

    tol = 1e-5
    rows_out = []
    # the serving launch (no statistics) at a full prompt, the training
    # launch (with the per-row mean/rstd the backward reads) at the kv_norm
    # rows of one chunk (2 x 7680 kept prefix rows), and the image
    # classifier's latent rows (16 x 512 x 1024) with and without statistics
    c_clm = FLAGSHIP["num_channels"]
    f32, bf16 = torch.float32, torch.bfloat16
    for name, rows, c, stats, path, dt in (("serving", FLAGSHIP["max_seq_len"], c_clm, False, "serve", f32),
                                           ("with_stats", TRAIN_CHUNK * KEEP, c_clm, True, "train", f32),
                                           ("image_with_stats", IMAGE_BATCH * IMAGE_LATENTS, IMAGE_CHANNELS, True,
                                            "image_train", f32),
                                           ("image_eval", IMAGE_BATCH * IMAGE_LATENTS, IMAGE_CHANNELS, False,
                                            "image_eval", f32),
                                           # the bf16 CLM's: bf16 activations, f32 statistics and parameters
                                           ("serving_bf16", FLAGSHIP["max_seq_len"], c_clm, False, "serve" + BF16,
                                            bf16),
                                           ("with_stats_bf16", TRAIN_CHUNK * KEEP, c_clm, True, "train" + BF16,
                                            bf16),
                                           # the bf16 image step's latent rows
                                           ("image_with_stats_bf16", IMAGE_BATCH * IMAGE_LATENTS, IMAGE_CHANNELS,
                                            True, "image_train" + BF16, bf16),
                                           # the Perceiver IO task models: the masked LM's input rows (C 768)
                                           # and latent rows (C 1280) in its fill and bf16 train step, optical
                                           # flow's adapted input (C 322, f32 whatever the compute dtype)
                                           ("mlm_input", MLM_BATCH * MLM_QUERIES, MLM_INPUT, False, "mlm_fill",
                                            f32),
                                           ("mlm_latent", MLM_BATCH * MLM_LATENTS, MLM_CHANNELS, False,
                                            "mlm_fill", f32),
                                           ("mlm_input_with_stats_bf16", MLM_BATCH * MLM_QUERIES, MLM_INPUT, True,
                                            "mlm_train" + BF16, bf16),
                                           ("mlm_latent_with_stats_bf16", MLM_BATCH * MLM_LATENTS, MLM_CHANNELS,
                                            True, "mlm_train" + BF16, bf16),
                                           ("flow_input", FLOW_PIXELS, FLOW_WIDTH, False, "flow", f32),
                                           # the time series' f32 train step (C 256): its input, output query
                                           # and latent rows
                                           *((f"ts_{kind}_with_stats", TS_BATCH * n, TS_CHANNELS, True,
                                              "timeseries_train", f32)
                                             for kind, n in (("input", TS_IN), ("query", TS_OUT),
                                                             ("latent", TS_LATENTS))),
                                           # the symbolic audio model (C 768): the prefill's prompt rows in
                                           # f32 and bf16, the bf16 train step's latent rows (16 x 2048) with
                                           # statistics, and f32 beside them; MNIST's input rows (C 131)
                                           ("sam_prefill", SAM_PROMPT, SAM["num_channels"], False, "sam_generate",
                                            f32),
                                           ("sam_prefill_bf16", SAM_PROMPT, SAM["num_channels"], False,
                                            "sam_generate" + BF16, bf16),
                                           ("sam_latent_with_stats_bf16", SAM_BATCH * SAM["max_latents"],
                                            SAM["num_channels"], True, "sam_train" + BF16, bf16),
                                           ("sam_latent_with_stats", SAM_BATCH * SAM["max_latents"],
                                            SAM["num_channels"], True, "edge", f32),
                                           ("mnist_input_with_stats", MNIST_BATCH * MNIST_PIXELS, MNIST_D, True,
                                            "mnist_fit", f32)):
        x, w, b = _ln_inputs(gen, rows, c)
        x = x.to(dt)
        rule = None
        if stats:
            got = layer_norm_cuda(x, w, b, 1e-5, dt, want_stats=True)
            want = layer_norm_reference_stats(x, w, b, 1e-5, dt)
            torch.cuda.synchronize()
            err = max(max_err(g, r) for g, r in zip(got, want))
            run = lambda: layer_norm_cuda(x, w, b, 1e-5, dt, want_stats=True)  # noqa: E731
            plain = lambda: layer_norm_reference_stats(x, w, b, 1e-5, dt)  # noqa: E731
        else:
            got = layer_norm(x, w, b)
            torch.cuda.synchronize()
            want = layer_norm_reference(x, w, b)
            err = max_err(got, want)
            run = lambda: layer_norm(x, w, b)  # noqa: E731
            plain = lambda: layer_norm_reference(x, w, b)  # noqa: E731
        if dt == bf16:
            f64 = layer_norm_reference_stats(x.double(), w.double(), b.double(), 1e-5, torch.float64)
            rule = check_bf16(f"layer_norm_fwd {name}", got, want, f64 if stats else f64[0], 1.25)
            del f64
        else:
            check(f"layer_norm_fwd f32 {name} (y, mean, rstd)" if stats else "layer_norm_fwd f32", err, tol)
        ms = time_ms(run, 20, dispatch=f"layer_norm_fwd {name}")
        plain_ms = time_ms(plain, 20)
        wl, bl = w.to(dt), b.to(dt)
        library_ms = time_ms(lambda: torch_layer_norm(x, (c,), wl, bl, 1e-5), 20,
                             dispatch=f"F.layer_norm {name}")
        el = x.element_size()
        n_bytes = 2 * el * rows * c + 4 * 2 * c + (4 * 2 * rows if stats else 0)
        bound_ms, bound_by = bound(n_bytes, 8 * rows * c, "f32_cuda_cores")
        row = dict(case=f"{name} rows={rows} C={c} {str(dt)[6:]}", path=path, max_abs_err=err,
                   tol=tol if dt == f32 else "check_bf16 (1.25x)", bf16_rule=rule, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   dispatch_ms=DISPATCH_MS[f"layer_norm_fwd {name}"],
                   library_dispatch_ms=DISPATCH_MS[f"F.layer_norm {name}"], dtype=str(dt)[6:])
        log(f"time layer_norm_fwd {name}: {json.dumps(row)}")
        rows_out.append(row)
    return {"cases": rows_out}


def mask_mode_pad(gen: torch.Generator, b: int, n_prefix: int, n_latent: int) -> torch.Tensor:
    """The cross-attention's pad mask (b, n_prefix + n_latent) under the
    "mask" prefix-dropout mode: ``KEEP`` of the ``n_prefix`` prefix rows
    kept, drawn per row from ``gen``, the rest masked (scattered), the
    latents unmasked."""
    keep = torch.stack([torch.randperm(n_prefix, generator=gen)[:KEEP] for _ in range(b)])
    drop = torch.ones(b, n_prefix, dtype=torch.bool).scatter_(1, keep, False)
    return torch.cat([drop, torch.zeros(b, n_latent, dtype=torch.bool)], dim=1).cuda()


def flash_bwd_phase(gen: torch.Generator) -> tuple:
    """K4a (dK/dV) and K4b (dQ) at a training chunk's shapes (batch 2): the
    causal cross-attention of 1024 latents over 7680 kept prefix keys + the
    latents, a latent self-attention, and the cross-attention with left-padded
    keys; in bf16 the "mask" prefix-dropout mode's cross-attention (1024
    latents over all 15360 prefix rows + the latents, the 7680 dropped rows
    masked where they lie); and at the image classifier's non-causal self-attention (batch 16,
    512 latents, 8 heads of 128), in f32 and in bf16. K2's forward, whose output and logsumexp
    the backward reads, is first held against its plain version on the same
    inputs. The plain
    backward computes all three gradients at once, so both kernels carry its
    time; so does the library yardstick, the backward of one
    ``scaled_dot_product_attention`` call with the same mask. Then the masked
    LM decoder's cross-attention (2048 queries over 256 latents, 8 heads of
    q/k 32 and v 96, non-causal) in f32 and bf16, and the text classifier's
    decoder (one query over 256 latents, 8 heads of 32) in bf16. Returns the
    K4a, K4b and K2 rows."""
    from torch.nn.functional import scaled_dot_product_attention

    from perceiver_io_tpu_torch.ops.flash_attention import (
        bias_row,
        bwd_delta,
        bwd_dkv_cuda,
        bwd_dq_cuda,
        flash_attention_packed,
        flash_attention_packed_bwd_reference,
    )

    lat = FLAGSHIP["max_latents"]
    clm = (TRAIN_CHUNK, FLAGSHIP["num_heads"], FLAGSHIP["num_channels"], True)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {  # name: (nq, nkv, left pads, batch, heads, channels, causal, path, dtype[, value channels])
        "ca_f32": (lat, KEEP + lat, 0, *clm, "train", f32),
        "sa_f32": (lat, lat, 0, *clm, "train", f32),
        "ca_f32_leftpad": (lat, KEEP + lat, 3001, *clm, "train", f32),
        "image_sa_f32": (IMAGE_LATENTS, IMAGE_LATENTS, 0, IMAGE_BATCH, 8, IMAGE_CHANNELS, False, "image_train", f32),
        # the bf16 builds at the bf16 CLM step's cross-attention and latent
        # self-attention, held to the rule of check_bf16 (1.25x)
        "ca_bf16": (lat, KEEP + lat, 0, *clm, "train" + BF16, bf16),
        "sa_bf16": (lat, lat, 0, *clm, "train" + BF16, bf16),
        # the mask mode's cross-attention: 7680 of the 15360 prefix keys masked
        "ca_mask_bf16": (lat, PREFIX_LEN + lat, "mask", *clm, "train_mask" + BF16, bf16),
        # and at the bf16 image step's self-attention (8 heads of 128)
        "image_sa_bf16": (IMAGE_LATENTS, IMAGE_LATENTS, 0, IMAGE_BATCH, 8, IMAGE_CHANNELS, False,
                          "image_train" + BF16, bf16),
        # the masked LM decoder's cross-attention: 2048 queries over 256
        # latents, 8 heads of q/k 32 and v 96, non-causal (f32: the fill's
        # forward; bf16: the bf16 fill and train step)
        "mlm_dec_f32": (MLM_QUERIES, MLM_LATENTS, 0, MLM_BATCH, 8, 256, False, "mlm_fill", f32, 768),
        "mlm_dec_bf16": (MLM_QUERIES, MLM_LATENTS, 0, MLM_BATCH, 8, 256, False, "mlm_train" + BF16, bf16, 768),
        # the text classifier's decoder: one query over 256 latents, 8 heads
        # of 32, non-causal (its bf16 train step)
        "clf_dec_bf16": (1, MLM_LATENTS, 0, MLM_BATCH, 8, 256, False, "text_clf_train" + BF16, bf16),
        # the symbolic audio model's train step (sam_train_bf16): 2048
        # latents over 2048 kept prefix rows + the latents and over
        # themselves, causal, 8 heads of 96 (K2's and K4's 128 tile), batch
        # 16; in f32 at batch 2 (no f32 SAM step runs)
        "sam_ca_bf16": (SAM["max_latents"], SAM_KEEP + SAM["max_latents"], 0, SAM_BATCH, SAM_HEADS,
                        SAM["num_channels"], True, "sam_train" + BF16, bf16),
        "sam_sa_bf16": (SAM["max_latents"], SAM["max_latents"], 0, SAM_BATCH, SAM_HEADS, SAM["num_channels"], True,
                        "sam_train" + BF16, bf16),
        "sam_ca_f32": (SAM["max_latents"], SAM_KEEP + SAM["max_latents"], 0, 2, SAM_HEADS, SAM["num_channels"],
                       True, "edge", f32),
        "sam_sa_f32": (SAM["max_latents"], SAM["max_latents"], 0, 2, SAM_HEADS, SAM["num_channels"], True, "edge",
                       f32),
        # MNIST's (mnist_fit, f32, batch 64): the latent self-attention (32
        # latents, 8 heads of 16) and the decoder's one query over the
        # latents (one head of 128)
        "mnist_sa_f32": (MNIST_LATENTS, MNIST_LATENTS, 0, MNIST_BATCH, 8, MNIST_CHANNELS, False, "mnist_fit", f32),
        "mnist_dec_f32": (1, MNIST_LATENTS, 0, MNIST_BATCH, 1, MNIST_CHANNELS, False, "mnist_fit", f32),
        # scripts/text/clm.py's paper preset (text_clm_cli_fit_bf16): 512
        # latents over the 1792 kept prefix rows + the latents and over
        # themselves, causal, 8 heads of 64, batch 8
        **{case: (TEXT_CLM["max_latents"], nkv, 0, TEXT_CLM_BATCH, TEXT_CLM["num_heads"], TEXT_CLM["num_channels"],
                  True, "text_clm_cli_fit" + BF16, bf16) for case, nkv in TEXT_CLM_KV.items()},
    }
    # The kernels are held to the plain version evaluated in f64 on the same
    # f32 inputs, within 1e-5, and to no larger an error than the plain
    # version evaluated in f32 has from the f64 one at the same case: they
    # must be at least as accurate as the f32 evaluation they replace. Every
    # f32 evaluation of these gradients carries an error of its own: the
    # plain version's in f32 (cuBLAS's f32 GEMMs) is 1.2e-5 from the f64 one
    # at the latent self-attention and 2.1e-5 at the image self-attention,
    # where |dQ| reaches 12, so two independent f32 evaluations cannot agree
    # within 1e-5 there. The kernels, with their score products (and K4b's
    # dQ) in f64, measured within 4.9e-6 of the f64 evaluation at these four
    # shapes on an H100 80GB HBM3. The f32 plain version's distance to the
    # kernels and to the f64 evaluation is logged beside each case.
    tol = {"dkv": 1e-5, "dq": 1e-5}
    out = {"dkv": {"cases": []}, "dq": {"cases": []}, "fwd": {"cases": []}}
    for name, (nq, nkv, pads, b, h, c, causal, path, dtype, *value) in cases.items():
        d, cv = c // h, (value or [c])[0]
        d_v = cv // h
        q = (torch.randn(b, nq, c, generator=gen) * d**-0.5).cuda().to(dtype)
        k = torch.randn(b, nkv, c, generator=gen).cuda().to(dtype)
        v = torch.randn(b, nkv, cv, generator=gen).cuda().to(dtype)
        do = torch.randn(b, nq, cv, generator=gen).cuda().to(dtype)
        pad, scattered = None, pads == "mask"
        if scattered:
            pad = mask_mode_pad(gen, b, nkv - nq, nq)
        elif pads:
            pad = torch.zeros(b, nkv, dtype=torch.bool, device="cuda")
            pad[:, :pads] = True
        out["fwd"]["cases"].append(flash_fwd_case(f"train_{name}", q, k, v, pad, h,
                                                  1e-5 if dtype == f32 else None, path, causal, scattered))
        if name in TEXT_CLM_KV:
            TEXT_CLM_ROWS.append((name, "flash_packed_fwd", out["fwd"]["cases"][-1]))
        o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, return_lse=True)
        args = (q, k, v, do, lse, bwd_delta(o, do, h), h, bias_row(pad, b, nkv, q.device), causal, 1.0)
        dk, dv = bwd_dkv_cuda(*args)
        dq = bwd_dq_cuda(*args)
        torch.cuda.synchronize()
        edq, edk, edv = by_batch(lambda lo, hi: flash_attention_packed_bwd_reference(
            *(t[lo:hi].double() for t in (q, k, v, o, lse, do)), h,
            pad_mask=None if pad is None else pad[lo:hi], causal=causal), b)
        rdq, rdk, rdv = flash_attention_packed_bwd_reference(q, k, v, o, lse, do, h, pad_mask=pad, causal=causal)
        errs = {"dkv": max(max_err64(dk, edk), max_err64(dv, edv)), "dq": max_err64(dq, edq)}
        f32_plain = {"dkv": {"kernel": max(max_err(dk, rdk), max_err(dv, rdv)),
                             "f64": max(max_err64(rdk, edk), max_err64(rdv, edv))},
                     "dq": {"kernel": max_err(dq, rdq), "f64": max_err64(rdq, edq)}}
        rules = {}
        if dtype == bf16:
            # each gradient apart: dK, dV (K4a) and dQ (K4b)
            rules = {"dkv": [check_bf16(f"flash_packed_bwd_dkv {name} {g}", got, plain, ref, 1.25)
                             for g, got, plain, ref in (("dk", dk, rdk, edk), ("dv", dv, rdv, edv))],
                     "dq": [check_bf16(f"flash_packed_bwd_dq {name} dq", dq, rdq, edq, 1.25)]}
            errs = {"dkv": max(max_err(dk, rdk), max_err(dv, rdv)), "dq": max_err(dq, rdq)}
        del edq, edk, edv
        for kernel, err in errs.items():
            if dtype == bf16:
                continue
            log(f"f32 plain flash_packed_bwd_{kernel} {name}: to the kernel {f32_plain[kernel]['kernel']:.3e}, "
                f"to the f64 evaluation {f32_plain[kernel]['f64']:.3e}")
            check(f"flash_packed_bwd_{kernel} {name} (to the f64 plain version)", err, tol[kernel])
            check(f"flash_packed_bwd_{kernel} {name} (to the f64 plain version, within the f32 plain version's "
                  "own error)", err, f32_plain[kernel]["f64"])
        times = {"dkv": time_ms(lambda: bwd_dkv_cuda(*args), dispatch=f"flash_packed_bwd_dkv {name}"),
                 "dq": time_ms(lambda: bwd_dq_cuda(*args), dispatch=f"flash_packed_bwd_dq {name}")}
        plain_ms = time_ms(lambda: flash_attention_packed_bwd_reference(q, k, v, o, lse, do, h, pad_mask=pad,
                                                                        causal=causal), 3)
        qh, kh, vh = (t.reshape(b, -1, h, t.shape[2] // h).transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ref = scaled_dot_product_attention(qh, kh, vh, attn_mask=_sdpa_keep(nq, nkv, pad) if causal else None)
        go = do.reshape(b, nq, h, d_v).transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(ref, (qh, kh, vh), go, retain_graph=True))
        pairs = b * h * visible_pairs(nq, nkv, causal) - (h * nq * int(pad.sum()) if scattered else 0)
        el, rate = q.element_size(), "split_tf32" if dtype == f32 else "bf16_tensor"
        # q, k, v, o and dO read (o and dO through delta), lse and delta read
        reads = el * b * (nq * c + nkv * c + nkv * cv + nq * cv) + 4 * (2 * b * nq * h + (b * nkv if pad is not None
                                                                                          else 0))
        # dK/dV: recompute S (d), dP (dv), dV (dv), dK (d); dQ: S, dP, dQ
        bounds = {"dkv": bound(reads + el * b * nkv * (c + cv), 4 * (d + d_v) * pairs, rate),
                  "dq": bound(reads + el * b * nq * c, 2 * (2 * d + d_v) * pairs, rate)}
        for kernel in ("dkv", "dq"):
            pad_label = f"masked={int(pad[0].sum())}" if scattered else f"left_pads={pads}"
            dims = f"D={d}" if d == d_v else f"Dqk={d} Dv={d_v}"
            row = dict(case=f"{name} batch={b} nq={nq} nkv={nkv} {pad_label} H={h} {dims} {str(dtype)[6:]} "
                            f"{'causal' if causal else 'full'}", path=path, max_abs_err=errs[kernel],
                       tol=tol[kernel] if dtype == f32 else "check_bf16 (1.25x)",
                       reference="plain version in f64" if dtype == f32 else "bf16 plain version",
                       f32_plain=f32_plain[kernel], bf16_rule=rules.get(kernel), ms=times[kernel], plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1],
                       dispatch_ms=DISPATCH_MS[f"flash_packed_bwd_{kernel} {name}"], dtype=str(dtype)[6:])
            if name in TEXT_CLM_KV:
                TEXT_CLM_ROWS.append((name, f"flash_packed_bwd_{kernel}", row))
            log(f"time flash_packed_bwd_{kernel} {name}: {json.dumps(row)}")
            out[kernel]["cases"].append(row)
    return out["dkv"], out["dq"], out["fwd"]


def layernorm_bwd_phase(gen: torch.Generator) -> dict:
    """K5 at the kv_norm rows of one training chunk (2 x 7680 x 512 f32) and
    at the image classifier's latent rows (16 x 512 x 1024), and in bf16 at
    both (the bf16 CLM's and the bf16 image step's), from K1's
    statistics, its two passes also timed apart (``p1_ms``: dx and the
    partial column sums; ``p2_ms``: their fixed-order sum); the library
    yardstick is the backward of ``F.layer_norm``."""
    rows_out = [layernorm_bwd_case(gen, TRAIN_CHUNK * KEEP, FLAGSHIP["num_channels"], "train")]
    rows_out.append(layernorm_bwd_case(gen, IMAGE_BATCH * IMAGE_LATENTS, IMAGE_CHANNELS, "image_train"))
    rows_out.append(layernorm_bwd_case(gen, TRAIN_CHUNK * KEEP, FLAGSHIP["num_channels"], "train" + BF16,
                                       torch.bfloat16))
    rows_out.append(layernorm_bwd_case(gen, IMAGE_BATCH * IMAGE_LATENTS, IMAGE_CHANNELS, "image_train" + BF16,
                                       torch.bfloat16))
    # the Perceiver IO task models: the masked LM's bf16 train step (input
    # rows, C 768, and latent rows, C 1280), and C 322 (optical flow's
    # adapted input; its backward is on no path this run drives)
    for rows, c, path in ((MLM_BATCH * MLM_QUERIES, MLM_INPUT, "mlm_train"), (MLM_BATCH * MLM_LATENTS, MLM_CHANNELS,
                                                                              "mlm_train")):
        rows_out.append(layernorm_bwd_case(gen, rows, c, path + BF16, torch.bfloat16))
    rows_out.append(layernorm_bwd_case(gen, 16384, FLOW_WIDTH, "edge"))
    rows_out.append(layernorm_bwd_case(gen, TS_BATCH * TS_OUT, TS_CHANNELS, "timeseries_train"))
    # the symbolic audio model's bf16 train step (16 x 2048 latent rows of
    # C 768) and f32 beside it, MNIST's input rows (C 131)
    rows_out.append(layernorm_bwd_case(gen, SAM_BATCH * SAM["max_latents"], SAM["num_channels"], "sam_train" + BF16,
                                       torch.bfloat16))
    rows_out.append(layernorm_bwd_case(gen, SAM_BATCH * SAM["max_latents"], SAM["num_channels"], "sam_train_f32"))
    rows_out.append(layernorm_bwd_case(gen, MNIST_BATCH * MNIST_PIXELS, MNIST_D, "mnist_fit"))
    return {"cases": rows_out}


def layernorm_bwd_case(gen: torch.Generator, rows: int, c: int, path: str, dtype=torch.float32) -> dict:
    """One K5 case; in bf16 (x and dy bf16, dx bf16, dgamma/dbeta f32) the
    whole (dx, dgamma, dbeta) held to ``check_bf16`` (1.25x) and dgamma/dbeta
    to the f32 case's tolerance against the plain sums."""
    from torch.nn.functional import layer_norm as torch_layer_norm

    from perceiver_io_tpu_torch.ops.layernorm import layer_norm_bwd_cuda, layer_norm_bwd_reference, layer_norm_cuda
    from perceiver_io_tpu_torch.ops.layernorm_triton import launch_layer_norm_bwd_dwdb, launch_layer_norm_bwd_dx

    x, w, b = _ln_inputs(gen, rows, c)
    x = x.to(dtype)
    dy = torch.randn(rows, c, generator=gen).cuda().to(dtype)
    _, mean, rstd = layer_norm_cuda(x, w, b, 1e-5, dtype, want_stats=True)
    dx, dw, db = layer_norm_bwd_cuda(x, w, mean, rstd, dy)
    torch.cuda.synchronize()
    rdx, rdw, rdb = layer_norm_bwd_reference(x, w, mean, rstd, dy)
    rule = None
    if dtype == torch.bfloat16:
        f64 = layer_norm_bwd_reference(x.double(), w.double(), mean.double(), rstd.double(), dy.double())
        rule = check_bf16(f"layer_norm_bwd {path}", (dx, dw, db), (rdx, rdw, rdb), f64, 1.25)
        del f64
    # about four times the errors measured on the card: dx (values up to ~5,
    # f32 row sums of 512 in another order) 4.8e-7; dgamma/dbeta (sums over
    # 15360 rows, values up to ~400, taken as per-program partials and a
    # second pass) 1.2e-4
    tol, tol_dw_db = 2e-6, 5e-4
    err, err_dw_db = max_err(dx, rdx), max(max_err(dw, rdw), max_err(db, rdb))
    if rule is None:
        check("layer_norm_bwd dx", err, tol)
    check(f"layer_norm_bwd dgamma/dbeta {path}", err_dw_db, tol_dw_db)
    ms = time_ms(lambda: layer_norm_bwd_cuda(x, w, mean, rstd, dy), 20, dispatch=f"layer_norm_bwd {path}")
    parts = launch_layer_norm_bwd_dx(x, w, mean, rstd, dy, torch.empty_like(x))
    p1_ms = time_ms(lambda: launch_layer_norm_bwd_dx(x, w, mean, rstd, dy, dx), 20)
    p2_ms = time_ms(lambda: launch_layer_norm_bwd_dwdb(*parts, dw, db), 20)
    plain_ms = time_ms(lambda: layer_norm_bwd_reference(x, w, mean, rstd, dy), 20)
    xr, wr, br = (t.detach().to(dtype).requires_grad_() for t in (x, w, b))
    ref = torch_layer_norm(xr, (c,), wr, br, 1e-5)
    library_ms = time_ms(lambda: torch.autograd.grad(ref, (xr, wr, br), dy, retain_graph=True), 20)
    # x and dy read, dx written (el bytes an element), the statistics read,
    # gamma read, dgamma/dbeta written; about 13 operations per element
    el = x.element_size()
    bound_ms, bound_by = bound(3 * el * rows * c + 4 * (2 * rows + 3 * c), 13 * rows * c, "f32_cuda_cores")
    row = dict(case=f"rows={rows} C={c} {str(dtype)[6:]}", path=path, max_abs_err=err,
               tol=tol if rule is None else "check_bf16 (1.25x)", bf16_rule=rule, max_abs_err_dw_db=err_dw_db,
               tol_dw_db=tol_dw_db, ms=ms, p1_ms=p1_ms, p2_ms=p2_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, dispatch_ms=DISPATCH_MS[f"layer_norm_bwd {path}"],
               dtype=str(dtype)[6:])
    log(f"time layer_norm_bwd {path}: {json.dumps(row)}")
    return row


def twoseg_phase(gen: torch.Generator) -> dict:
    """K6 (forward), K7a (dK/dV) and K7b (dQ) against the plain two-segment
    versions, in f32 and in bf16: the training chunk's cross-attention
    (batch 2, 1024 latents over 7680 kept prefix rows), the same with 3001
    left-padded prefix keys over 7679 rows, the eval window (batch 1, 15360
    prefix rows; forward only, its kv walk split) and the minimum prefix (one
    row, 1000 latents). Beside each: the plain version's time, the route it
    replaces (the K/V join, then K2 or K4a/K4b on the joined operands) and
    the library yardstick, one ``scaled_dot_product_attention`` call (and
    its backward) on the joined operands with the explicit causal + pad
    mask, in the same dtype. Returns the rows by kernel (bf16 builds under
    their ``_bf16`` names)."""
    from torch.nn.functional import scaled_dot_product_attention

    from perceiver_io_tpu_torch.ops.flash_attention import (
        bias_row,
        bwd_2seg_dkv_cuda,
        bwd_2seg_dq_cuda,
        bwd_delta,
        bwd_dkv_cuda,
        bwd_dq_cuda,
        flash_attention_packed,
        flash_attention_packed_2seg,
        flash_attention_packed_2seg_bwd_reference,
        flash_attention_packed_2seg_reference,
        packed_kv_splits,
    )

    h, c = FLAGSHIP["num_heads"], FLAGSHIP["num_channels"]
    d, lat = c // h, FLAGSHIP["max_latents"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {  # name: (batch, prefix rows, latents, left pads, backward too, path)
        "train_ca": (TRAIN_CHUNK, KEEP, lat, 0, True, "train_twoseg"),
        "train_ca_leftpad": (TRAIN_CHUNK, KEEP - 1, lat, 3001, True, "train_twoseg"),
        "eval_window": (1, PREFIX_LEN, lat, 0, False, "eval_twoseg"),
        "min_prefix": (TRAIN_CHUNK, 1, 1000, 0, True, "edge"),
    }
    cases = {**{name: (*shape, f32) for name, shape in shapes.items()},
             **{f"{name}_bf16": (*shape[:5], shape[5] + (BF16 if shape[5] != "edge" else ""), bf16)
                for name, shape in shapes.items()},
             # the "mask" prefix-dropout mode under twoseg: all 15360 prefix
             # rows, the 7680 dropped ones masked where they lie
             "train_ca_mask_bf16": (TRAIN_CHUNK, PREFIX_LEN, lat, "mask", True, "train_mask_twoseg" + BF16, bf16)}
    # f32: K6 against the plain version in f32 (1e-5); K7a and K7b, as K4a
    # and K4b in flash_bwd_phase, against the plain backward evaluated in f64
    # on the same f32 inputs, within 1e-5, and no further from it than the
    # plain backward evaluated in f32 is, kernel by kernel and case by case:
    # their tensor-core sums (f64 scores and dQ, split-TF32 dK/dV) do not
    # run in the f32 plain version's order, so it cannot be the reference.
    # bf16: each output held by check_bf16 (1.25x the bf16 plain version's
    # L2 distance from the f64 evaluation of the same bf16 inputs)
    tol = 1e-5
    out = {k + sfx: {"cases": []} for k in TWOSEG_KERNELS for sfx in ("", BF16)}
    for name, (b, n_p, nq, pads, with_bwd, path, dtype) in cases.items():
        sfx, el = (BF16 if dtype == bf16 else ""), (2 if dtype == bf16 else 4)
        rate = "bf16_tensor" if dtype == bf16 else "split_tf32"
        q = (torch.randn(b, nq, c, generator=gen) * d**-0.5).cuda().to(dtype)
        k_p, v_p = (torch.randn(b, n_p, c, generator=gen).cuda().to(dtype) for _ in range(2))
        k_l, v_l = (torch.randn(b, nq, c, generator=gen).cuda().to(dtype) for _ in range(2))
        ops = (q, k_p, v_p, k_l, v_l)
        pad_p = pad_l = pad_cat = None
        if pads == "mask":
            pad_cat = mask_mode_pad(gen, b, n_p, nq)
            pad_p, pad_l = pad_cat[:, :n_p], pad_cat[:, n_p:]
        elif pads:
            pad_p = torch.zeros(b, n_p, dtype=torch.bool, device="cuda")
            pad_p[:, :pads] = True
            pad_l = torch.zeros(b, nq, dtype=torch.bool, device="cuda")
            pad_cat = torch.cat([pad_p, pad_l], dim=1)
        kw = dict(pad_mask_prefix=pad_p, pad_mask_latent=pad_l)
        o, lse = flash_attention_packed_2seg(*ops, h, return_lse=True, **kw)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_packed_2seg_reference(*ops, h, **kw)
        err = max_err(o, ro)
        rule = None
        if dtype == bf16:
            eo, _ = flash_attention_packed_2seg_reference(*(t.double() for t in ops), h, **kw)
            rule = check_bf16(f"flash_2seg_fwd {name}", o, ro, eo, 1.25)
            del eo
        else:
            check(f"flash_2seg_fwd {name} out", err, tol)
        check(f"flash_2seg_fwd {name} lse", max_err(lse, rlse), 1e-4)
        del ro, rlse

        nkv = n_p + nq
        k_cat, v_cat = torch.cat([k_p, k_l], dim=1), torch.cat([v_p, v_l], dim=1)
        concat_ms = time_ms(lambda: (torch.cat([k_p, k_l], dim=1), torch.cat([v_p, v_l], dim=1)))
        qh, kh, vh = (t.reshape(b, -1, h, d).transpose(1, 2) for t in (q, k_cat, v_cat))
        keep = _sdpa_keep(nq, nkv, pad_cat)
        # visible (query, key) pairs: no work for a masked prefix row of the mask mode
        masked = int(pad_p.sum()) if pads == "mask" else 0
        pairs = h * (b * (nq * n_p + nq * (nq + 1) // 2) - nq * masked)
        reads = el * (b * nq * c + 2 * b * nkv * c) + (4 * b * nkv if pads else 0)
        pad_label = f"masked={masked // b}" if pads == "mask" else f"left_pads={pads}"
        shape = f"{name} batch={b} nq={nq} np={n_p} {pad_label} H={h} D={d} {str(dtype)[6:]}"
        bound_ms, bound_by = bound(reads + el * b * nq * c + 4 * b * nq * h, 4 * d * pairs, rate)
        row = dict(case=shape, path=path, max_abs_err=err, tol=tol if dtype == f32 else "check_bf16 (1.25x)",
                   bf16_rule=rule, dtype=str(dtype)[6:],
                   ms=time_ms(lambda: flash_attention_packed_2seg(*ops, h, **kw), dispatch=f"flash_2seg_fwd {name}"),
                   plain_ms=time_ms(lambda: flash_attention_packed_2seg_reference(*ops, h, **kw), 3),
                   library_ms=time_ms(lambda: scaled_dot_product_attention(qh, kh, vh, attn_mask=keep)),
                   concat_ms=concat_ms,
                   k2_concat_ms=time_ms(lambda: flash_attention_packed(q, k_cat, v_cat, h, pad_mask=pad_cat,
                                                                       causal=True)),
                   bound_ms=bound_ms, bound_by=bound_by, dispatch_ms=DISPATCH_MS[f"flash_2seg_fwd {name}"],
                   kv_splits=packed_kv_splits(b, h, nq, nkv, d, sms, dtype))
        log(f"time flash_2seg_fwd {name}: {json.dumps(row)}")
        out["flash_2seg_fwd" + sfx]["cases"].append(row)
        if not with_bwd:
            continue

        do = torch.randn(b, nq, c, generator=gen).cuda().to(dtype)
        delta = bwd_delta(o, do, h)
        args = (*ops, do, lse, delta, h, bias_row(pad_p, b, n_p, q.device), bias_row(pad_l, b, nq, q.device), 1.0)
        dk_p, dv_p, dk_l, dv_l = bwd_2seg_dkv_cuda(*args)
        dq = bwd_2seg_dq_cuda(*args)
        torch.cuda.synchronize()
        got = {"flash_2seg_bwd_dkv": (dk_p, dv_p, dk_l, dv_l), "flash_2seg_bwd_dq": (dq,)}
        e64 = flash_attention_packed_2seg_bwd_reference(*(t.double() for t in (*ops, o, lse, do)), h, **kw)
        r32 = flash_attention_packed_2seg_bwd_reference(*ops, o, lse, do, h, **kw)
        refs = {"flash_2seg_bwd_dkv": (e64[1:], r32[1:]), "flash_2seg_bwd_dq": (e64[:1], r32[:1])}
        errs, f32_plain, rules = {}, {}, {}
        for kernel, xs in got.items():
            w64, w32 = refs[kernel]
            if dtype == bf16:  # each gradient apart, against the bf16 plain version's
                grads = ("dk_p", "dv_p", "dk_l", "dv_l") if kernel.endswith("dkv") else ("dq",)
                rules[kernel] = [check_bf16(f"{kernel} {name} {g}", x, p, e, 1.25)
                                 for g, x, p, e in zip(grads, xs, w32, w64)]
                errs[kernel] = max(max_err(x, w) for x, w in zip(xs, w32))
                continue
            errs[kernel] = max(max_err64(x, w) for x, w in zip(xs, w64))
            f32_plain[kernel] = {"kernel": max(max_err(x, w) for x, w in zip(xs, w32)),
                                 "f64": max(max_err64(x, w) for x, w in zip(w32, w64))}
        del e64, r32, refs
        for kernel, e in errs.items():
            if dtype == bf16:
                continue
            log(f"f32 plain {kernel} {name}: to the kernel {f32_plain[kernel]['kernel']:.3e}, "
                f"to the f64 evaluation {f32_plain[kernel]['f64']:.3e}")
            check(f"{kernel} {name} (to the f64 plain version)", e, tol)
            check(f"{kernel} {name} (to the f64 plain version, within the f32 plain version's own error)", e,
                  f32_plain[kernel]["f64"])
        times = {"flash_2seg_bwd_dkv": time_ms(lambda: bwd_2seg_dkv_cuda(*args),
                                               dispatch=f"flash_2seg_bwd_dkv {name}"),
                 "flash_2seg_bwd_dq": time_ms(lambda: bwd_2seg_dq_cuda(*args), dispatch=f"flash_2seg_bwd_dq {name}")}
        args_cat = (q, k_cat, v_cat, do, lse, delta, h, bias_row(pad_cat, b, nkv, q.device), True, 1.0)
        k4_ms = {"flash_2seg_bwd_dkv": time_ms(lambda: bwd_dkv_cuda(*args_cat)),
                 "flash_2seg_bwd_dq": time_ms(lambda: bwd_dq_cuda(*args_cat))}
        plain_ms = time_ms(lambda: flash_attention_packed_2seg_bwd_reference(*ops, o, lse, do, h, **kw), 3)
        qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))
        ref = scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        go = do.reshape(b, nq, h, d).transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), go, retain_graph=True))
        reads = el * (2 * b * nq * c + 2 * b * nkv * c) + 4 * 2 * b * nq * h + (4 * b * nkv if pads else 0)
        bounds = {"flash_2seg_bwd_dkv": bound(reads + el * 2 * b * nkv * c, 8 * d * pairs, rate),
                  "flash_2seg_bwd_dq": bound(reads + el * b * nq * c, 6 * d * pairs, rate)}
        for kernel in errs:
            row = dict(case=shape, path=path, max_abs_err=errs[kernel], tol=tol if dtype == f32 else
                       "check_bf16 (1.25x)", reference="plain version in f64" if dtype == f32 else
                       "bf16 plain version", f32_plain=f32_plain.get(kernel), bf16_rule=rules.get(kernel),
                       dtype=str(dtype)[6:], ms=times[kernel], plain_ms=plain_ms, library_ms=library_ms,
                       concat_ms=concat_ms, k4_concat_ms=k4_ms[kernel], bound_ms=bounds[kernel][0],
                       bound_by=bounds[kernel][1], dispatch_ms=DISPATCH_MS[f"{kernel} {name}"])
            log(f"time {kernel} {name}: {json.dumps(row)}")
            out[kernel + sfx]["cases"].append(row)
        del ref, qg, kg, vg
    return out


def lse_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs difference of two logsumexps that may hold -inf (rows that
    see no key): inf where one is -inf and the other not."""
    inf_a, inf_b = torch.isneginf(a), torch.isneginf(b)
    if not torch.equal(inf_a, inf_b):
        return math.inf
    return max_err(a[~inf_a], b[~inf_b]) if bool((~inf_a).any()) else 0.0


def visible_pairs(nq: int, nkv: int, causal: bool) -> int:
    """(query, key) pairs a head sees under the right-aligned causal mask."""
    if not causal:
        return nq * nkv
    return sum(max(0, min(nkv, i + nkv - nq + 1)) for i in range(nq))


def sdpa_backend(q, k, v, mask) -> str:
    """The first fused ``scaled_dot_product_attention`` backend that takes
    these operands, or "math" (PyTorch's unfused composition)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                scaled_dot_product_attention(q, k, v, attn_mask=mask)
            return name.lower()
        except RuntimeError:
            continue
    return "math"


def heads_phase(gen: torch.Generator) -> dict:
    """K8 (forward), K9a (dK/dV) and K9b (dQ) against the plain heads-major
    versions: the image classifier's cross-attention (512 latents over 50176
    pixels, one head of 264 channels, non-causal) at batch 16, the main
    path's (no kv split), and at batch 2 (K8's kv walk split 8 ways, K9b's
    4), and the odd-width, causal, pad-mask, Nq > Nkv and split-walk cases
    of the CPU tests; then the bf16 builds at the image CA (batch 16, the
    bf16 image step's shape, and batch 2). K9a and K9b are held to the plain
    backward evaluated in f64 and to the f32 plain version's own distance
    from it; at batch 16 the plain backward holds ~8 GB of f32 (16, 512,
    50176) intermediates, its f64 evaluation ~16 GB, one after the other.
    The bf16 builds are held by ``check_bf16`` (1.25x the bf16 plain
    version's L2 distance from the f64 evaluation of the same bf16 inputs),
    output and each gradient apart. The kernels run through their wrappers
    on the (B*H, N, D8) operands ``flash_attention`` hands them (odd widths
    zero-padded); the plain versions and the library yardstick, one
    ``scaled_dot_product_attention`` call (and its backward) with the same
    mask in the same dtype, on the (B, H, N, D) operands. The Perceiver IO
    task models' cases follow (``mlm_*``, ``flow_*``, ``ts_*``; the flow
    cases forward only). Returns the rows by kernel (the bf16 builds' under
    ``<kernel>_bf16``)."""
    from torch.nn.functional import scaled_dot_product_attention

    from perceiver_io_tpu_torch.ops import flash_attention as tflash

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, batch, heads, nq, nkv, head dim, causal, left pads, path, dtype
        ("image_ca_b16", IMAGE_BATCH, 1, IMAGE_LATENTS, IMAGE_PIXELS, IMAGE_D, False, 0, "image_train", f32),
        ("image_ca_b2", 2, 1, IMAGE_LATENTS, IMAGE_PIXELS, IMAGE_D, False, 0, "edge", f32),
        ("d12_causal_pad", 2, 2, 130, 300, 12, True, 37, "edge", f32),
        ("d40_full", 2, 2, 130, 300, 40, False, 0, "edge", f32),
        ("d133_causal_pad", 2, 2, 130, 300, 133, True, 37, "edge", f32),
        ("d264_full_pad", 2, 1, 130, 300, 264, False, 37, "edge", f32),
        ("d512_causal", 2, 2, 130, 300, 512, True, 0, "edge", f32),
        ("nq_gt_nkv_causal", 2, 2, 300, 130, 40, True, 0, "edge", f32),
        ("split_walk_causal_pad", 2, 2, 100, 3000, 136, True, 50, "edge", f32),
        # the bf16 builds: the bf16 image step's cross-attention, and batch 2
        # (K8's walk split, K9b's split)
        ("image_ca_b16_bf16", IMAGE_BATCH, 1, IMAGE_LATENTS, IMAGE_PIXELS, IMAGE_D, False, 0, "image_train" + BF16,
         bf16),
        ("image_ca_b2_bf16", 2, 1, IMAGE_LATENTS, IMAGE_PIXELS, IMAGE_D, False, 0, "edge", bf16),
        # the Perceiver IO task models (ROADMAP A13): the masked LM encoder's
        # cross- and self-attention at the train batch (8 heads of q/k 32 and
        # v 160; the f32 cases are the fill's forward shapes), optical
        # flow's encoder cross-attention (2048 latents over 182,528 pixels,
        # one head of 322, which the wrapper pads to 328) and decoder
        # (182,528 queries over 2048 latents, one head of 512), forward
        # only, and the time series' three attentions (one head of 256)
        *[(f"mlm_{kind}_{str(dt)[6:]}", MLM_BATCH, 8, MLM_LATENTS, nkv, (32, 160), False, 0,
           "mlm_fill" if dt == f32 else "mlm_train" + BF16, dt)
          for dt in (f32, bf16) for kind, nkv in (("ca", MLM_QUERIES), ("sa", MLM_LATENTS))],
        *[(f"flow_{kind}_{str(dt)[6:]}", 1, 1, nq, nkv, d, False, 0, "flow" + ("" if dt == f32 else BF16), dt, False)
          for dt in (f32, bf16) for kind, nq, nkv, d in (("ca", FLOW_LATENTS, FLOW_PIXELS, FLOW_WIDTH),
                                                       ("dec", FLOW_PIXELS, FLOW_LATENTS, FLOW_CHANNELS))],
        *[(f"ts_{kind}", TS_BATCH, 1, nq, nkv, TS_CHANNELS, False, 0, "timeseries_train", f32)
          for kind, nq, nkv in (("ca", TS_LATENTS, TS_IN), ("sa", TS_LATENTS, TS_LATENTS),
                                ("dec", TS_OUT, TS_LATENTS))],
        # MNIST's cross-attention (mnist_fit): 32 latents over 784 pixels, one
        # head of 131 channels, which the wrapper pads to 136; f32, and bf16
        ("mnist_ca", MNIST_BATCH, 1, MNIST_LATENTS, MNIST_PIXELS, MNIST_D, False, 0, "mnist_fit", f32),
        ("mnist_ca_bf16", MNIST_BATCH, 1, MNIST_LATENTS, MNIST_PIXELS, MNIST_D, False, 0, "edge", bf16),
    ]
    # K8 against the plain version in f32: measured within 2.2e-6 on an
    # H100 (split-TF32 products; 4.7e-7 at the image CA, PERF.md); 1e-5
    # allows a reordered f32 sum of these values (up to ~5). Each case's
    # distance from the plain version evaluated in f64 is logged beside the
    # f32 plain version's own (not gated).
    # K9a and K9b are held to the plain backward evaluated in f64 on the same
    # f32 inputs (K8's output and logsumexp), within 1e-5 (dK/dV) and 6e-5
    # (dQ: each row of dS sums to zero, so dQ = dS K cancels over up to 50176
    # keys), and to no larger an error than the plain version evaluated in
    # f32 has from that f64 evaluation, case by case: they must be at least as
    # accurate as the f32 evaluation they replace. The f32 plain version is
    # itself up to 4.1e-5 (dQ, D = 512) and 1.9e-6 (dK/dV) from the f64 one at
    # these cases; the kernels, with every product in f64 on the tensor
    # cores, measured within 1.9e-6 (dQ) and 3.2e-7 (dK/dV) of it on an H100
    # 80GB HBM3 (PERF.md). Both distances are logged beside each case.
    tol = {"flash_heads_fwd": 1e-5, "flash_heads_bwd_dkv": 1e-5, "flash_heads_bwd_dq": 6e-5}
    out = {k + sfx: {"cases": []} for k in HEADS_KERNELS for sfx in ("", BF16)}
    for name, b, h, nq, nkv, d, causal, pads, path, dtype, *backward in cases:
        # d: one head dim, or (q/k, v); backward: False for a forward-only path
        d, dv = d if isinstance(d, tuple) else (d, d)
        sfx = BF16 if dtype == bf16 else ""
        rate, el = ("bf16_tensor", 2) if dtype == bf16 else ("split_tf32", 4)
        q = (torch.randn(b, h, nq, d, generator=gen) * d**-0.5).cuda().to(dtype)
        k = torch.randn(b, h, nkv, d, generator=gen).cuda().to(dtype)
        v = torch.randn(b, h, nkv, dv, generator=gen).cuda().to(dtype)
        pad = None
        if pads:
            pad = torch.zeros(b, nkv, dtype=torch.bool, device="cuda")
            pad[:, :pads] = True
        bias = tflash.bias_row(pad, b, nkv, q.device)
        qf, kf, vf = tflash._heads_layout(q, k, v)
        d8, dv8 = qf.shape[2], vf.shape[2]
        o, lse = tflash.heads_fwd_cuda(qf, kf, vf, h, bias, causal, 1.0)
        torch.cuda.synchronize()
        ro, rlse = tflash.flash_attention_reference(q, k, v, pad, causal)
        err = max_err(o[..., :dv].reshape(ro.shape), ro)
        check(f"flash_heads_fwd{sfx} {name} lse", lse_err(lse.reshape(rlse.shape), rlse), 1e-4)
        exact = tflash.flash_attention_reference(*(t.double() for t in (q, k, v)), pad, causal)[0]
        rule = None
        if dtype == bf16:
            rule = check_bf16(f"flash_heads_fwd {name}", o[..., :dv].reshape(ro.shape), ro, exact, 1.25)
        else:
            check(f"flash_heads_fwd {name} out", err, tol["flash_heads_fwd"])
        f64 = {"kernel": max_err64(o[..., :dv].reshape(ro.shape), exact), "plain": max_err64(ro, exact)}
        del exact
        log(f"f64 flash_heads_fwd{sfx} {name}: kernel {f64['kernel']:.3e}, plain version {f64['plain']:.3e}")
        mask = None
        if causal or pad is not None:
            mask = _sdpa_keep(nq, nkv, pad) if causal else ~pad[:, None, None, :]
        backend = sdpa_backend(q, k, v, mask)
        pairs = b * h * visible_pairs(nq, nkv, causal)
        dims = f"D={d} (kernel D={d8})" if d == dv else f"Dqk={d} Dv={dv} (kernel {d8}/{dv8})"
        shape = (f"{name} batch={b} H={h} nq={nq} nkv={nkv} {dims} "
                 f"{'causal' if causal else 'full'} left_pads={pads} {str(dtype)[6:]}")
        # the bound counts the function's own head dims: the wrapper's zero
        # padding to a multiple of 8 is its own extra work
        reads = el * b * h * (nq * d + nkv * d + nkv * dv) + (4 * b * nkv if pad is not None else 0)
        bound_ms, bound_by = bound(reads + el * b * h * nq * dv + 4 * b * h * nq, 2 * (d + dv) * pairs, rate)
        # K8's kv split, priced as K9b's below
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        fwd_splits = tflash.heads_fwd_splits(b * h, nq, nkv, max(d8, dv8), sms,
                                             tflash._heads_fwd_slots(q.device.index, d8, dv8, dtype))
        row = dict(case=shape, path=path, max_abs_err=err, tol="check_bf16 (1.25x)" if rule else tol["flash_heads_fwd"],
                   bf16_rule=rule, f64_err=f64, dtype=str(dtype)[6:],
                   ms=time_ms(lambda: tflash.heads_fwd_cuda(qf, kf, vf, h, bias, causal, 1.0),
                              dispatch=f"flash_heads_fwd{sfx} {name}"),
                   plain_ms=time_ms(lambda: tflash.flash_attention_reference(q, k, v, pad, causal), 3),
                   library_ms=time_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=mask)),
                   library=f"scaled_dot_product_attention ({backend})", bound_ms=bound_ms, bound_by=bound_by,
                   dispatch_ms=DISPATCH_MS[f"flash_heads_fwd{sfx} {name}"], kv_splits=fwd_splits,
                   unsplit_ms=(time_ms(lambda: tflash.heads_fwd_cuda(qf, kf, vf, h, bias, causal, 1.0, nsplit=1))
                               if fwd_splits > 1 else None))
        log(f"split flash_heads_fwd{sfx} {name}: kv_splits={fwd_splits} ms={row['ms']:.4f} "
            f"unsplit_ms={row['unsplit_ms']}")
        log(f"time flash_heads_fwd{sfx} {name}: {json.dumps(row)}")
        out["flash_heads_fwd" + sfx]["cases"].append(row)
        del ro, rlse
        if backward == [False]:
            del o, lse, qf, kf, vf, q, k, v
            free_card()
            continue

        # the plain backward reads the same inputs as K9a/K9b: K8's output
        # and logsumexp
        o4, lse4 = o[..., :dv].reshape(b, h, nq, dv), lse.reshape(b, h, nq)
        do = torch.randn(b, h, nq, dv, generator=gen).cuda().to(dtype)
        dof = torch.nn.functional.pad(do.reshape(b * h, nq, dv), (0, dv8 - dv))
        delta = (dof.float() * o.float()).sum(dim=-1)
        args = (qf, kf, vf, dof, lse, delta, h, bias, causal, 1.0)
        dk, dv_ = tflash.heads_bwd_dkv_cuda(*args)
        dq = tflash.heads_bwd_dq_cuda(*args)
        torch.cuda.synchronize()
        got = {"dq": dq[..., :d].reshape(q.shape), "dk": dk[..., :d].reshape(k.shape),
               "dv": dv_[..., :dv].reshape(v.shape)}
        del dq, dk, dv_
        # the plain version first (its (B, H, Nq, Nkv) intermediates are
        # freed when it returns), then the f64 one: ~20 GB at batch 16
        plain = dict(zip(("dq", "dk", "dv"), tflash.flash_attention_bwd_reference(q, k, v, o4, lse4, do, pad,
                                                                                  causal)))
        exact = dict(zip(("dq", "dk", "dv"), tflash.flash_attention_bwd_reference(
            *(t.double() for t in (q, k, v, o4, lse4, do)), pad, causal)))
        parts = {"flash_heads_bwd_dkv": ("dk", "dv"), "flash_heads_bwd_dq": ("dq",)}
        rules = {}
        if dtype == bf16:
            rules = {kernel: [check_bf16(f"{kernel} {name} {g}", got[g], plain[g], exact[g], 1.25) for g in gs]
                     for kernel, gs in parts.items()}
            errs = {kernel: max(max_err(got[g], plain[g]) for g in gs) for kernel, gs in parts.items()}
        else:
            errs = {kernel: max(max_err64(got[g], exact[g]) for g in gs) for kernel, gs in parts.items()}
            f32_plain = {kernel: {"kernel": max(max_err(got[g], plain[g]) for g in gs),
                                  "f64": max(max_err64(plain[g], exact[g]) for g in gs)}
                         for kernel, gs in parts.items()}
            for kernel, e in errs.items():
                log(f"f32 plain {kernel} {name}: to the kernel {f32_plain[kernel]['kernel']:.3e}, "
                    f"to the f64 evaluation {f32_plain[kernel]['f64']:.3e}")
                check(f"{kernel} {name} (to the f64 plain version)", e, tol[kernel])
                check(f"{kernel} {name} (to the f64 plain version, within the f32 plain version's own error)", e,
                      f32_plain[kernel]["f64"])
        del got, plain, exact
        times = {"flash_heads_bwd_dkv": time_ms(lambda: tflash.heads_bwd_dkv_cuda(*args),
                                                dispatch=f"flash_heads_bwd_dkv{sfx} {name}"),
                 "flash_heads_bwd_dq": time_ms(lambda: tflash.heads_bwd_dq_cuda(*args),
                                               dispatch=f"flash_heads_bwd_dq{sfx} {name}")}
        # K9b's kv split, priced: the rule's split count and, where it
        # splits, the time of the same call unsplit
        splits = tflash.heads_dq_splits(b * h, nq, nkv, max(d8, dv8), sms,
                                        tflash._heads_dq_slots(q.device.index, d8, dv8, dtype))
        unsplit_ms = time_ms(lambda: tflash.heads_bwd_dq_cuda(*args, nsplit=1)) if splits > 1 else None
        log(f"split flash_heads_bwd_dq{sfx} {name}: kv_splits={splits} ms={times['flash_heads_bwd_dq']:.4f} "
            f"unsplit_ms={unsplit_ms}")
        plain_ms = time_ms(lambda: tflash.flash_attention_bwd_reference(q, k, v, o4, lse4, do, pad, causal), 3)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        ref = scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        library_ms = time_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), do, retain_graph=True))
        reads = el * b * h * (nq * d + nkv * d + nkv * dv + nq * dv) + 4 * 2 * b * h * nq + (
            4 * b * nkv if pad is not None else 0)
        bounds = {"flash_heads_bwd_dkv": bound(reads + el * b * h * nkv * (d + dv), 4 * (d + dv) * pairs, rate),
                  "flash_heads_bwd_dq": bound(reads + el * b * h * nq * d, 2 * (2 * d + dv) * pairs, rate)}
        for kernel in errs:
            row = dict(case=shape, path=path, max_abs_err=errs[kernel],
                       tol="check_bf16 (1.25x)" if rules else tol[kernel],
                       reference="bf16 plain version" if rules else "plain version in f64",
                       f32_plain=None if rules else f32_plain[kernel], bf16_rule=rules.get(kernel),
                       ms=times[kernel], plain_ms=plain_ms, library_ms=library_ms,
                       library=f"scaled_dot_product_attention backward ({backend})", bound_ms=bounds[kernel][0],
                       bound_by=bounds[kernel][1], dispatch_ms=DISPATCH_MS[f"{kernel}{sfx} {name}"],
                       dtype=str(dtype)[6:])
            if kernel == "flash_heads_bwd_dq":
                row.update(kv_splits=splits, unsplit_ms=unsplit_ms)
            log(f"time {kernel}{sfx} {name}: {json.dumps(row)}")
            out[kernel + sfx]["cases"].append(row)
        del ref, qg, kg, vg, args, o, lse, qf, kf, vf, q, k, v, do, dof
        free_card()
    return out


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def serve_engine(model, graphed: bool, cache_dtype: torch.dtype = None, engine: dict = None, weight_dtype=None,
                 **kw):
    """The serve's engine. Its decode step is the captured CUDA graph
    (``make_paged_step_fn`` on the card, captured at construction), or,
    with ``graphed=False``, the eager reference: the host's draws, then the
    step's body (``generation._eager_step``) on the same state. ``engine``
    overrides fields of the serve's ``EngineConfig`` (sharing, eviction, pool
    headroom); ``kw`` goes to ``EngineFrontEnd`` (the admission tier's
    events, clock, injector, config, journal). Returns the engine and the
    launches of the capture's warm-up, one eager decode step while every
    slot is idle."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd

    config = generation.GenerationConfig()
    build.reset_launches()
    engine = EngineFrontEnd(
        model, num_latents=NUM_LATENTS, base_config=config,
        engine_config=EngineConfig(**{**SERVE_GEOMETRY, **(engine or {})}),
        cache_dtype=cache_dtype, weight_dtype=weight_dtype, device="cuda", **kw,
    )
    torch.cuda.synchronize()
    warm_up = {k: n for k, n in build.LAUNCHES.items() if n}
    if not graphed:
        engine._step_fn = generation._eager_step(model, config, model.device)
    return engine, warm_up


def serve_run(engine, specs, record_lengths: bool = False) -> dict:
    """One closed-loop serve of ``specs``: launches, decode tok/s and, with
    ``record_lengths``, the lengths every K3 call of every decode step read
    (the engine's fixed per-pool ``length`` tensors right after the step,
    before retires zero them)."""
    from perceiver_io_tpu_torch.ops import build

    lengths = []
    if record_lengths:
        step_fn = engine._step_fn

        def recorded(state):
            out = step_fn(state)
            lengths.append(torch.stack([pool.length for pool in state["cache"]]))
            return out

        engine._step_fn = recorded
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = engine.run_closed(specs, concurrency=len(specs))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    prefill_s = sum(r.ttft_s for r in records)
    decoded = sum(len(engine.served_tokens[r.index]) - 1 for r in records)
    return {"records": records, "launches": dict(build.LAUNCHES), "wall_s": wall_s, "prefill_s": prefill_s,
            "decoded": decoded, "decode_tok_s": decoded / (wall_s - prefill_s), "steps": engine._engine_steps,
            "lengths": lengths}


def check_serve(name: str, engine, run: dict, suffix: str = "", n_ok: int = N_REQUESTS) -> None:
    """The books (``n_ok`` requests served ok), the page allocators and K3's
    launches (the CA and 8 SA pools, once each a decode step) of one serve;
    with ``suffix`` (``BF16``) every kernel launch of the serve's path must
    be its bf16 build's."""
    launches, steps, n_sa = run["launches"], run["steps"], FLAGSHIP["num_self_attention_layers"]
    k3 = "paged_decode" + suffix
    log(f"{name} launches: {json.dumps(launches)}")
    log(f"{name} decode steps={steps}: {k3} launches ca={steps} sa={n_sa * steps} total={launches[k3]}")
    if launches[k3] != (1 + n_sa) * steps:
        raise SystemExit(f"{name}: {k3} launched {launches[k3]} times in {steps} decode steps, not {1 + n_sa} a step")
    if suffix and any(launches[k] for k in SERVE_KERNELS):
        raise SystemExit(f"{name}: f32 builds launched in a bf16 serve: {launches}")
    missing = [k + suffix for k in SERVE_KERNELS if launches[k + suffix] == 0]
    if missing:
        raise SystemExit(f"{name}: kernels never launched on the serving path: {missing}")
    books = engine.books()
    if not books["balanced"] or books["ok"] != n_ok:
        raise SystemExit(f"{name}: engine books wrong: {books}")
    used = (engine.ca_alloc.pages_used, engine.sa_alloc.pages_used)
    problems = engine.ca_alloc.audit() + engine.sa_alloc.audit()
    if used != (0, 0) or problems:
        raise SystemExit(f"{name}: page allocators not returned: used={used} problems={problems}")


def serve_specs() -> list:
    """The serve's six greedy requests: prompts of 2048-16256 tokens and
    budgets of 32-64 tokens, from the seed."""
    from perceiver_io_tpu_torch.serving import RequestSpec

    rng = np.random.default_rng(SEED)
    specs = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(2048, 16257))
        specs.append(RequestSpec(
            index=i, prompt_len=n, max_new_tokens=int(rng.integers(32, 65)),
            input_ids=rng.integers(0, FLAGSHIP["vocab_size"], size=(1, n)), rng_seed=int(rng.integers(1 << 30)),
        ))
    return specs


def check_streams(name: str, model, specs, served: dict, near_tie: float, cache_dtype=torch.float32,
                  weight_dtype=None, num_latents: int = NUM_LATENTS) -> list:
    """Each served stream against the sequential ``make_decode_fns`` stream
    (contiguous caches of ``cache_dtype``, decode weights ``weight_dtype``,
    ``num_latents`` latents; its step the captured graph),
    token by token with the sequential logits (``state["logits"]`` after the
    prefill and each step): equal up to the first step whose top-2 gap is
    under ``near_tie`` (the paged and contiguous decodes sum in different
    orders). Returns, per request, how many leading tokens the two share.
    The sequential streams and logits are kept (``SEQUENTIAL``): every phase
    builds the flagship from ``SEED``, so a later phase on the same prompts
    reads them back."""
    from perceiver_io_tpu_torch.generation import GenerationConfig, _GraphedStep, make_decode_fns

    agreed = []
    for spec in specs:
        ids = np.asarray(spec.input_ids)
        key = (model.dtype, model.config.num_channels, cache_dtype, weight_dtype, spec.max_new_tokens, ids.shape,
               ids.tobytes())
        if key not in SEQUENTIAL:
            prefill, step = make_decode_fns(model, num_latents, GenerationConfig(max_new_tokens=spec.max_new_tokens),
                                            cache_dtype, weight_dtype, device="cuda")
            if not isinstance(step.body, _GraphedStep):
                raise SystemExit(f"{name}: the sequential decode step on the card is not the captured graph")
            token, state = prefill(spec.input_ids)
            # copies: the step rewrites the state's logits in place
            want, logits = [int(token[0])], [state["logits"][0].clone().float()]
            for _ in range(spec.max_new_tokens - 1):
                state, token = step(state)
                want.append(int(token[0]))
                logits.append(state["logits"][0].clone().float())
            SEQUENTIAL[key] = want, torch.stack(logits)
            del prefill, step, state
        want, logits = SEQUENTIAL[key]
        got = served[spec.index]
        if not bool(torch.isfinite(logits).all()) or logits.shape != (spec.max_new_tokens, model.config.vocab_size):
            raise SystemExit(f"{name} request {spec.index}: sequential logits not finite or of the wrong shape")
        top2 = torch.topk(logits, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        tie = next((t for t, g in enumerate(gaps) if g < near_tie), len(gaps))
        first_diff = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if len(got) != len(want) or (first_diff is not None and first_diff < tie):
            raise SystemExit(f"{name} request {spec.index}: engine stream diverges at step {first_diff} before the "
                             f"first near tie at step {tie}: engine {got} sequential {want}")
        agreed.append(len(got) if first_diff is None else first_diff)
        note = "identical" if first_diff is None else f"diverges at step {first_diff}, after the near tie at {tie}"
        log(f"stream {name} request={spec.index} tokens={len(got)} first_near_tie={tie} "
            f"min_top2_gap={min(gaps):.3e} {note}")
    return agreed


def serve_phase(card: str) -> dict:
    """The serve through the captured paged step (the main path), then the
    same requests through the eager step; their streams must be equal token
    for token, and each equal to the sequential stream up to its first near
    tie. Returns the main serve's launches."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    config = CausalLanguageModelConfig(**FLAGSHIP)
    model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: flagship CLM {FLAGSHIP}, {n_params} parameters, f32")
    specs = serve_specs()
    engine, warm_up = serve_engine(model, graphed=True)
    n_sa = FLAGSHIP["num_self_attention_layers"]
    check_graph("serve", engine._step_fn.captured.graph, warm_up, {"paged_decode": 1 + n_sa, "flash_packed_fwd": 0})
    run = serve_run(engine, specs, record_lengths=True)
    check_serve("serve", engine, run)
    lengths = torch.stack(run["lengths"]).reshape(-1, SERVE_SLOTS)
    log(f"serve paged_decode calls with a length-0 slot: {int((lengths == 0).any(dim=1).sum())} of "
        f"{lengths.shape[0]} (slots at length 0 over all calls: {int((lengths == 0).sum())})")
    for r in run["records"]:
        log(f"ttft request={r.index} prompt_len={r.prompt_len} ttft_ms={1e3 * r.ttft_s:.3f} card={card}")
    log(f"serve: {N_REQUESTS} requests, {run['decoded']} decoded tokens, wall_s={run['wall_s']:.3f}, "
        f"prefill_s={run['prefill_s']:.3f}, decode_tok_s={run['decode_tok_s']:.1f}, "
        f"mean_batch_fill={engine.mean_batch_fill:.3f}, decode_steps={run['steps']}, step=graph, card={card}")
    served = dict(engine.served_tokens)
    del engine

    eager_engine, _ = serve_engine(model, graphed=False)
    eager = serve_run(eager_engine, specs)
    check_serve("serve_eager", eager_engine, eager)
    log(f"serve_eager: {N_REQUESTS} requests, {eager['decoded']} decoded tokens, wall_s={eager['wall_s']:.3f}, "
        f"prefill_s={eager['prefill_s']:.3f}, decode_tok_s={eager['decode_tok_s']:.1f}, "
        f"decode_steps={eager['steps']}, step=eager, card={card}")
    differ = [i for i in served if served[i] != eager_engine.served_tokens[i]]
    if differ or eager["steps"] != run["steps"] or run["steps"] < 64:
        raise SystemExit(f"serve: the graph's streams differ from the eager step's in requests {differ} "
                         f"(decode steps {run['steps']} graph, {eager['steps']} eager; at least 64 wanted)")
    log(f"serve graph against eager: {run['steps']} decode steps of {SERVE_SLOTS} slots, every stream identical")
    TIMES["decode_tok_s"] = {"graph": run["decode_tok_s"], "eager": eager["decode_tok_s"]}
    del eager_engine

    check_streams("serve", model, specs, served, NEAR_TIE)
    for graphed in (True, False):
        profile_phase(model, card, graphed)
    return run["launches"]


def serve_bf16_phase(card: str) -> dict:
    """serve's configuration with bf16 compute and bf16 page pools (the JAX
    package's ``dtype=jnp.bfloat16`` with ``cache_dtype=jnp.bfloat16``)
    through the captured decode step: its graph's nodes, K3's bf16 build 9
    times a decode step and no f32 build anywhere, TTFT and decode tok/s;
    every stream equal to the sequential bf16 ``make_decode_fns`` stream
    (bf16 caches) up to its first top-2 gap under ``NEAR_TIE_BF16``. Returns
    the serve's launches."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    bf16 = torch.bfloat16
    config = CausalLanguageModelConfig(**FLAGSHIP)
    model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED), dtype=bf16)
    log(f"model: flagship CLM {FLAGSHIP}, f32 parameters, bf16 compute, bf16 page pools")
    specs = serve_specs()
    engine, warm_up = serve_engine(model, graphed=True, cache_dtype=bf16)
    if any(pool.k.dtype != bf16 for pool in engine._state["cache"]):
        raise SystemExit("serve_bf16: the engine's page pools are not bf16")
    n_sa = FLAGSHIP["num_self_attention_layers"]
    check_graph("serve_bf16", engine._step_fn.captured.graph, warm_up,
                {"paged_decode" + BF16: 1 + n_sa, "paged_decode": 0, "flash_packed_fwd" + BF16: 0})
    run = serve_run(engine, specs)
    check_serve("serve_bf16", engine, run, BF16)
    for r in run["records"]:
        log(f"ttft_bf16 request={r.index} prompt_len={r.prompt_len} ttft_ms={1e3 * r.ttft_s:.3f} card={card}")
    log(f"serve_bf16: {N_REQUESTS} requests, {run['decoded']} decoded tokens, wall_s={run['wall_s']:.3f}, "
        f"prefill_s={run['prefill_s']:.3f}, decode_tok_s={run['decode_tok_s']:.1f}, "
        f"mean_batch_fill={engine.mean_batch_fill:.3f}, decode_steps={run['steps']}, step=graph, card={card}")
    TIMES["serve_bf16"] = {"decode_tok_s": run["decode_tok_s"], "ttft_ms": [1e3 * r.ttft_s for r in run["records"]],
                           "k3_graph_nodes": GRAPH_NODES["serve_bf16"]["nodes"]["paged_walk_kernel"],
                           "pools_bytes": pool_bytes(engine._state["cache"])}
    served = dict(engine.served_tokens)
    del engine
    TIMES["serve_bf16"]["tokens_equal_to_sequential"] = check_streams("serve_bf16", model, specs, served,
                                                                      NEAR_TIE_BF16, bf16)
    return run["launches"]


def pool_bytes(caches) -> int:
    """The bytes of a tuple of caches' buffers (rows and, int8, scales)."""
    return sum(buf.numel() * buf.element_size() for c in caches for buf in c.buffers())


def serve_int8_bf16_phase(card: str, bf16_run: dict) -> dict:
    """serve_bf16's model, ``EngineConfig`` and six requests on int8 page
    pools (a), and on int8 pools with int8 weights (b): K3 never launches
    (int8 pools take the gather route, as in JAX), the step captures once, K2
    and K1 run in bf16, the books close, and every stream equals the int8
    sequential pair's (``make_decode_fns`` with the same stores) up to its
    first top-2 gap under ``NEAR_TIE_BF16``. Reports decode tok/s, TTFT and
    the pools' bytes beside serve_bf16's (``bf16_run``), and the pools'
    ratio against its arithmetic, ``(C + 2) / (2 C)`` (a row of C int8
    channels and one bf16 scale, against C bf16 channels). Returns (a)'s
    launches."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    bf16, int8 = torch.bfloat16, torch.int8
    model = CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda",
                                generator=torch.Generator().manual_seed(SEED), dtype=bf16)
    specs = serve_specs()
    c = FLAGSHIP["num_channels"]
    report = {"card": card, "bf16": {k: bf16_run[k] for k in ("decode_tok_s", "ttft_ms", "pools_bytes")},
              "ratio_arithmetic": (c + 2) / (2 * c)}
    main_launches = None
    for part, weight_dtype in (("a int8 cache", None), ("b int8 cache + weights", int8)):
        engine, warm_up = serve_engine(model, graphed=True, cache_dtype=int8, weight_dtype=weight_dtype)
        pools = engine._state["cache"]
        if not all(pool.quantized and pool.k.dtype == int8 for pool in pools):
            raise SystemExit(f"serve_int8_bf16 {part}: the engine's pools are not int8")
        graph_name = "serve_int8_bf16" + ("_w8" if weight_dtype else "")
        check_graph(graph_name, engine._step_fn.captured.graph, warm_up,
                    {"paged_decode" + BF16: 0, "paged_decode": 0, "flash_packed_fwd" + BF16: 0})
        run = serve_run(engine, specs)
        launches, books = run["launches"], engine.books()
        captures = engine._step_fn.captured.captures
        log(f"serve_int8_bf16 {part} launches: {json.dumps(launches)} captures={captures}")
        if launches["paged_decode"] or launches["paged_decode" + BF16] or any(launches[k] for k in SERVE_KERNELS):
            raise SystemExit(f"serve_int8_bf16 {part}: K3 (or an f32 build) launched over int8 pools: {launches}")
        if not launches["flash_packed_fwd" + BF16] or not launches["layer_norm_fwd" + BF16]:
            raise SystemExit(f"serve_int8_bf16 {part}: K2 or K1 (bf16) never launched: {launches}")
        if captures != 1 or not books["balanced"] or books["ok"] != N_REQUESTS:
            raise SystemExit(f"serve_int8_bf16 {part}: captures {captures}, books {books}")
        if engine.ca_alloc.pages_used or engine.sa_alloc.pages_used:
            raise SystemExit(f"serve_int8_bf16 {part}: pages not returned")
        n_bytes = pool_bytes(pools)
        served = dict(engine.served_tokens)
        report[part] = {"decode_tok_s": run["decode_tok_s"], "ttft_ms": [1e3 * r.ttft_s for r in run["records"]],
                        "steps": run["steps"], "captures": captures, "k3_launches": 0, "pools_bytes": n_bytes,
                        "pools_vs_bf16": n_bytes / bf16_run["pools_bytes"],
                        "vs_bf16_decode_tok_s": run["decode_tok_s"] / bf16_run["decode_tok_s"]}
        if main_launches is None:
            main_launches = launches
        del engine, pools
        report[part]["tokens_equal_to_sequential"] = check_streams(
            f"serve_int8_bf16 {part}", model, specs, served, NEAR_TIE_BF16, int8, weight_dtype)
        free_card()
    ratio = report["a int8 cache"]["pools_vs_bf16"]
    log("serve_int8_bf16: " + json.dumps(report))
    if abs(ratio - report["ratio_arithmetic"]) > 1e-12:
        raise SystemExit(f"serve_int8_bf16: pools take {ratio} of bf16's bytes, not {report['ratio_arithmetic']}")
    TIMES["serve_int8_bf16"] = report
    del model
    return main_launches


# decode_int8_bf16: bench.py's three int8 decode geometries (batch, cache
# dtype, weight dtype), each beside the bf16 pair at its batch
DECODE_INT8 = {"b1_int8w": (1, torch.bfloat16, torch.int8), "b8_int8": (8, torch.int8, None),
               "b8_int8_full": (8, torch.int8, torch.int8)}
# decode_int8_bf16's bound on the int8 pair's logits, teacher-forced on the
# bf16 pair's tokens: max |int8 - bf16| over every step's logits, relative to
# the bf16 logits' largest magnitude. Stated before the first card run from
# tests/test_torch_int8.py::test_int8_decode_logits_stay_near_the_bf16_pair:
# the CPU's worst relative error there (1.3e-2, int8 weights) times 4
DECODE_INT8_REL_BOUND = 0.05


def decode_int8_bf16_phase(card: str) -> dict:
    """``generate`` at bench.py's int8 decode geometries (``DECODE_INT8``: a
    16384-token prompt, the full window, with all 1024 latents, and 128
    greedy new tokens on the bf16 flagship), each beside the bf16 pair (bf16 caches, float weights)
    at the same batch: decode tok/s of both over the 126 steps after the
    first (the captured step's replays), the weights' and the caches' bytes,
    the int8 pair's captured step against its eager body (teacher-forced on
    the bf16 pair's tokens: every step's logits bit for bit), and the int8
    logits against the bf16 pair's on the same tokens within
    ``DECODE_INT8_REL_BOUND``. Returns the last geometry's launches."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.quant import quantized_linears

    bf16 = torch.bfloat16
    new = DECODE_NEW_TOKENS
    config = generation.GenerationConfig(max_new_tokens=new)
    model = CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda", dtype=bf16,
                                generator=torch.Generator().manual_seed(SEED))
    linears = quantized_linears(model)
    weights = {"bf16": sum(2 * m.weight.numel() for m in linears.values()),
               "int8": sum(m.weight.numel() + 4 * m.weight.shape[0] for m in linears.values())}
    report = {"card": card, "prompt_len": FLAGSHIP["max_seq_len"], "new_tokens": new, "weights_bytes": weights,
              "rel_bound": DECODE_INT8_REL_BOUND}
    launches = None

    def pair_run(ids, cache_dtype, weight_dtype, forced=None, eager=False):
        """The pair over ``ids``: tokens, every step's logits and the steady
        tok/s; ``forced`` feeds the given tokens (B, new) in place of the
        sampled ones."""
        prefill, step = generation.make_decode_fns(model, FLAGSHIP["max_latents"], config, cache_dtype, weight_dtype,
                                                   device="cuda")
        if eager:
            body = generation._eager_step(model, config, model.device, step.body.body)
            step = lambda st: (lambda out: (out[0], out[1].clone()))(body(st))  # noqa: E731
        token, state = prefill(ids)
        tokens, logits = [token], [state["logits"].clone()]
        cache_bytes = pool_bytes(state["cache"])
        torch.cuda.synchronize()
        t0 = None
        for i in range(new - 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if forced is not None:
                state["token"].copy_(forced[:, i])
            state, token = step(state)
            tokens.append(token)
            logits.append(state["logits"].clone())
        torch.cuda.synchronize()
        tok_s = ids.shape[0] * (new - 2) / (time.perf_counter() - t0)
        graphed = isinstance(getattr(step, "body", None), generation._GraphedStep)
        del prefill, step, state
        return torch.stack(tokens, dim=1), torch.stack(logits, dim=1).float(), tok_s, cache_bytes, graphed

    for name, (batch, cache_dtype, weight_dtype) in DECODE_INT8.items():
        ids = np.random.default_rng(SEED + 6).integers(0, FLAGSHIP["vocab_size"], size=(batch, FLAGSHIP["max_seq_len"]))
        ref_tokens, ref_logits, ref_tok_s, ref_bytes, _ = pair_run(ids, bf16, None)
        build.reset_launches()
        out = generation.generate(model, ids, FLAGSHIP["max_latents"], config=config, cache_dtype=cache_dtype,
                                  weight_dtype=weight_dtype, device="cuda")
        launches = nonzero_launches()
        stream = out[:, FLAGSHIP["max_seq_len"]:]
        g_tokens, g_logits, tok_s, cache_bytes, graphed = pair_run(ids, cache_dtype, weight_dtype, ref_tokens)
        e_tokens, e_logits, _, _, _ = pair_run(ids, cache_dtype, weight_dtype, ref_tokens, eager=True)
        bit_for_bit = torch.equal(g_logits, e_logits) and torch.equal(g_tokens, e_tokens)
        rel = rel_diff(g_logits, ref_logits)
        row = {"batch": batch, "cache_dtype": str(cache_dtype)[6:], "weight_dtype": str(weight_dtype)[6:]
               if weight_dtype else "bf16 (float)", "tok_s": tok_s, "bf16_tok_s": ref_tok_s,
               "vs_bf16_tok_s": tok_s / ref_tok_s, "cache_bytes": cache_bytes, "bf16_cache_bytes": ref_bytes,
               "graph_equals_eager_bit_for_bit": bit_for_bit, "graphed": graphed,
               "logits_rel_err_vs_bf16": rel,
               "last_token_rel_err_vs_bf16": rel_diff(g_logits[:, -1], ref_logits[:, -1]),
               "generate_tokens_equal_bf16_stream": int((stream.cpu() == ref_tokens.cpu()).all(dim=0).cumprod(0).sum()),
               "launches": launches}
        log(f"decode_int8_bf16 {name}: " + json.dumps(row))
        report[name] = row
        in_vocab = bool(((stream >= 0) & (stream < FLAGSHIP["vocab_size"])).all())
        finite = bool(torch.isfinite(g_logits).all()) and in_vocab
        if not (bit_for_bit and graphed and finite) or not within(rel, DECODE_INT8_REL_BOUND):
            raise SystemExit(f"decode_int8_bf16 {name}: graph against eager {bit_for_bit} (graphed {graphed}), "
                             f"finite {finite}, logits {rel} of bf16's (bound {DECODE_INT8_REL_BOUND})")
        if launches.get("paged_decode", 0) or launches.get("paged_decode" + BF16, 0):
            raise SystemExit(f"decode_int8_bf16 {name}: K3 launched on the contiguous pair: {launches}")
        del ref_logits, g_logits, e_logits
        free_card()
    TIMES["decode_int8_bf16"] = report
    del model
    return launches


# ---------------------------------------------------------------------------
# serve_admission_bf16: the admission tier around the captured paged step
# ---------------------------------------------------------------------------


def admission_specs(request_spec, vocab: int, prompts: tuple, budgets: tuple, max_ca_tokens: int) -> list:
    """The fault plan's 16 greedy requests from the seed: prompts and budgets
    drawn in the ranges given, and request 4 one whose prompt alone fills
    ``max_ca_tokens`` (it can never fit). ``request_spec`` is the
    ``RequestSpec`` class of the package that serves them (the CPU test
    holds the JAX package's engine to the same plan)."""
    rng = np.random.default_rng(SEED + 2)
    specs = []
    for i in range(16):
        n = max_ca_tokens if i == 4 else int(rng.integers(prompts[0], prompts[1] + 1))
        specs.append(request_spec(index=i, prompt_len=n, max_new_tokens=int(rng.integers(budgets[0], budgets[1] + 1)),
                                  input_ids=rng.integers(0, vocab, size=(1, n)), rng_seed=i))
    return specs


def admission_config(serving, retry_policy):
    """The plan's admission policy: 4 queued at most, 1 s of projected
    service a queued request, a breaker over a window of 4 that opens at an
    error rate of 0.6 and probes 1 s after its first open (no jitter)."""
    return serving.FrontEndConfig(max_queue=4, est_service_s=1.0, breaker=serving.BreakerConfig(
        window=4, min_requests=2, error_rate_to_open=0.6, probe_backoff=retry_policy(base_delay=1.0, jitter=0.0)))


def admission_faults(injector):
    """The plan's injected faults: a kill after token 3 of request 0, one
    prefill failure of request 1, a 10 s stall at token 2 of request 2, kills
    after token 1 of requests 7 and 8, and NaN weights for request 11."""
    return (injector.kill_at(0, 3).fail_prefill(1).stall_at(2, 2, 10.0).kill_at(7, 1).kill_at(8, 1)
            .poison_at(ADMISSION_POISONED))


def admission_drive(fe, specs, clock, guard) -> None:
    """Drive an engine front end through the plan under its ``ManualClock``;
    it books ``ADMISSION_OUTCOMES``. ``guard`` is a ``PreemptionGuard`` of the
    front end's package, tripped by hand.

    1. Requests 0-2 queue (2 with a 5 s deadline); 3 (2 s deadline, 3 s of
       projected wait) sheds deadline_unmeetable, 4 kv_pages_exhausted; 5
       queues and 6 finds 4 queued: queue_full. One fill and step, then 5,
       live in its slot, is cancelled: at the next step 2's stall moves the
       clock past its deadline (timeout), 5 retires cancelled, and at the
       third 0 is killed. 1's prefill failed at the join (error). The
       breaker's window, error ok ok error, stays under 0.6.
    2. Requests 7 and 8 are killed after their first decoded token: the
       window reaches 0.75 and the breaker opens; 9 sheds breaker_open; 1 s
       later 10 is the half-open probe, and its ok closes the breaker.
    3. Request 11's prefill runs on NaN weights beside the clean 12.
    4. Requests 13 and 14 are decoding when the guard trips: the drain
       finishes them, 15 sheds draining, and ``drain`` books the end.
    """
    for i in (0, 1):
        fe.submit(specs[i])
    fe.submit(specs[2], deadline_s=5.0)
    for i, deadline_s in ((3, 2.0), (4, None), (5, None), (6, None)):
        fe.submit(specs[i], deadline_s=deadline_s)
    fe._fill_slots()
    fe._engine_step()
    fe.cancel(5)
    fe.pump()
    for i in (7, 8):
        fe.submit(specs[i])
    fe.pump()
    fe.submit(specs[9])
    clock.advance(1.0)
    fe.submit(specs[10])
    fe.pump()
    for i in (11, 12):
        fe.submit(specs[i])
    fe.pump()
    for i in (13, 14):
        fe.submit(specs[i])
    fe._fill_slots()
    fe._engine_step()
    fe._guard = guard
    guard.trip()
    fe.pump()
    fe.submit(specs[15])
    fe.drain()


def check_admission_books(name: str, fe) -> None:
    """The plan's books: each request's outcome and shed reason, the
    per-outcome counts, a clean audit."""
    got = {r.index: r.outcome for r in fe.records}
    sheds = {r.index: r.shed_reason for r in fe.records if r.outcome == "shed"}
    books = fe.books()
    want = collections.Counter(ADMISSION_OUTCOMES.values())
    problems = fe.audit()
    if got != ADMISSION_OUTCOMES or sheds != ADMISSION_SHEDS or problems or books["parked"] or any(
            books[o] != want[o] for o in ("ok", "error", "timeout", "shed", "cancelled")) or books["submitted"] != 16:
        raise SystemExit(f"{name}: the plan booked {got}, sheds {sheds}, books {books}, audit {problems}; "
                         f"planned {ADMISSION_OUTCOMES}, sheds {ADMISSION_SHEDS}")


def timed_steps(engine) -> dict:
    """Time every engine step of ``engine`` from now on: ``step`` the decode
    step's call and the card's work (synchronized, so the token fetch that
    follows waits for nothing), ``engine_step`` the whole of ``_engine_step``;
    their difference is the host's bookkeeping (seams, histograms, retires,
    events, gauges)."""
    t = {"step": 0.0, "engine_step": 0.0}
    step_fn, engine_step = engine._step_fn, engine._engine_step

    def step(state):
        t0 = time.perf_counter()
        out = step_fn(state)
        torch.cuda.synchronize()
        t["step"] += time.perf_counter() - t0
        return out

    def timed_engine_step():
        t0 = time.perf_counter()
        engine_step()
        t["engine_step"] += time.perf_counter() - t0

    engine._step_fn, engine._engine_step = step, timed_engine_step
    return t


def serve_admission_bf16_phase(card: str) -> dict:
    """serve_bf16's model (flagship width, bf16 compute, f32 parameters, bf16
    pools) behind the admission tier.

    Part 1, the fault plan (``admission_drive``) under a ``ManualClock`` with
    an ``EventLog`` and a ``FaultInjector``, each check fatal: the books and
    every outcome as planned with a clean audit; ``validate_events`` clean,
    one ``request`` row a submission, one open, probe, close cycle of
    ``serve.breaker`` rows, a ``serve.drain`` row; every ok stream (but the
    poisoned one's) the sequential bf16 stream up to its first near tie,
    every cut-short stream a prefix of it; both page allocators empty and
    clean; the paged step captured once, K3's bf16 build 9 times an engine
    step and no f32 build; every parameter bit for bit as before the
    poisoned request; the K3 calls that saw a length-0 slot, logged.

    Part 2, the cost on the real clock: serve_specs() closed-loop through the
    front end with events, the registry and the breaker, and with
    ``events=None`` and no breaker, in turns (on, off, off, on): decode
    tok/s, ms an engine step, the host's bookkeeping ms a step. Then
    ``run_open`` of serve_specs() twice over (12 requests) at twice the
    closed loop's request rate with ``max_queue=2`` and a deadline of the
    closed loop's wall time: the achieved rate, the sheds by reason, TTFT
    p50/p99 from ``generate_ttft_s``, a clean audit. Returns part 1's
    launches."""
    import tempfile

    from perceiver_io_tpu_torch import serving
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.training.faults import PreemptionGuard, RetryPolicy

    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    model = CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda",
                                generator=torch.Generator().manual_seed(SEED), dtype=bf16)
    n_sa = FLAGSHIP["num_self_attention_layers"]
    specs = admission_specs(serving.RequestSpec, FLAGSHIP["vocab_size"], ADMISSION_PROMPTS, ADMISSION_BUDGETS, 16384)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as out:
        clock = serving.ManualClock()
        engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16, config=admission_config(serving, RetryPolicy),
                                 events=EventLog(out, main_process=True), clock=clock, sleep=clock.sleep,
                                 injector=admission_faults(serving.FaultInjector(clock=clock)))
        lengths = []
        step_fn = engine._step_fn

        def recorded(state):
            result = step_fn(state)
            lengths.append(torch.stack([pool.length for pool in state["cache"]]))
            return result

        engine._step_fn = recorded
        build.reset_launches()
        t0 = time.perf_counter()
        admission_drive(engine, specs, clock, PreemptionGuard())
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        check_admission_books("serve_admission_bf16", engine)
        rows = merged_events(out)
        problems = validate_events(out, warnings_out=[])
    kinds = collections.Counter(e["event"] for e in rows)
    if problems or kinds["request"] != 16 or kinds["serve.drain"] != 1:
        raise SystemExit(f"serve_admission_bf16: event stream wrong: {dict(kinds)}, problems {problems[:5]}")
    breaker = [(e["prev"], e["state"]) for e in rows if e["event"] == "serve.breaker"]
    if breaker != [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]:
        raise SystemExit(f"serve_admission_bf16: breaker transitions {breaker}, not one open-probe-close cycle")
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    if changed:
        raise SystemExit(f"serve_admission_bf16: parameters changed by the poisoned request: {changed[:5]}")
    del before
    used = (engine.ca_alloc.pages_used, engine.sa_alloc.pages_used)
    if used != (0, 0) or engine.ca_alloc.audit() + engine.sa_alloc.audit():
        raise SystemExit(f"serve_admission_bf16: page allocators not returned: used={used}")
    steps, captures = engine._engine_steps, step_fn.captured.captures
    k3 = launches.get("paged_decode" + BF16, 0)
    f32 = {k: n for k, n in launches.items() if n and not k.endswith(BF16)}
    log(f"serve_admission_bf16 launches: {json.dumps({k: n for k, n in launches.items() if n})}")
    if captures != 1 or k3 != (1 + n_sa) * steps or f32:
        raise SystemExit(f"serve_admission_bf16: captures={captures} (1 wanted), paged_decode{BF16}={k3} in {steps} "
                         f"engine steps ({1 + n_sa} a step wanted), f32 builds {f32}")
    lengths = torch.stack(lengths).reshape(-1, SERVE_SLOTS)
    zero_calls = int((lengths == 0).any(dim=1).sum())
    log(f"serve_admission_bf16 paged_decode calls with a length-0 slot: {zero_calls} of {lengths.shape[0]} "
        f"(slots at length 0 over all calls: {int((lengths == 0).sum())})")
    served = dict(engine.served_tokens)
    outcomes = {r.index: [r.outcome, r.tokens_out] for r in engine.records}
    del engine
    # every ok stream whole, every cut-short stream as a prefix (the
    # sequential stream of its length is the prefix of the whole one)
    compared = [dataclasses.replace(spec, max_new_tokens=len(served[spec.index])) for spec in specs
                if spec.index != ADMISSION_POISONED and served.get(spec.index)]
    agreed = check_streams("serve_admission_bf16", model, compared, served, NEAR_TIE_BF16, bf16)
    log("serve_admission_bf16 part 1: " + json.dumps({
        "card": card, "outcomes": outcomes, "engine_steps": steps, "captures": captures, "k3_bf16_launches": k3,
        "k3_calls_with_a_length_0_slot": zero_calls, "k3_calls": int(lengths.shape[0]), "plan_s": plan_s,
        "event_kinds": dict(kinds), "tokens_equal_to_sequential": dict(zip([s.index for s in compared], agreed))}))

    # part 2: the admission tier's cost on the real clock
    closed = collections.defaultdict(list)
    for label in ("frontend", "bare", "bare", "frontend"):
        with tempfile.TemporaryDirectory() as out:
            kw = ({"events": EventLog(out, main_process=True)} if label == "frontend"
                  else {"events": None, "config": serving.FrontEndConfig(breaker=None)})
            engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16, **kw)
            t = timed_steps(engine)
            run = serve_run(engine, serve_specs())
            check_serve(f"serve_admission_bf16 {label}", engine, run, BF16)
            steps = run["steps"]
            closed[label].append({
                "decode_tok_s": run["decode_tok_s"], "wall_s": run["wall_s"], "prefill_s": run["prefill_s"],
                "engine_steps": steps, "ms_per_engine_step": 1e3 * t["engine_step"] / steps,
                "step_ms": 1e3 * t["step"] / steps,
                "host_bookkeeping_ms_per_step": 1e3 * (t["engine_step"] - t["step"]) / steps,
                "request_rows": sum(e["event"] == "request" for e in merged_events(out)) if kw["events"] else 0})
            del engine
    log("serve_admission_bf16 part 2 closed loop, events on and off: " + json.dumps({"card": card, **closed}))
    wall_s = statistics.mean(r["wall_s"] for r in closed["frontend"])
    rate, deadline_s = 2 * N_REQUESTS / wall_s, wall_s
    with tempfile.TemporaryDirectory() as out:
        engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16, events=EventLog(out, main_process=True),
                                 config=serving.FrontEndConfig(max_queue=2))
        open_specs = [dataclasses.replace(spec, index=spec.index + N_REQUESTS * k)
                      for k in range(2) for spec in serve_specs()]
        t0 = time.perf_counter()
        records = engine.run_open(open_specs, rate_rps=rate, deadline_s=deadline_s, seed=SEED)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        problems = engine.audit() + validate_events(out, warnings_out=[])
        ttft = engine.registry.histogram("generate_ttft_s")
        report = {"card": card, "requests": len(open_specs), "offered_rps": rate, "deadline_s": deadline_s,
                  "wall_s": wall_s, "achieved_rps": len(records) / wall_s,
                  "served_rps": sum(r.outcome == "ok" for r in records) / wall_s,
                  "outcomes": dict(collections.Counter(r.outcome for r in records)),
                  "sheds": dict(collections.Counter(r.shed_reason for r in records if r.outcome == "shed")),
                  "ttft_p50_s": ttft.percentile(50), "ttft_p99_s": ttft.percentile(99),
                  "errors": sorted({r.error for r in records if r.error}),
                  "max_queue_depth": engine.books()["max_queue_depth"], "audit": problems}
        del engine
    log("serve_admission_bf16 part 2 open loop: " + json.dumps(report))
    if problems or len(records) != len(open_specs) or report["errors"]:
        raise SystemExit(f"serve_admission_bf16: the open loop's books or events are wrong: {problems[:5]}")
    TIMES["serve_admission_bf16"] = {"closed": closed, "open": report, "phase_s": time.perf_counter() - t_phase}
    log(f"serve_admission_bf16: {time.perf_counter() - t_phase:.1f} s, card={card}")
    return launches


# ---------------------------------------------------------------------------
# serve_share_evict_bf16: prefix sharing, eviction and journal recovery
# ---------------------------------------------------------------------------


def drawn_specs(request_spec, n: int, prompts: tuple, budgets: tuple, seed: int, doc: int = 0) -> list:
    """``n`` greedy requests from ``seed``: prompts of ``prompts[0]`` to
    ``prompts[1]`` tokens (after a shared document of ``doc`` tokens, when
    given) and budgets in ``budgets``."""
    rng = np.random.default_rng(seed)
    vocab = FLAGSHIP["vocab_size"]
    shared = rng.integers(0, vocab, size=doc)
    specs = []
    for i in range(n):
        ids = np.concatenate([shared, rng.integers(0, vocab, size=int(rng.integers(prompts[0], prompts[1] + 1)))])
        specs.append(request_spec(index=i, prompt_len=len(ids), max_new_tokens=int(rng.integers(budgets[0],
                                                                                               budgets[1] + 1)),
                                  input_ids=ids[None], rng_seed=int(rng.integers(1 << 30))))
    return specs


def count_prefills(engine) -> list:
    """Record, for every prefill the engine runs from now on, its kind
    (``join``, ``shared`` or ``replay``, a resume's), the launches of K2's
    bf16 build it made and its time (synchronized) in ms."""
    from perceiver_io_tpu_torch.ops import build

    calls = []
    k2 = "flash_packed_fwd" + BF16

    def counted(fn, kind):
        def call(*args, **kwargs):
            before = build.LAUNCHES[k2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append((kind, build.LAUNCHES[k2] - before, 1e3 * (time.perf_counter() - t0)))
            return out
        return call

    shared_for, prefill_for = engine._shared_prefill_for, engine._prefill_for
    engine._shared_prefill_for = lambda *a: counted(shared_for(*a), "shared")
    engine._prefill_for = lambda max_new, num_latents=None: counted(
        prefill_for(max_new, num_latents), "join" if num_latents in (None, NUM_LATENTS) else "replay")
    return calls


def count_dense(counter: list):
    """A context in which every call of the attention's dense path on a card
    tensor adds one to ``counter[0]``."""
    import contextlib

    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention

    @contextlib.contextmanager
    def scope():
        dense = MultiHeadAttention._dense

        def counted(self, q, *args, **kwargs):
            counter[0] += int(q.is_cuda)
            return dense(self, q, *args, **kwargs)

        MultiHeadAttention._dense = counted
        try:
            yield
        finally:
            MultiHeadAttention._dense = dense

    return scope()


def check_prefills(name: str, calls: list, want: dict, per_call: int) -> dict:
    """Every prefill of ``calls`` launched K2's bf16 build ``per_call``
    times (the CA and each SA layer), and the kinds were counted as ``want``
    says. Returns the ms of each kind's calls."""
    kinds = collections.Counter(kind for kind, _, _ in calls)
    wrong = [(kind, n) for kind, n, _ in calls if n != per_call]
    if dict(kinds) != want or wrong:
        raise SystemExit(f"{name}: prefills {dict(kinds)} (wanted {want}); K2 bf16 launches off {per_call} a "
                         f"prefill: {wrong}")
    return {kind: [ms for k, _, ms in calls if k == kind] for kind in kinds}


def join_profile(model, specs, sharing: bool) -> dict:
    """Where one join's time goes: ``specs[1]`` joins an engine (bf16
    pools, ``prefix_sharing`` as given) that ``specs[0]`` joined first (its
    pages published when sharing), under ``torch.profiler``: the join's
    wall ms (the profiler's host cost included), its kernels' device-busy
    ms, the top kernels, and the host ms of the prefix index's work: the
    prompt's chunk hashes, the match (its hashes and any deferred insert it
    settles included) and the publish."""
    from torch.profiler import ProfilerActivity, profile

    engine, _ = serve_engine(model, graphed=True, cache_dtype=torch.bfloat16, engine={"prefix_sharing": sharing})
    host = collections.defaultdict(float)
    for name in ("_context_keys", "_match_prefix", "_publish_prefix"):
        def timed(*args, fn=getattr(engine, name), name=name, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host[name] += 1e3 * (time.perf_counter() - t0)
            return out
        setattr(engine, name, timed)
    engine.submit(specs[0])
    engine._fill_slots()
    engine.submit(specs[1])
    host.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._fill_slots()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    summary = profile_summary(prof, wall_ms)
    out = {"hits": engine._n_prefix_hits, "wall_ms": wall_ms, "device_busy_ms": summary["device_busy_ms"],
           "device_union_ms": summary["device_union_ms"], "top_device_ms": summary["top_device_ms"][:6],
           "hash_ms": host["_context_keys"], "match_ms": host["_match_prefix"], "publish_ms": host["_publish_prefix"]}
    del engine
    free_card()
    return out


def serve_share_evict_bf16_phase(card: str) -> dict:
    """serve_bf16's model and engine geometry (flagship width, bf16 compute
    and pools) with prefix sharing, eviction and journal recovery, each
    check fatal. No call of the attention's dense path may run on the card
    while an engine serves (the shared prefills and the replays take K2).

    Part 1, sharing: six greedy requests, one seeded 12288-token document
    then distinct suffixes of 1024-3072 tokens: five prefix hits of 768
    pages (``serve.prefix_hit`` rows), every shared prefill (and the one
    unshared join) launching K2 bf16 9 times, K3 bf16 9 times a step, a
    clean ``sharing_audit()`` every 8 steps and at drain with the index
    empty and the pools returned; every stream the sequential bf16 stream up
    to its first near tie. The same requests through a ``prefix_sharing=
    False`` engine: TTFT request by request beside the shared engine's.
    Then one join of each kind under ``torch.profiler`` (``join_profile``).

    Part 2, eviction: eight requests of 4096-8192 tokens at pool headroom
    0.5: at least two evictions, as many resumes, every replay launching K2
    bf16 9 times, ``parked == 0`` and balanced books at drain, every stream
    the sequential one up to its first near tie; the replays' ms.

    Part 3, recovery: six requests under a ``ManualClock`` with a journal in
    a temporary directory, five engine steps, the engine dropped and the card
    freed; a fresh engine's ``recover(path)`` (then again at once: all
    skipped) and its drain; the journal's replayed streams the sequential
    ones up to the first near tie, its books and audit clean over both
    engines, a third ``recover`` after the drain a no-op. Returns part 1's
    shared serve's launches."""
    import os
    import tempfile

    from perceiver_io_tpu_torch import serving
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events

    bf16, name = torch.bfloat16, "serve_share_evict_bf16"
    t_phase = time.perf_counter()
    model = CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda",
                                generator=torch.Generator().manual_seed(SEED), dtype=bf16)
    per_prefill = 1 + FLAGSHIP["num_self_attention_layers"]
    page = SERVE_GEOMETRY["page_size"]
    dense, report = [0], {"card": card}

    # part 1: sharing, then the same requests unshared
    specs = drawn_specs(serving.RequestSpec, N_REQUESTS, SHARE_SUFFIXES, SHARE_BUDGETS, SEED + 1, doc=SHARE_DOC)
    ttft, served = {}, {}
    for label, sharing in (("shared", True), ("unshared", False)):
        with tempfile.TemporaryDirectory() as out:
            engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16, engine={"prefix_sharing": sharing},
                                     events=EventLog(out, main_process=True))
            calls, audits, step = count_prefills(engine), [], engine._engine_step

            def audited(engine=engine, step=step, audits=audits):
                step()
                if engine._engine_steps % 8 == 0:
                    audits.append(engine.sharing_audit())

            engine._engine_step = audited
            with count_dense(dense):
                run = serve_run(engine, specs)
            rows, problems = merged_events(out), validate_events(out, warnings_out=[])
        check_serve(f"{name} part 1 {label}", engine, run, BF16)
        hits = [e["pages_matched"] for e in rows if e["event"] == "serve.prefix_hit"]
        ms = check_prefills(f"{name} part 1 {label}", calls, {"join": 1, "shared": 5} if sharing else {"join": 6},
                            per_prefill)
        audits.append(engine.sharing_audit())
        left = (engine.prefix_index.pages(), engine.ca_alloc._rc)
        if problems or hits != ([SHARE_DOC // page] * 5 if sharing else []) or any(audits) or left != ((), {}):
            raise SystemExit(f"{name} part 1 {label}: prefix hits {hits}, audits {[a for a in audits if a][:2]}, "
                             f"events {problems[:3]}, index and refcounts left {left}")
        if sharing:
            launches = run["launches"]
        ttft[label] = {r.index: 1e3 * r.ttft_s for r in run["records"]}
        served[label] = dict(engine.served_tokens)
        # the CA pool's high-water mark (the gauge is read after each fill
        # and step): what one resident copy of the document saves
        ca_peak = engine.registry.gauge("engine_kv_pages_frac").peak * engine.ca_alloc.num_allocatable
        report[f"part 1 {label}"] = {"decode_tok_s": run["decode_tok_s"], "steps": run["steps"],
                                     "prefill_ms": ms, "audits": len(audits), "ca_pages_peak": round(ca_peak)}
        del engine
        free_card()
    if dense[0]:
        raise SystemExit(f"{name} part 1: {dense[0]} dense attention calls on the card")
    report["part 1 ttft_ms"] = {i: {"prompt_len": s.prompt_len, "shared": ttft["shared"][s.index],
                                    "unshared": ttft["unshared"][s.index]} for i, s in enumerate(specs)}
    report["part 1 shared streams equal to unshared"] = [served["shared"][s.index] == served["unshared"][s.index]
                                                         for s in specs]
    report["part 1 tokens_equal_to_sequential"] = check_streams(f"{name} part 1", model, specs, served["shared"],
                                                                NEAR_TIE_BF16, bf16)
    report["part 1 join profile"] = {label: join_profile(model, specs, sharing)
                                     for label, sharing in (("shared", True), ("unshared", False))}
    if report["part 1 join profile"]["shared"]["hits"] != 1:
        raise SystemExit(f"{name} part 1: the profiled join did not share: {report['part 1 join profile']}")
    log(f"{name} part 1: " + json.dumps(report["part 1 ttft_ms"]) + f" card={card}")

    # part 2: eviction under page pressure
    specs = drawn_specs(serving.RequestSpec, EVICT_REQUESTS, EVICT_PROMPTS, EVICT_BUDGETS, SEED + 2)
    with tempfile.TemporaryDirectory() as out:
        engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16,
                                 engine={"eviction": True, "pool_headroom": EVICT_HEADROOM},
                                 events=EventLog(out, main_process=True))
        calls = count_prefills(engine)
        with count_dense(dense):
            run = serve_run(engine, specs, record_lengths=True)
        rows, problems = merged_events(out), validate_events(out, warnings_out=[])
    check_serve(f"{name} part 2", engine, run, BF16, n_ok=EVICT_REQUESTS)
    lengths = torch.stack(run["lengths"]).reshape(-1, SERVE_SLOTS)
    books = engine.books()
    evicted = [(e["request_index"], e["tokens_out"]) for e in rows if e["event"] == "serve.evict"]
    ms = check_prefills(f"{name} part 2", calls, {"join": EVICT_REQUESTS, "replay": books["resumes"]}, per_prefill)
    if (books["evictions"] < 2 or books["resumes"] != books["evictions"] or books["parked"] or problems
            or len(evicted) != books["evictions"] or engine.audit() or dense[0]):
        raise SystemExit(f"{name} part 2: books {books}, evict rows {evicted}, events {problems[:3]}, "
                         f"audit {engine.audit()}, dense calls {dense[0]}")
    served = dict(engine.served_tokens)
    del engine
    free_card()
    report["part 2"] = {"books": {k: books[k] for k in ("ok", "evictions", "resumes", "parked", "balanced")},
                        "evicted_at": evicted, "decode_tok_s": run["decode_tok_s"], "steps": run["steps"],
                        "prefill_ms": ms, "k3_calls": int(lengths.shape[0]),
                        "k3_calls_with_a_length_0_slot": int((lengths == 0).any(dim=1).sum()),
                        "tokens_equal_to_sequential": check_streams(f"{name} part 2", model, specs, served,
                                                                    NEAR_TIE_BF16, bf16)}

    # part 3: the engine dropped mid-decode, its journal recovered
    specs = drawn_specs(serving.RequestSpec, RECOVER_REQUESTS, RECOVER_PROMPTS, RECOVER_BUDGETS, SEED + 3)
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "journal.jsonl")
        clock = serving.ManualClock()
        engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16, journal=path, clock=clock,
                                 sleep=clock.sleep)
        for spec in specs:
            engine.submit(spec)
        with count_dense(dense):
            for _ in range(RECOVER_STEPS):
                engine._fill_slots()
                engine._engine_step()
        dead = engine.books()
        del engine
        free_card()
        t0 = time.perf_counter()
        fresh, _ = serve_engine(model, graphed=True, cache_dtype=bf16, clock=clock, sleep=clock.sleep)
        built_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with count_dense(dense):
            info = fresh.recover(path)
            again = fresh.recover(path)
            fresh.pump()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        after = fresh.recover(path)
        journal = serving.RequestJournal(path)
        jbooks, jaudit = journal.books(), journal.audit()
        replayed = {i: e.tokens for i, e in journal.replay().items()}
    books = fresh.books()
    owed = RECOVER_REQUESTS - dead["terminal"]
    if (info["recovered"] != owed or info["parked"] < 1 or again["recovered"] or again["skipped"] != owed
            or any(after.values()) or not jbooks["balanced"] or jbooks["pending"] or jaudit
            or jbooks["outcomes"] != {"ok": RECOVER_REQUESTS} or not books["balanced"] or books["parked"]
            or fresh.audit() or dense[0]):
        raise SystemExit(f"{name} part 3: dead engine {dead}, recover {info}, again {again}, after the drain "
                         f"{after}, journal {jbooks} {jaudit[:3]}, books {books}, dense calls {dense[0]}")
    del fresh
    report["part 3"] = {"dead_engine": {k: dead[k] for k in ("in_flight", "queued", "terminal")}, "recover": info,
                        "again": again, "after_drain": after, "journal": jbooks, "engine_build_s": built_s,
                        "recover_and_drain_s": recover_s,
                        "tokens_equal_to_sequential": check_streams(f"{name} part 3", model, specs, replayed,
                                                                    NEAR_TIE_BF16, bf16)}
    report["phase_s"] = time.perf_counter() - t_phase
    TIMES[name] = report
    log(f"{name}: " + json.dumps(report))
    return launches


# ---------------------------------------------------------------------------
# serve_spec_bf16 and beam_bf16: speculative decode and beam search
# ---------------------------------------------------------------------------


def spec_engine(model, **engine):
    """serve_bf16's engine in the speculative slot mode (``SPEC_K`` drafts a
    span from a ``SPEC_DEPTH``-layer self-drafter), its step captured at
    construction; ``engine`` overrides further fields. Returns the engine and
    the launches of its capture's warm-up step, and an event log directory
    it writes (the caller removes it)."""
    import tempfile

    from perceiver_io_tpu_torch.obs.events import EventLog

    out = tempfile.mkdtemp()
    engine, warm_up = serve_engine(model, graphed=True, cache_dtype=torch.bfloat16,
                                   engine=dict(spec_k=SPEC_K, spec_depth=SPEC_DEPTH, **engine),
                                   events=EventLog(out, main_process=True))
    return engine, warm_up, out


def check_spec_serve(name: str, engine, run: dict, dense: tuple, n_ok: int) -> dict:
    """A speculative serve's checks: K3's bf16 build exactly (k + 1)(1 +
    depth) times a step (the drafter's CA and SA pools at every drafter
    step) and no other K3 (none on the verify), K2 bf16 9 times a prefill,
    the verify's span attention on the gather route 9 times in each of the
    two runs of the step's body that built the engine (the warm-up and the
    capture; ``dense`` holds the dense path's card calls then, and during
    the serve, where only the graph runs: none), one capture, the books and
    audit clean, every page back and every pool's table row, the drafter's
    too, on the scratch page. Returns the request rows' acceptance
    numbers."""
    from perceiver_io_tpu_torch.obs.events import merged_events, validate_events

    launches, steps = run["launches"], run["steps"]
    per_step = (SPEC_K + 1) * (1 + SPEC_DEPTH)
    n_layers = 1 + FLAGSHIP["num_self_attention_layers"]
    books = engine.books()
    prefills = books["ok"] + books.get("resumes", 0)
    pools = engine._state["cache"] + engine._state["draft_cache"]
    problems = []
    if launches["paged_decode" + BF16] != per_step * steps or launches["paged_decode"]:
        problems.append(f"K3 launched {launches['paged_decode' + BF16]} (f32 {launches['paged_decode']}) times in "
                        f"{steps} steps, not {per_step} a step")
    if launches["flash_packed_fwd" + BF16] != n_layers * prefills:
        problems.append(f"K2 bf16 launched {launches['flash_packed_fwd' + BF16]} times for {prefills} prefills")
    if dense != (2 * n_layers, 0):
        problems.append(f"span attentions on the gather route (building, serving): {dense}, not {n_layers} in each "
                        "of the two runs of the body and none while the graph replays")
    if engine._step_fn.captured.captures != 1 or engine._tracker.total_compiles != 1:
        problems.append(f"{engine._step_fn.captured.captures} captures")
    if not books["balanced"] or books["ok"] != n_ok or books["parked"] or engine.audit():
        problems.append(f"books {books}, audit {engine.audit()[:3]}")
    if (engine.ca_alloc.pages_used, engine.sa_alloc.pages_used) != (0, 0) or any(
            int(p.page_table.abs().sum()) for p in pools):
        problems.append("pages not returned, or a table row off the scratch page")
    rows = [e for e in merged_events(engine._events_dir) if e["event"] == "request"]
    if validate_events(engine._events_dir, warnings_out=[]) or len(rows) != n_ok:
        problems.append(f"{len(rows)} request rows, or invalid events")
    if problems:
        raise SystemExit(f"{name}: " + "; ".join(problems))
    accept = [r["acceptance_rate"] for r in rows]
    per = [r["tokens_per_step"] for r in rows]
    return {"acceptance_rate": statistics.mean(accept), "acceptance_rate_by_request": accept,
            "tokens_per_step": statistics.mean(per), "tokens_per_step_by_request": per}


def verify_attend_ms(engine, model) -> dict:
    """The verify's span attention at the live pools (slots mid-decode), one
    call each: the contiguous views alone (``gather_view`` of the CA pool
    and of one SA pool), then ``_paged_span_attend`` (views, masks, scores,
    softmax, values and the output projection) on the CA pool and on one SA
    pool with the flagship's first layers, queries of the span's shape; the
    verify's whole share is the CA call and 8 SA calls."""
    state = engine._state
    ca, sa = state["cache"][0], state["cache"][1]
    q = torch.randn(SERVE_SLOTS, SPEC_K + 1, FLAGSHIP["num_channels"], device="cuda").to(torch.bfloat16)
    attn = {"ca": (model.cross_attention.cross_attn.attention, ca), "sa": (model.self_attention[0][0].module.attention,
                                                                           sa)}
    out = {"lengths_ca": ca.length.tolist(), "lengths_sa": sa.length.tolist()}
    for label, (mha, pool) in attn.items():
        out[f"gather_{label}_ms"] = time_ms(lambda pool=pool: pool.gather_view())
        out[f"attend_{label}_ms"] = time_ms(lambda mha=mha, pool=pool: mha._paged_span_attend(q, pool, None, None))
    n_sa = FLAGSHIP["num_self_attention_layers"]
    out["verify_gather_ms"] = out["gather_ca_ms"] + n_sa * out["gather_sa_ms"]
    out["verify_attend_ms"] = out["attend_ca_ms"] + n_sa * out["attend_sa_ms"]
    return out


def spec_profile(model, specs) -> dict:
    """Where a speculative step's time goes, on a fresh speculative engine
    (serve_spec_bf16's) with ``specs`` in its slots: six steps, then one
    under ``torch.profiler`` (its wall ms, the profiler's host cost in it,
    and the kernels' device-busy share), then the verify's times at the
    live pools (``verify_attend_ms``)."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    engine, _, out = spec_engine(model)
    for spec in specs:
        engine.submit(spec)
    engine._fill_slots()
    for _ in range(6):
        engine._engine_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._engine_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    summary = profile_summary(prof, wall_ms, "paged_")
    report = {"profile": {k: summary[k] for k in ("wall_ms", "device_busy_ms", "device_busy_share",
                                                  "device_union_share", "paged_kernels", "top_device_ms")},
              "verify": verify_attend_ms(engine, model)}
    del engine
    shutil.rmtree(out, ignore_errors=True)
    free_card()
    return report


def serve_spec_bf16_phase(card: str) -> dict:
    """serve_bf16's model and engine geometry in the speculative slot mode
    (``spec_k`` 4, ``spec_depth`` 6: bench.py's committed A/B geometry), each
    check fatal (``check_spec_serve``).

    Part (a): serve's six greedy requests through the speculative engine,
    then through serve_bf16's engine (decode tok/s of both, this run); every
    stream of both equal to the sequential bf16 stream up to its first near
    tie (``check_streams``), so the two engines' streams agree that far;
    TTFT; acceptance and tokens a step from the request rows; the pools'
    memory with the drafter's and the peak; then, on a fresh engine, one
    profiled step's device-busy share and the verify's gather and attend ms
    (``spec_profile``).

    Part (b): the same with eviction at pool headroom 0.5: evictions, as many
    resumes by replay into both pool families, the same checks.

    Part (c): the speculative pair (``make_speculative_decode_fns``, its step
    a CUDA graph) against the graphed sequential pair and ``generate`` at
    batch 1 on an 8192-token prompt, 128 new tokens: ``generate``'s stream
    the sequential pair's, the speculative stream equal to it up to its
    first near tie, tok/s of both pairs after their capturing first step,
    the spans and accepted drafts.

    Returns part (a)'s launches."""
    import shutil

    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    bf16, name = torch.bfloat16, "serve_spec_bf16"
    t_phase = time.perf_counter()
    model = CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda",
                                generator=torch.Generator().manual_seed(SEED), dtype=bf16)
    report = {"card": card, "spec_k": SPEC_K, "spec_depth": SPEC_DEPTH}
    specs = serve_specs()
    served = {}
    for part, engine_kw in (("a", {}), ("b", {"eviction": True, "pool_headroom": EVICT_HEADROOM})):
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 2**30
        built = [0]
        with count_dense(built):
            engine, warm_up, out = spec_engine(model, **engine_kw)
        engine._events_dir = out
        if part == "a":
            # the drafter's k + 1 steps over its CA and SA pools; the verify
            # on the gather route (no K3), no prefill kernel
            check_graph(name, engine._step_fn.captured.graph, warm_up,
                        {"paged_decode" + BF16: (SPEC_K + 1) * (1 + SPEC_DEPTH), "paged_decode": 0,
                         "flash_packed_fwd" + BF16: 0})
        pools_gb = sum(t.numel() * t.element_size() for key in ("cache", "draft_cache")
                       for p in engine._state[key] for t in (p.k, p.v)) / 2**30
        drafter_gb = sum(t.numel() * t.element_size() for p in engine._state["draft_cache"]
                         for t in (p.k, p.v)) / 2**30
        dense = [0]
        with count_dense(dense):
            run = serve_run(engine, specs)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        label = f"{name} part ({part})"
        quality = check_spec_serve(label, engine, run, (built[0], dense[0]), N_REQUESTS)
        books = engine.books()
        if part == "b" and (books["evictions"] < 1 or books["resumes"] != books["evictions"]):
            raise SystemExit(f"{label}: books {books}: the pool headroom evicted nothing")
        served[part] = dict(engine.served_tokens)
        if part == "a":
            launches = run["launches"]
        report[f"part {part}"] = {
            "decode_tok_s": run["decode_tok_s"], "steps": run["steps"], "decoded": run["decoded"],
            "ttft_ms": [1e3 * r.ttft_s for r in run["records"]], **quality,
            "books": {k: books[k] for k in ("ok", "evictions", "resumes", "parked", "balanced")},
            "pools_gb": pools_gb, "drafter_pools_gb": drafter_gb, "peak_allocated_gb": peak_gb,
            "allocated_before_gb": before_gb}
        del engine
        shutil.rmtree(out, ignore_errors=True)
        free_card()
    report["part a"].update(spec_profile(model, specs[:SERVE_SLOTS]))
    # serve_bf16's engine on the same requests, this run: the decode rate
    # the speculative one is held beside
    engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16)
    plain = serve_run(engine, specs)
    report["non_speculative"] = {"decode_tok_s": plain["decode_tok_s"], "steps": plain["steps"],
                                 "ttft_ms": [1e3 * r.ttft_s for r in plain["records"]]}
    report["streams identical to the non-speculative engine's"] = [
        served["a"][s.index] == engine.served_tokens[s.index] for s in specs]
    served["non-speculative"] = dict(engine.served_tokens)
    del engine
    free_card()
    # each stream of the three serves equal to the sequential one up to its
    # first near tie, so the speculative streams equal the non-speculative
    # engine's that far
    report["non_speculative"]["tokens_equal_to_sequential"] = check_streams(
        f"{name} non-speculative", model, specs, served["non-speculative"], NEAR_TIE_BF16, bf16)
    for part in ("a", "b"):
        report[f"part {part}"]["tokens_equal_to_sequential"] = check_streams(f"{name} part ({part})", model, specs,
                                                                             served[part], NEAR_TIE_BF16, bf16)

    # part (c): the pair against the graphed sequential pair and generate;
    # each pair's first step runs eagerly and captures, then tok/s over the
    # rest, every step's tokens read on the host (as a streaming server does)
    new = DECODE_NEW_TOKENS
    config = generation.GenerationConfig(max_new_tokens=new)
    ids = np.random.default_rng(SEED + 4).integers(0, FLAGSHIP["vocab_size"], size=(1, DECODE_PROMPT))
    pair = {}
    prefill, step = generation.make_decode_fns(model, NUM_LATENTS, config, bf16, device="cuda")
    token, state = prefill(ids)
    state, second = step(state)
    plain = [int(token[0]), int(second[0])]
    t0 = time.perf_counter()
    while len(plain) < new:
        state, token = step(state)
        plain.append(int(token[0]))
    pair["sequential_tok_s"] = (new - 2) / (time.perf_counter() - t0)
    del prefill, step, state
    out = generation.generate(model, ids, NUM_LATENTS, config=config, cache_dtype=bf16, device="cuda")
    pair["generate_equal_to_sequential"] = out[0, DECODE_PROMPT:].tolist() == plain
    prefill, step = generation.make_speculative_decode_fns(model, NUM_LATENTS, config, k=SPEC_K,
                                                           draft_depth=SPEC_DEPTH, cache_dtype=bf16, device="cuda")
    token, state = prefill(ids)
    state, tokens, m = step(state)
    stream, spans = [int(token[0])] + tokens[0, :int(m[0])].tolist(), [int(m[0])]
    first, t0 = len(stream), time.perf_counter()
    while len(stream) < new:
        state, tokens, m = step(state)
        n = int(m[0])
        stream.extend(tokens[0, :n].tolist())
        spans.append(n)
    pair["speculative_tok_s"] = (len(stream) - first) / (time.perf_counter() - t0)
    if not isinstance(step.body, generation._GraphedStep) or step.body.captures != 1:
        raise SystemExit(f"{name} part (c): the speculative pair's step is not one captured graph")
    del prefill, step, state
    spec_stream = stream[:new]
    pair.update(spans=len(spans), accepted=sum(spans) - len(spans), streams_identical=spec_stream == plain)
    if not pair["generate_equal_to_sequential"]:
        raise SystemExit(f"{name} part (c): generate's stream is not the graphed sequential pair's")
    pair["tokens_equal_to_sequential"] = check_streams(
        f"{name} part (c)", model, [serve_spec(0, ids, new)], {0: spec_stream}, NEAR_TIE_BF16, bf16)[0]
    pair["tokens_per_span"] = new / max(pair["spans"], 1)
    report["part c"] = pair
    report["phase_s"] = time.perf_counter() - t_phase
    TIMES[name] = report
    log(f"{name}: " + json.dumps(report))
    return launches


def serve_spec(index: int, ids, new: int):
    """A ``RequestSpec`` for the prompt ``ids`` (1, n), greedy, ``new``
    tokens."""
    from perceiver_io_tpu_torch.serving import RequestSpec

    return RequestSpec(index=index, prompt_len=ids.shape[1], max_new_tokens=new, input_ids=ids, rng_seed=0)


def beam_bf16_phase(card: str) -> dict:
    """``beam_search`` on the bf16 flagship: one beam over a 4096-token
    prompt and 64 new tokens against the graphed greedy ``generate`` (equal
    up to its first near tie), then ``BEAM_WIDTH`` beams: one captured step
    a call (the beam step holds K1's nodes and no K2 or K3), finite scores,
    every token in the vocabulary, tok/s (beams x tokens a second) of both.
    Returns the 4-beam call's launches."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build

    bf16, name, new = torch.bfloat16, "beam_bf16", BEAM_NEW_TOKENS
    model = CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda",
                                generator=torch.Generator().manual_seed(SEED), dtype=bf16)
    ids = np.random.default_rng(SEED + 5).integers(0, FLAGSHIP["vocab_size"], size=(1, BEAM_PROMPT))
    report, graphs = {"card": card, "prompt_len": BEAM_PROMPT, "new_tokens": new}, []
    real = generation._GraphedStep

    def recorded(model, config, step_name, body, stage):
        # the launches of each call of the body: the first is the warm-up
        calls = []

        def counted(state):
            before = dict(build.LAUNCHES)
            out = body(state)
            calls.append({k: n - before.get(k, 0) for k, n in build.LAUNCHES.items() if n != before.get(k, 0)})
            return out

        graphs.append((real(model, config, step_name, counted, stage), calls))
        return graphs[-1][0]

    generation._GraphedStep = recorded
    try:
        for beams in (1, BEAM_WIDTH):
            build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seqs, scores = generation.beam_search(model, ids, NUM_LATENTS, num_beams=beams, max_new_tokens=new,
                                                  cache_dtype=bf16, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tail = seqs[0, BEAM_PROMPT:].tolist()
            if (seqs.shape != (1, BEAM_PROMPT + new) or not bool(torch.isfinite(scores).all())
                    or not all(0 <= t < FLAGSHIP["vocab_size"] for t in tail)):
                raise SystemExit(f"{name}: {beams} beams gave {tuple(seqs.shape)}, scores {scores.tolist()}")
            report[f"beams_{beams}"] = {"wall_s": wall, "tok_s": beams * new / wall, "score": float(scores[0]),
                                        "launches": nonzero_launches()}
            if beams == 1:
                beam_1 = tail
    finally:
        generation._GraphedStep = real
    report["beam_1 tokens_equal_to_sequential"] = check_streams(
        f"{name} beam 1", model, [serve_spec(0, ids, new)], {0: beam_1}, NEAR_TIE_BF16, bf16)[0]
    if len(graphs) != 2 or any(g.captures != 1 for g, _ in graphs):
        raise SystemExit(f"{name}: {len(graphs)} beam steps, captures {[g.captures for g, _ in graphs]}")
    step, calls = graphs[-1]
    ln = step.graph.launches.get("layer_norm_fwd" + BF16, 0)
    check_graph(name, step.graph, calls[0],
                {"paged_decode" + BF16: 0, "paged_decode": 0, "flash_packed_fwd" + BF16: 0, "flash_packed_fwd": 0})
    if ln == 0:
        raise SystemExit(f"{name}: the captured beam step launched no LayerNorm kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generation.generate(model, ids, NUM_LATENTS, config=generation.GenerationConfig(max_new_tokens=new),
                              cache_dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    report["generate_tok_s"] = new / (time.perf_counter() - t0)
    report["beam_1 identical to generate"] = out[0, BEAM_PROMPT:].tolist() == beam_1
    TIMES[name] = report
    log(f"{name}: " + json.dumps(report))
    launches = report[f"beams_{BEAM_WIDTH}"]["launches"]
    del model
    free_card()
    return launches


def decode_pair_phase(card: str) -> dict:
    """The contiguous decode pair at full width (A3): ``make_decode_fns``'
    step is one captured CUDA graph on the card, replayed for every token
    after the first step (which runs eagerly and captures). Greedy, 128 new
    tokens, on one 8192-token prompt at batch 1 and on four of the serve's
    prompts left-padded to the longest at batch 4; in f32, and in bf16
    compute with f32 and with bf16 caches. Each graphed run beside an eager
    run of the same body (``generation._eager_step``) from the same prefill:
    the streams must be equal token for token, every token in the
    vocabulary and the last logits finite; decode tok/s of both over the
    126 steps after the first; ``generate`` must give the graphed stream.
    The batch-1 graph's kernel nodes (``graph decode_pair*`` lines): K1
    only, no K2, no K3. Returns the f32 batch-4 graphed run's launches
    (prefill and steps)."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build

    f32, bf16 = torch.float32, torch.bfloat16
    new = DECODE_NEW_TOKENS
    config = generation.GenerationConfig(max_new_tokens=new)
    vocab = FLAGSHIP["vocab_size"]
    single = np.random.default_rng(SEED + 4).integers(0, vocab, size=(1, DECODE_PROMPT))
    specs = serve_specs()[:4]
    width = max(spec.prompt_len for spec in specs)
    batch, pad = np.zeros((4, width), np.int64), np.ones((4, width), bool)
    for i, spec in enumerate(specs):
        batch[i, width - spec.prompt_len:] = spec.input_ids[0]
        pad[i, width - spec.prompt_len:] = False
    prompts = {"batch1": (single, None), "batch4": (batch, pad)}
    main_launches = None
    for label, dtype, cache_dtype in (("", f32, f32), (BF16, bf16, f32), (BF16 + "_cache" + BF16, bf16, bf16)):
        model = CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda", dtype=dtype,
                                    generator=torch.Generator().manual_seed(SEED))
        for pname, (ids, mask) in prompts.items():
            name = f"decode_pair{label} {pname}"
            runs = {}
            for kind in ("graph", "eager"):
                prefill, step = generation.make_decode_fns(model, NUM_LATENTS, config, cache_dtype, device="cuda")
                if kind == "eager":
                    body = generation._eager_step(model, config, model.device)

                    def step(st, body=body):  # the pair's step on the eager body
                        st, tok = body(st)
                        return st, tok.clone()
                build.reset_launches()
                token, state = prefill(ids, mask)
                tokens = [token]
                prefill_launches = nonzero_launches()
                build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, token = step(state)  # the graph's warm-up and capture
                tokens.append(token)
                torch.cuda.synchronize()
                first_ms = 1e3 * (time.perf_counter() - t0)
                first_launches = nonzero_launches()
                t0 = time.perf_counter()
                for _ in range(new - 2):
                    state, token = step(state)
                    tokens.append(token)
                torch.cuda.synchronize()
                steady_s = time.perf_counter() - t0
                stream = torch.stack(tokens, dim=1).cpu()
                runs[kind] = {"stream": stream, "tok_s": ids.shape[0] * (new - 2) / steady_s,
                              "step_ms": 1e3 * steady_s / (new - 2), "first_step_ms": first_ms,
                              "logits_finite": bool(torch.isfinite(state["logits"]).all()),
                              "launches": {k: prefill_launches.get(k, 0) + n for k, n in build.LAUNCHES.items()
                                           if prefill_launches.get(k, 0) + n}}
                if kind == "graph":
                    if not isinstance(step.body, generation._GraphedStep):
                        raise SystemExit(f"{name}: the decode step on the card is not the captured graph")
                    if pname == "batch1":
                        ln = sum(first_launches.get("layer_norm_fwd" + sfx, 0) for sfx in ("", BF16))
                        check_graph(f"decode_pair{label}", step.body.graph, first_launches,
                                    {"paged_decode": 0, "paged_decode" + BF16: 0, "flash_packed_fwd": 0,
                                     "flash_packed_fwd" + BF16: 0})
                        if ln == 0:
                            raise SystemExit(f"{name}: the captured step launched no LayerNorm kernel")
                    out = generation.generate(model, ids, NUM_LATENTS, pad_mask=mask, config=config,
                                              cache_dtype=cache_dtype, device="cuda")
                    runs[kind]["generate_equal"] = torch.equal(out[:, ids.shape[1]:].cpu(), stream)
                del prefill, step, state
            g, e = runs["graph"], runs["eager"]
            identical = torch.equal(g["stream"], e["stream"])
            report = {"card": card, "dtype": str(dtype)[6:], "cache_dtype": str(cache_dtype)[6:],
                      "batch": ids.shape[0], "prompt_len": ids.shape[1],
                      "left_pads": [] if mask is None else [int(x) for x in mask.sum(1)], "new_tokens": new,
                      "streams_identical": identical, "generate_equal": g["generate_equal"],
                      **{f"{k}_{kind}": r[k] for kind, r in runs.items()
                         for k in ("tok_s", "step_ms", "first_step_ms", "logits_finite")}}
            log(f"{name}: " + json.dumps(report))
            if not identical or not g["generate_equal"]:
                raise SystemExit(f"{name}: the graphed stream differs from the eager one or from generate's: "
                                 f"{report}")
            if not (g["logits_finite"] and e["logits_finite"]) or not bool(((g["stream"] >= 0)
                                                                           & (g["stream"] < vocab)).all()):
                raise SystemExit(f"{name}: non-finite logits or tokens outside the vocabulary: {report}")
            TIMES.setdefault("decode_pair_tok_s", {})[name] = {kind: r["tok_s"] for kind, r in runs.items()}
            if not label and pname == "batch4":
                main_launches = g["launches"]
        del model
        free_card()
    return main_launches


def profile_phase(model, card: str, graphed: bool) -> None:
    """Where a serve's time goes: four 4096-token requests with 24-token
    budgets through a fresh engine (its decode step the captured graph, or
    the eager step) under ``torch.profiler``; prints the device-busy share
    of the wall time and the top operators by device and by host time. The
    profiler's own host cost inflates the wall time, so the busy share it
    shows is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from perceiver_io_tpu_torch.serving import RequestSpec

    rng = np.random.default_rng(SEED + 1)
    specs = [RequestSpec(i, 4096, 24, rng.integers(0, FLAGSHIP["vocab_size"], size=(1, 4096)), i)
             for i in range(4)]
    engine, _ = serve_engine(model, graphed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        records = engine.run_closed(specs, concurrency=4)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    summary = dict(profile_summary(prof, wall_ms, "paged_"), k3_by_pool=k3_by_pool(prof))
    step = "graph" if graphed else "eager"
    TIMES.setdefault("serve_busy_share", {})[step] = summary["device_busy_share"]
    TIMES.setdefault("serve_busy_union_share", {})[step] = summary["device_union_share"]
    log("profile: " + json.dumps({
        "card": card, "step": step, "requests": len(specs), "prompt_len": 4096, "max_new_tokens": 24,
        "decode_steps": engine._engine_steps, "prefill_ms": 1e3 * sum(r.ttft_s for r in records), **summary,
    }))


# the ranges the port opens under a profiler (obs/profiler.py's scope)
PROFILER_SCOPES = frozenset({"prefill", "shared_prefill", "decode", "decode_paged", "train_step"})


def profile_summary(prof, wall_ms: float, sum_kernels: str = None) -> dict:
    """Device-busy time and share of the wall time, and the top kernels by
    device time and operators by host time, from a ``torch.profiler`` run;
    with ``sum_kernels``, also the device time and launches of the kernels
    whose names hold it (``"paged_"``: K3's walk and merge)."""
    from torch.autograd import DeviceType

    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # kernels, copies and memsets only: an operator's entry repeats the time
    # of the kernels it launched, and the GPU-side copy of a host range (a
    # profiler scope such as train_step) spans the kernels it holds
    def on_device(e):
        return (getattr(e, "device_type", None) == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and e.key not in PROFILER_SCOPES)

    kernels = [e for e in events if on_device(e)]
    busy_ms = 1e-3 * sum(device_us(e) for e in kernels)
    by_device = sorted(kernels, key=device_us, reverse=True)[:12]
    by_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    out = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_device_ms": [[e.key[:80], e.count, 1e-3 * device_us(e)] for e in by_device],
        "top_host_ms": [[e.key, e.count, 1e-3 * e.self_cpu_time_total] for e in by_host],
    }
    if sum_kernels is not None:
        chosen = [e for e in kernels if sum_kernels in e.key]
        out[f"{sum_kernels}kernels"] = {"device_ms": 1e-3 * sum(device_us(e) for e in chosen),
                                        "launches": sum(e.count for e in chosen)}
    # kernels that overlap (K3's merge starts early and waits on its walk
    # through a programmatic dependence) count once in the union of their
    # intervals; the sum above counts them twice
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if on_device(e))
    union_us, end = 0.0, -math.inf
    for lo, hi in spans:
        union_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    out.update(device_union_ms=1e-3 * union_us, device_union_share=1e-3 * union_us / wall_ms)
    return out


def k3_by_pool(prof) -> dict:
    """K3's device time in a profiled serve by pool: every decode step calls
    it on the CA pool first, then on the 8 SA pools, and the prefills not at
    all, so its walks (and its merges), in start order, come in runs of 9:
    the first of each run is the CA call."""
    from torch.autograd import DeviceType

    per_step = 1 + FLAGSHIP["num_self_attention_layers"]
    out = {}
    for kernel in ("paged_walk_kernel", "paged_merge_kernel"):
        events = sorted((e for e in prof.events()
                         if getattr(e, "device_type", None) == DeviceType.CUDA and kernel in e.name),
                        key=lambda e: e.time_range.start)
        ms = [1e-3 * e.time_range.elapsed_us() for e in events]
        out[kernel] = {"calls": len(ms), "ca_ms": sum(ms[::per_step]),
                       "sa_ms": sum(m for i, m in enumerate(ms) if i % per_step)}
    return out


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def poisonable(loss_fn):
    """``loss_fn`` with its loss multiplied by the batch's ``poison[0]``: 1.0
    (an exact no-op) on every step but the sentinel check's, where NaN makes
    the step non-finite."""
    def poisoned(model, batch, generator=None):
        loss, metrics = loss_fn(model, batch, generator)
        loss = loss * batch["poison"][0]
        return loss, dict(metrics, loss=loss)

    poisoned.uniform_weighting = loss_fn.uniform_weighting
    return poisoned


def nonzero_launches() -> dict:
    from perceiver_io_tpu_torch.ops import build

    return {k: n for k, n in build.LAUNCHES.items() if n}


def train_per_step(route: str, variant: str, suffix: str) -> dict:
    """The launches a flagship train step makes, by kernel (``suffix`` the
    build's): ``PER_STEP``'s, with the backward's recompute of every layer's
    LayerNorms and attention forward under checkpointing or offloading (K1,
    K2 and K6 twice), and no attention kernel under attention dropout (the
    dense route, as the JAX package's gate sends it)."""
    n = dict(PER_STEP[route])
    fwd = {"layer_norm": n["layer_norm"], "flash_packed": n["flash_packed"], "flash_2seg": n["flash_2seg"]}
    if variant in ("remat", "offload"):
        fwd = {k: 2 * v for k, v in fwd.items()}
    if variant == "dropout":
        n.update(flash_packed=0, flash_2seg=0)
        fwd.update(flash_packed=0, flash_2seg=0)
    per_step = {}
    for k in TRAIN_KERNELS + TWOSEG_KERNELS:
        family = "layer_norm" if k.startswith("layer_norm") else "flash_2seg" if "2seg" in k else "flash_packed"
        per_step[k + suffix] = fwd[family] if k.endswith("_fwd") else n[family]
    if suffix:  # no f32 build in a bf16 step
        per_step.update({k: 0 for k in TRAIN_KERNELS + TWOSEG_KERNELS})
    return per_step


def train_phase(card: str, route: str = "concat", jit: bool = True, concat: dict = None,
                dtype: torch.dtype = torch.float32, variant: str = "", lr: float = TRAIN_LR,
                steps: int = TRAIN_STEPS, fixed_keep: bool = False) -> dict:
    """Five steps of the flagship at full width and depth, on the concat route
    or, with ``route="twoseg"``, under ``fast_kernels({"twoseg"})``, from the
    same seed, weights, batch and keep sets (then each loss is held against
    ``concat``'s, the same kind of step's, within the route's or variant's
    tolerance); as a CUDA graph (``jit``, the default) or eagerly. Then the
    sentinel: one step whose loss is NaN (a replay under the graph) must hold
    parameters, moments, AdamW's steps and the count bit for bit; one more
    finite step; one step under ``torch.profiler``. With ``dtype`` bf16
    (train_bf16): bf16 compute and bf16 Adam moments
    (``moment_dtype="bfloat16"``), every kernel launch its bf16 build's.
    ``variant`` (``TRAIN_VARIANTS``) sets the config's training options;
    the dropout variant's masks come from a CUDA generator seeded ``SEED``. A short
    run (``steps`` below five) stops after the steps, and ``fixed_keep``
    gives every step the first step's keep set. Returns
    the five steps' launches, losses, median, peak memory, the parameters
    and gradients after them, and the loss of the step after the NaN one."""
    from torch.profiler import ProfilerActivity, profile

    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels

    suffix = BF16 if dtype == torch.bfloat16 else ""
    name = ("train" + (f"_{variant}" if variant else "") + ("" if route == "concat" else "_twoseg") + suffix
            + ("" if jit else "_eager"))
    config = CausalLanguageModelConfig(**FLAGSHIP, **TRAIN_VARIANTS[variant])
    model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED), dtype=dtype)
    n, lat = FLAGSHIP["max_seq_len"], FLAGSHIP["max_latents"]
    rng = np.random.default_rng(SEED)
    t = torch.from_numpy(rng.integers(0, config.vocab_size, size=(TRAIN_BATCH, n + 1))).cuda()
    ones = np.ones(TRAIN_BATCH, np.float32)
    tokens = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None}

    fixed = tt.sample_prefix_keep_idx(rng, TRAIN_BATCH, n - lat, config.cross_attention_dropout) if fixed_keep else None

    def batch(poison=ones):
        keep = fixed if fixed_keep else tt.sample_prefix_keep_idx(rng, TRAIN_BATCH, n - lat,
                                                                  config.cross_attention_dropout)
        return dict(tokens, prefix_keep_idx=keep, poison=poison)

    # the dropout masks' generator, on the card so that a replay draws anew
    gen = torch.Generator(device="cuda").manual_seed(SEED) if variant == "dropout" else None
    state = tt.TrainState.create(model, tt.make_optimizer(lr, gradient_clip=1.0,
                                                          moment_dtype="bfloat16" if suffix else None), generator=gen)
    step = tt.make_train_step(poisonable(tt.clm_loss_fn(lat)), microbatch=TRAIN_MICROBATCH, sentinel=True, jit=jit)
    losses, step_ms, skipped = [], [], []
    per_step = train_per_step(route, variant, suffix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    with fast_kernels(ROUTE_FEATURES[route]):
        build.reset_launches()
        for i in range(steps):
            b = batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            skipped.append(float(metrics["sentinel_skipped"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if i == 0 and jit:
                check_graph(name, step.captured.graph, nonzero_launches(), per_step)
        launches = dict(build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = [p.detach().cpu().clone() for p in model.parameters()]
        grads = [p.grad.detach().cpu().clone() for p in model.parameters()]
        if steps < TRAIN_STEPS:  # a short run (the dropout replays): no sentinel or profile
            return {"losses": losses, "launches": launches, "step_ms": step_ms}
        # the sentinel on the device: a NaN loss holds the whole update
        held = [x.clone() for x in state.optimizer.state_tensors()]
        _, metrics = step(state, batch(np.full(TRAIN_BATCH, np.nan, np.float32)))
        poison_skipped = float(metrics["sentinel_skipped"])
        poison_held = all(torch.equal(x, h) for x, h in zip(state.optimizer.state_tensors(), held))
        del held
        _, metrics = step(state, batch())
        after_poison_loss = float(metrics["loss"])
        # one more step under torch.profiler: where a step's time goes
        b = batch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, b)
            torch.cuda.synchronize()
            wall_ms_ = 1e3 * (time.perf_counter() - t0)
    summary = profile_summary(prof, wall_ms_)
    log(f"{name}_profile: " + json.dumps({"card": card, **summary}))
    median_ms = statistics.median(step_ms)
    kernels = tuple(k for k, v in per_step.items() if v)
    report = {
        "card": card, "dtype": str(dtype)[6:], "moments": "bfloat16" if suffix else "float32",
        "options": TRAIN_VARIANTS[variant], "step": "graph" if jit else "eager", "batch": TRAIN_BATCH,
        "microbatch": TRAIN_MICROBATCH, "seq_len": n, "latents": lat, "steps": steps, "losses": losses,
        "step_ms": step_ms, "median_step_ms": median_ms, "train_tokens_per_s": TRAIN_BATCH * n / (median_ms / 1e3),
        "peak_memory_gb": peak_gb, "memory_before_steps_gb": base_gb,
        "launches_per_step": {k: launches[k] / steps for k in kernels},
        "sentinel_skipped": skipped,
        "nan_step": {"sentinel_skipped": poison_skipped, "held_bit_for_bit": poison_held,
                     "next_loss": after_poison_loss},
    }
    loss_tol = MASK_LOSS_TOL_BF16 if variant == "mask" else TWOSEG_LOSS_TOL_BF16 if suffix else TWOSEG_LOSS_TOL
    if concat is not None:
        diffs = [abs(a - b) for a, b in zip(losses, concat["losses"])]
        report.update(concat_median_step_ms=concat["median_step_ms"], loss_diff_to_concat=diffs, loss_tol=loss_tol)
    log(f"{name}: " + json.dumps(report))
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{name}: loss did not fall over {steps} steps: {losses}")
    if any(skipped):
        raise SystemExit(f"{name}: the sentinel skipped a step: {skipped}")
    if poison_skipped != 1.0 or not poison_held or not math.isfinite(after_poison_loss):
        raise SystemExit(f"{name}: the NaN step was not held: {report['nan_step']}")
    wrong = {k: launches[k] for k, v in per_step.items() if launches[k] != v * steps}
    if wrong:
        raise SystemExit(f"{name}: launches over {steps} steps {wrong}, expected per step {per_step}")
    if concat is not None and not all(within(dd, loss_tol) for dd in report["loss_diff_to_concat"]):
        raise SystemExit(f"{name}: losses differ from the concat route's by {report['loss_diff_to_concat']}")
    return {"launches": launches, "losses": losses, "median_step_ms": median_ms, "params": params,
            "grads": grads, "next_loss": after_poison_loss, "busy_share": summary["device_busy_share"],
            "kernels_ms": summary["device_busy_ms"], "peak_memory_gb": peak_gb, "step_peak_gb": peak_gb - base_gb}


# fit_bf16: Trainer.fit over train_bf16's step (bf16 compute, bf16 Adam
# moments, AdamW at 1e-3 with a 2-step warmup into a cosine, clip 1.0, batch
# 4 in 2 chunks, host keep sets), 8 steps, a log row every 2, validation and
# a checkpoint every 4, the guard tripped at FIT_KILL_AT; the ladder's NaN
# batches (1-based): one skip, then two in a row, a rollback to step 4
FIT_STEPS, FIT_LOG, FIT_VAL, FIT_WARMUP, FIT_KILL_AT = 8, 2, 4, 2, 4
FIT_POISON = (2, 6, 7)
# one validation forward of the flagship (batch 4, deterministic: the whole
# 15360-row prefix): the CA and 8 SA layers through K2, their 3 + 16
# LayerNorms through K1, the bf16 builds
FIT_EVAL_FORWARD = {"flash_packed_fwd" + BF16: 9, "layer_norm_fwd" + BF16: 19}


def fit_batches(poison_at=()):
    """train_bf16's batch (its tokens and, drawn after them from the same
    seeded generator, a fresh host keep set per step), as numpy; endless.
    The ``poison`` of the i-th batch (1-based) is NaN where ``i`` is in
    ``poison_at``."""
    from perceiver_io_tpu_torch import training as tt

    n, lat = FLAGSHIP["max_seq_len"], FLAGSHIP["max_latents"]
    rng = np.random.default_rng(SEED)
    t = rng.integers(0, FLAGSHIP["vocab_size"], size=(TRAIN_BATCH, n + 1))
    tokens = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None}
    i = 0
    while True:
        i += 1
        keep = tt.sample_prefix_keep_idx(rng, TRAIN_BATCH, n - lat, FLAGSHIP["cross_attention_dropout"])
        yield dict(tokens, prefix_keep_idx=keep,
                   poison=np.full(TRAIN_BATCH, np.nan if i in poison_at else 1.0, np.float32))


def fit_state():
    """The flagship as train_bf16 builds it (seed, bf16 compute, f32
    parameters, bf16 Adam moments, clip 1.0), the warmup-cosine schedule, and
    a CUDA generator seeded SEED in the state (the checkpoint carries it)."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    config = CausalLanguageModelConfig(**FLAGSHIP)
    model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED),
                                dtype=torch.bfloat16)
    schedule = tt.cosine_with_warmup(TRAIN_LR, FIT_STEPS, FIT_WARMUP)
    state = tt.TrainState.create(model, tt.make_optimizer(schedule, gradient_clip=1.0, moment_dtype="bfloat16"),
                                 generator=torch.Generator(device="cuda").manual_seed(SEED))
    return config, schedule, state


def fit_run(root: str, sentinel=True, resume=False, trip_at=None, poison_at=(), held_skip=None) -> dict:
    """One ``Trainer.fit`` of a fresh flagship state (``fit_state``) on
    ``fit_batches``, logging and checkpointing under ``root``: each step's
    loss (the step's own tensor, read after the fit), the state, the
    trainer's captured train step, its checkpoint manager's save rows, the
    events and metrics.csv's steps, the launches and the peak memory of the
    fit, and whether every tensor of the state kept its address. ``trip_at`` trips the preemption guard when the
    state reaches that step; ``held_skip`` (a list) gets, for the first NaN
    step, whether every optimizer tensor held bit for bit."""
    import csv
    import os

    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.obs.mfu import clm_train_telemetry
    from perceiver_io_tpu_torch.ops import build

    config, schedule, state = fit_state()
    tokens_per_sample, flops_per_sample = clm_train_telemetry(config)
    lat = FLAGSHIP["max_latents"]
    cfg = tt.TrainerConfig(max_steps=FIT_STEPS, log_interval=FIT_LOG, val_interval=FIT_VAL,
                           microbatch=TRAIN_MICROBATCH, prefetch_batches=2, input_double_buffer=True,
                           sentinel=tt.SentinelConfig(skip_limit=2) if sentinel else False,
                           checkpoint_dir=os.path.join(root, "ckpt"), tokens_per_sample=tokens_per_sample,
                           flops_per_sample=flops_per_sample)
    trainer = tt.Trainer(poisonable(tt.clm_loss_fn(lat)), eval_loss_fn=tt.clm_loss_fn(lat, deterministic=True),
                         config=cfg, logger=tt.MetricsLogger(os.path.join(root, "logs"), use_tensorboard=False),
                         lr_schedule=schedule)
    step, losses = trainer._train_step, []

    def tracked(st, batch):
        held = None
        if held_skip is not None and not held_skip and bool(torch.isnan(batch["poison"]).any()):
            held = [t.clone() for t in st.optimizer.state_tensors()]
        st, metrics = step(st, batch)
        losses.append(metrics["loss"])
        if held is not None:
            held_skip.append(all(torch.equal(t, h) for t, h in zip(st.optimizer.state_tensors(), held)))
        if trip_at is not None and st.step == trip_at:
            trainer._preempt_guard.trip()
        return st, metrics

    trainer._train_step = tracked

    def addresses(st):
        return [t.data_ptr() for t in list(st.model.state_dict().values()) + st.optimizer.state_tensors()]

    before = addresses(state)
    tokens = next(fit_batches())
    val = [{k: tokens[k] for k in ("input_ids", "labels", "pad_mask")}]
    free_card()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    out = trainer.fit(state, fit_batches(poison_at), val_loader=val, model_config=config, resume=resume)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = nonzero_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    saves = list(trainer.checkpoints.saves)
    addresses_kept = addresses(out) == before
    trainer.close()
    with open(os.path.join(root, "logs", "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    with open(os.path.join(root, "logs", "metrics.csv"), newline="") as f:
        csv_steps = [int(r["step"]) for r in csv.DictReader(f)]
    return {"losses": [float(x) for x in losses], "state": out, "captured": step.captured, "saves": saves,
            "events": events, "csv_steps": csv_steps, "launches": launches, "peak_gb": peak_gb, "wall_s": wall_s,
            "addresses_kept": addresses_kept}


def fit_window_ms(events: list) -> list:
    """ms a step of each log window after the first (which holds the
    capture), from the ``log`` events' steps_per_sec."""
    return [1e3 / e["steps_per_sec"] for e in events if e["event"] == "log"][1:]


def fit_dispatch_ms(events: list) -> float:
    """Median host ms of issuing a step (the train step call: the batch's
    fill and the graph's replay) over the steps after the first, from the
    ``step`` spans' ``dispatch_ms``."""
    spans = [e for e in events if e["event"] == "span" and e["name"] == "step"]
    return statistics.median(e["attrs"]["dispatch_ms"] for e in spans[1:])


def fit_phase(card: str) -> dict:
    """fit_bf16: ``Trainer.fit`` at the flagship in bf16 around the captured
    train step (see ``FIT_*``). Checks, each fatal:

    1. the fit leaves the step alone: each step's loss and the final
       parameters equal a bare loop of the captured ``make_train_step`` over
       the same batches, bit for bit;
    2. preempt and resume: a fit tripped at ``FIT_KILL_AT``, then a fresh
       state and Trainer with ``resume="auto"`` to the end, give the
       uninterrupted fit's losses of the later steps, parameters, every
       optimizer tensor and the generator's state bit for bit; metrics.csv
       holds the uninterrupted fit's steps; events.jsonl has
       ``fault.preempt`` and ``resume`` with ``fast_forward_batches``
       ``FIT_KILL_AT``;
    3. the sentinel ladder (NaN batches ``FIT_POISON``): ``fault.skip`` with
       every optimizer tensor held, then ``fault.rollback`` to the step-4
       checkpoint written into the same tensors (every parameter and moment
       keeps its address) with no recapture of the train step, and the fit
       finishes;
    4. the fit's launches: train_bf16's per step times the steps taken, plus
       ``FIT_EVAL_FORWARD`` per validation, exactly, and no other kernel.

    Recorded, not gated: ms a step in the log windows after the first
    against the bare step's median (sentinel on and off), input_wait_ms, the
    time the loop blocks on an async save and the save's write time, the
    rollback's restore time, the checkpoint's bytes, the fit's peak memory,
    and the mfu column (the card's peak, ``obs.mfu``)."""
    import tempfile

    from perceiver_io_tpu_torch import training as tt

    lat = FLAGSHIP["max_latents"]
    per_step = train_per_step("concat", "", BF16)
    want_launches = {k: v * FIT_STEPS for k, v in per_step.items() if v}
    for k, v in FIT_EVAL_FORWARD.items():
        want_launches[k] += v * (FIT_STEPS // FIT_VAL)
    report = {"card": card, "steps": FIT_STEPS, "batch": TRAIN_BATCH, "microbatch": TRAIN_MICROBATCH}
    # the bare loop: the captured step over the same batches
    _, _, state = fit_state()
    bare_step = tt.make_train_step(poisonable(tt.clm_loss_fn(lat)), microbatch=TRAIN_MICROBATCH, sentinel=True)
    bare_losses, bare_ms = [], []
    batches = fit_batches()
    for _ in range(FIT_STEPS):
        b = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = bare_step(state, b)
        bare_losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        bare_ms.append(1e3 * (time.perf_counter() - t0))
    bare_params = [p.detach().cpu().clone() for p in state.model.parameters()]
    del state, bare_step, metrics
    with tempfile.TemporaryDirectory() as tmp:
        fit = fit_run(f"{tmp}/fit")
        st = fit["state"]
        fit_params = [p.detach().cpu().clone() for p in st.model.parameters()]
        fit_tensors = [t.detach().cpu().clone() for t in st.optimizer.state_tensors()]
        fit_gen = st.generator.get_state()
        fit_rows = [e for e in fit["events"] if e["event"] == "log"]
        fit_end = next(e for e in fit["events"] if e["event"] == "fit_end")
        del st, fit["state"], fit["captured"]
        check1 = {"losses_equal": fit["losses"] == bare_losses,
                  "params_equal": all(torch.equal(a, b) for a, b in zip(fit_params, bare_params))}
        del bare_params
        # preempt at FIT_KILL_AT, then resume from a fresh state and Trainer
        first = fit_run(f"{tmp}/run", trip_at=FIT_KILL_AT)
        del first["state"], first["captured"]
        resumed = fit_run(f"{tmp}/run", resume="auto")
        rs = resumed["state"]
        resume_ev = [e for e in resumed["events"] if e["event"] == "resume"]
        check2 = {
            "steps_run": [len(first["losses"]), len(resumed["losses"])],
            "losses_equal": resumed["losses"] == fit["losses"][FIT_KILL_AT:],
            "params_equal": all(torch.equal(p.detach().cpu(), q) for p, q in zip(rs.model.parameters(), fit_params)),
            "optimizer_equal": all(torch.equal(t.detach().cpu(), q)
                                   for t, q in zip(rs.optimizer.state_tensors(), fit_tensors)),
            "generator_equal": torch.equal(rs.generator.get_state(), fit_gen),
            "csv_steps": resumed["csv_steps"], "uninterrupted_csv_steps": fit["csv_steps"],
            "preempt_event": any(e["event"] == "fault.preempt" for e in resumed["events"]),
            "fast_forward_batches": [e["fast_forward_batches"] for e in resume_ev],
        }
        restore_end = next(e for e in resumed["events"] if e["event"] == "fit_end" and e["step"] == FIT_STEPS)
        del rs, resumed["state"], resumed["captured"], fit_tensors
        free_card()
        # the sentinel ladder: a skip, then a rollback in place
        held_skip = []
        ladder = fit_run(f"{tmp}/ladder", poison_at=FIT_POISON, held_skip=held_skip)
        ls = ladder["state"]
        captured = ladder["captured"]
        faults_seen = [(e["event"], e.get("step"), e.get("from_step"), e.get("to_step"))
                       for e in ladder["events"] if e["event"].startswith("fault.")]
        ladder_end = next(e for e in ladder["events"] if e["event"] == "fit_end")
        check3 = {"faults": faults_seen, "held_skip": held_skip, "captures": captured.captures,
                  "step": ls.step, "losses": ladder["losses"], "addresses_kept": ladder["addresses_kept"]}
        del ls, ladder["state"], captured, ladder["captured"]
        free_card()
        # the sentinel off: time only
        off = fit_run(f"{tmp}/off", sentinel=False)
        off_rows = [e for e in off["events"] if e["event"] == "log"]
        del off["state"], off["captured"]
        free_card()
    report.update(
        check1=check1, check2=check2, check3=check3,
        launches={k: fit["launches"].get(k, 0) for k in sorted(set(fit["launches"]) | set(want_launches))},
        want_launches=want_launches, losses=fit["losses"],
        bare_step_ms=bare_ms, bare_median_ms=statistics.median(bare_ms[1:]),
        fit_window_ms_sentinel_on=fit_window_ms(fit["events"]),
        fit_window_ms_sentinel_off=fit_window_ms(off["events"]),
        step_dispatch_ms={"sentinel_on": fit_dispatch_ms(fit["events"]),
                          "sentinel_off": fit_dispatch_ms(off["events"])},
        input_wait_ms=[r["input_wait_ms"] for r in fit_rows], goodput=[r["goodput"] for r in fit_rows],
        mfu=[r.get("mfu") for r in fit_rows], tokens_per_sec=[r.get("tokens_per_sec") for r in fit_rows],
        mfu_sentinel_off=[r.get("mfu") for r in off_rows],
        saves=fit["saves"], fit_end=fit_end, restore_fit_end=restore_end, ladder_fit_end=ladder_end,
        peak_memory_gb=fit["peak_gb"], fit_wall_s=fit["wall_s"],
    )
    log("fit_bf16: " + json.dumps(report))
    if not (check1["losses_equal"] and check1["params_equal"]):
        raise SystemExit(f"fit_bf16: the fit's losses or parameters are not the bare step's bit for bit: {check1}")
    if not (check2["steps_run"] == [FIT_KILL_AT, FIT_STEPS - FIT_KILL_AT] and check2["losses_equal"]
            and check2["params_equal"] and check2["optimizer_equal"] and check2["generator_equal"]
            and check2["csv_steps"] == check2["uninterrupted_csv_steps"] and check2["preempt_event"]
            and check2["fast_forward_batches"] == [FIT_KILL_AT]):
        raise SystemExit(f"fit_bf16: preempt and resume is not the uninterrupted fit: {check2}")
    want_faults = [("fault.skip", FIT_POISON[0], None, None), ("fault.skip", FIT_POISON[1], None, None),
                   ("fault.rollback", None, FIT_POISON[2], FIT_VAL)]
    if not (check3["faults"] == want_faults and check3["held_skip"] == [True] and check3["captures"] == 1
            and check3["step"] == FIT_STEPS and check3["addresses_kept"] is True
            and all(math.isfinite(x) for x in check3["losses"][-2:])):
        raise SystemExit(f"fit_bf16: the sentinel ladder went wrong (want {want_faults}): {check3}")
    if report["launches"] != {k: want_launches.get(k, 0) for k in report["launches"]}:
        raise SystemExit(f"fit_bf16: launches {report['launches']}, expected {want_launches}")
    TIMES["fit_bf16_ms_a_step"] = {"fit_sentinel_on": report["fit_window_ms_sentinel_on"],
                                   "fit_sentinel_off": report["fit_window_ms_sentinel_off"],
                                   "bare_median": report["bare_median_ms"]}
    return fit["launches"]


def chunk_activation_gb(dtype: torch.dtype, variant: str) -> float:
    """The device memory (GB) one training chunk's forward and backward of the
    flagship (batch 2, a host keep set) takes at its peak above what the
    model and its gradients hold, eagerly: the memory activation
    checkpointing and offloading exist to cut. A train step's own peak may
    lie elsewhere (the optimizer's update), so the two are printed apart."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    config = CausalLanguageModelConfig(**FLAGSHIP, **TRAIN_VARIANTS[variant])
    model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED), dtype=dtype)
    n, lat = FLAGSHIP["max_seq_len"], FLAGSHIP["max_latents"]
    rng = np.random.default_rng(SEED)
    t = torch.from_numpy(rng.integers(0, config.vocab_size, size=(TRAIN_CHUNK, n + 1))).cuda()
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, TRAIN_CHUNK, n - lat, config.cross_attention_dropout)}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = tt.clm_loss_fn(lat)(model, batch, torch.Generator(device="cuda").manual_seed(SEED))
    loss.backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del model, loss, t, batch
    free_card()
    return peak


def identical_runs(a: dict, b: dict) -> bool:
    """Two train runs' losses, loss after the NaN step, and parameters and
    gradients after the five steps equal bit for bit."""
    return (a["losses"] == b["losses"] and a["next_loss"] == b["next_loss"]
            and all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
            and all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])))


def train_pair(card: str, route: str = "concat", concat: dict = None, dtype: torch.dtype = torch.float32,
               variant: str = "", plain: dict = None) -> dict:
    """The train phase as a CUDA graph, then eagerly from the same seed: the
    graph's losses, parameters after five steps and loss after the NaN step
    against the eager run's, within ``GRAPH_RTOL`` relative, the differences
    printed; in bf16 they must be equal bit for bit. ``plain``: the pair of
    the same route and dtype without the variant, which a checkpointing or
    offloading variant must equal bit for bit (losses, gradients and
    parameters, graph against graph and eager against eager) at a lower peak
    of device memory: the step's peak over the memory held before its first
    call, and a chunk's forward and backward peak (``chunk_activation_gb``).
    Returns both runs by step kind."""
    runs = {}
    suffix = BF16 if dtype == torch.bfloat16 else ""
    label = "train" + (f"_{variant}" if variant else "") + f"_{route}{suffix}"
    for jit in (True, False):
        runs["graph" if jit else "eager"] = train_phase(card, route, jit, None if concat is None else
                                                        concat["graph" if jit else "eager"], dtype, variant)
        free_card()
    g, e = runs["graph"], runs["eager"]
    diffs = {"losses": [rel_diff(a, b) for a, b in zip(g["losses"], e["losses"])],
             "params": max(rel_diff(a, b) for a, b in zip(g["params"], e["params"])),
             "loss_after_nan_step": rel_diff(g["next_loss"], e["next_loss"])}
    identical = identical_runs(g, e)
    log(f"{label} graph against eager: " + json.dumps({
        "card": card, "identical": identical, "rel_diff": diffs, "rtol": GRAPH_RTOL,
        "median_step_ms": {k: r["median_step_ms"] for k, r in runs.items()},
        "peak_memory_gb": {k: r["peak_memory_gb"] for k, r in runs.items()},
        "busy_share": {k: r["busy_share"] for k, r in runs.items()},
        "profiled_kernels_ms": {k: r["kernels_ms"] for k, r in runs.items()}}))
    if not all(within(d, GRAPH_RTOL) for d in diffs["losses"] + [diffs["params"], diffs["loss_after_nan_step"]]):
        raise SystemExit(f"{label}: the graph's step leaves the eager step's: {diffs}")
    if suffix and not identical:
        raise SystemExit(f"{label}: the graph's losses and parameters are not the eager step's bit for "
                         f"bit: {diffs}")
    if plain is not None:
        activations = {v or "plain": chunk_activation_gb(dtype, v) for v in (variant, "")}
        log(f"{label} chunk forward and backward peak over the model and gradients, GB: " + json.dumps(
            {"card": card, **activations}))
        if not activations[variant] < activations["plain"]:
            raise SystemExit(f"{label}: a chunk's forward and backward peak {activations} not below the plain one's")
        TIMES[f"{label}_chunk_activation_gb"] = activations
        against = {kind: {"identical": identical_runs(runs[kind], plain[kind]),
                          "loss_rel_diff": [rel_diff(a, b) for a, b in zip(runs[kind]["losses"],
                                                                             plain[kind]["losses"])],
                          "params_rel_diff": max(rel_diff(a, b) for a, b in zip(runs[kind]["params"],
                                                                                 plain[kind]["params"])),
                          "median_step_ms": [runs[kind]["median_step_ms"], plain[kind]["median_step_ms"]],
                          "peak_memory_gb": [runs[kind]["peak_memory_gb"], plain[kind]["peak_memory_gb"]],
                          "step_peak_over_base_gb": [runs[kind]["step_peak_gb"], plain[kind]["step_peak_gb"]]}
                   for kind in runs}
        log(f"{label} against the plain step ([{variant}, plain]): " + json.dumps({"card": card, **against}))
        for kind, a in against.items():
            if not a["identical"]:
                raise SystemExit(f"{label} {kind}: not the plain step's losses, gradients and parameters bit for "
                                 f"bit: {a}")
            if not a["step_peak_over_base_gb"][0] < a["step_peak_over_base_gb"][1]:
                raise SystemExit(f"{label} {kind}: the step's peak over the memory before it is not below the "
                                 f"plain step's: {a}")
    TIMES[f"{label}_median_ms"] = {k: r["median_step_ms"] for k, r in runs.items()}
    TIMES[f"{label}_busy_share"] = {k: r["busy_share"] for k, r in runs.items()}
    TIMES[f"{label}_peak_memory_gb"] = {k: r["peak_memory_gb"] for k, r in runs.items()}
    return runs


def drop_params(*pairs: dict) -> None:
    """Free the parameter and gradient copies a pair kept for comparisons."""
    for pair in pairs:
        for r in pair.values():
            r.pop("params", None)
            r.pop("grads", None)


def dropout_replays_phase(card: str) -> None:
    """train_dropout_bf16's step at a learning rate of 0 (the parameters never
    move) on one fixed batch and keep set, three calls: the warm-up (eager),
    then two replays of the graph. The two replays must give different
    losses (the CUDA generator registered with the graph draws new masks at
    each replay), and the same calls eagerly, from the same generator seed,
    the same three losses bit for bit."""
    losses = {}
    for jit in (True, False):
        run = train_phase(card, jit=jit, dtype=torch.bfloat16, variant="dropout", lr=0.0, steps=3, fixed_keep=True)
        losses["graph" if jit else "eager"] = run["losses"]
        free_card()
    log("train_dropout_bf16 replays at lr 0: " + json.dumps({"card": card, **losses}))
    g = losses["graph"]
    if not (g[1] != g[2] and g[0] != g[1]):
        raise SystemExit(f"train_dropout_bf16: replays at lr 0 repeat a loss, the masks did not change: {g}")
    if losses["graph"] != losses["eager"]:
        raise SystemExit(f"train_dropout_bf16: the graph's replays are not the eager steps' bit for bit: {losses}")


def eval_twoseg_phase(card: str, dtype: torch.dtype = torch.float32) -> dict:
    """A cache-free, no-grad forward of the flagship at its full window
    (15360 prefix rows, 1024 latents, batch 1) on the concat route and under
    "twoseg", from the same weights and tokens: the logits must be finite and
    agree within 1e-4 (in bf16, ``eval_twoseg_bf16``: within
    ``TWOSEG_EVAL_L2_BF16`` of each other, L2 relative), and the twoseg
    forward must have run K6 once and K2 for the 8 self-attention layers only
    (in bf16, their bf16 builds and no f32 build). Returns the twoseg
    forward's launches."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels

    sfx = BF16 if dtype == torch.bfloat16 else ""
    name = "eval_twoseg" + sfx
    config = CausalLanguageModelConfig(**FLAGSHIP)
    model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED), dtype=dtype)
    ids = torch.from_numpy(np.random.default_rng(SEED + 3).integers(0, config.vocab_size,
                                                                     size=(1, FLAGSHIP["max_seq_len"]))).cuda()
    logits, launches, ms = {}, {}, {}
    for route in ("concat", "twoseg"):
        with torch.no_grad(), fast_kernels(ROUTE_FEATURES[route]):
            forward = lambda: model(ids, prefix_len=PREFIX_LEN).logits  # noqa: E731
            build.reset_launches()
            logits[route] = forward()
            torch.cuda.synchronize()
            launches[route] = dict(build.LAUNCHES)
            ms[route] = time_ms(forward, 5)
    err = max_err(logits["twoseg"], logits["concat"])
    rel_l2 = l2_err(logits["twoseg"], logits["concat"]) / float(logits["concat"].double().norm())
    tol = ("rel_l2", TWOSEG_EVAL_L2_BF16) if sfx else ("max_abs_err", 1e-4)
    log(f"{name}: " + json.dumps({
        "card": card, "dtype": str(dtype)[6:], "prefix": PREFIX_LEN, "latents": FLAGSHIP["max_latents"],
        "max_abs_err": err, "rel_l2": rel_l2, "tol": tol, "forward_ms": ms,
        "launches": {r: {k: v for k, v in l.items() if v} for r, l in launches.items()},
    }))
    want_shape = (1, FLAGSHIP["max_latents"], config.vocab_size)
    if any(tuple(x.shape) != want_shape or not bool(torch.isfinite(x).all()) for x in logits.values()):
        raise SystemExit(f"{name}: logits not finite or not of shape {want_shape}")
    if not within(rel_l2 if sfx else err, tol[1]):
        raise SystemExit(f"{name}: twoseg logits differ from the concat route's by {tol[0]} "
                         f"{rel_l2 if sfx else err} > {tol[1]}")
    got = [(r, launches[r]["flash_2seg_fwd" + sfx], launches[r]["flash_packed_fwd" + sfx]) for r in launches]
    if got != [("concat", 0, 9), ("twoseg", 1, 8)]:
        raise SystemExit(f"{name}: (route, K6, K2) launches {got}, expected concat 0/9 and twoseg 1/8")
    if sfx and any(launches[r][k] for r in launches for k in ("flash_2seg_fwd", "flash_packed_fwd")):
        raise SystemExit(f"{name}: f32 builds launched in a bf16 forward: {launches}")
    TIMES[name + "_forward_ms"] = ms
    return launches["twoseg"]


def grad_check_phase(card: str, route: str = "concat") -> None:
    """One train-step gradient at full width (512 channels, 8 heads; 2048
    tokens, 256 latents, 2 layers, batch 2, a fixed keep set) on the card
    against the CPU's plain versions, from the same weights, on the concat
    route or under "twoseg" on both sides; per parameter, max abs difference
    over the CPU gradient's max abs value. Then one optimizer update (clip
    1.0, AdamW lr 1e-3, as the train phase) from those gradients on each
    side: the card's update against the CPU's, as the L2 norm of their
    difference over the CPU update's norm."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels

    config = CausalLanguageModelConfig(**dict(FLAGSHIP, max_seq_len=2048, max_latents=256,
                                              num_self_attention_layers=2))
    rng = np.random.default_rng(SEED + 2)
    t = rng.integers(0, config.vocab_size, size=(2, 2049))
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 2, 2048 - 256, config.cross_attention_dropout)}
    cpu_model = CausalLanguageModel(config, device="cpu", generator=torch.Generator().manual_seed(SEED))
    card_model = CausalLanguageModel(config, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    grads, losses, updates = [], [], []
    for model in (cpu_model, card_model):
        build.reset_launches()
        with fast_kernels(ROUTE_FEATURES[route]):
            loss, _ = tt.clm_loss_fn(256)(model, batch)
        loss.backward()
        losses.append(float(loss.detach()))
        # copies: the update below clips the gradients in place
        grads.append({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()})
        before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        tt.TrainState.create(model, tt.make_optimizer(TRAIN_LR, gradient_clip=1.0)).apply_gradients()
        updates.append(torch.cat([(p.detach().cpu() - before[n]).flatten() for n, p in model.named_parameters()]))
    ca_kernels = {k: build.LAUNCHES[k] for k in ("flash_packed_fwd", "flash_2seg_fwd", "flash_2seg_bwd_dkv",
                                                 "flash_2seg_bwd_dq")}
    want = [3, 0, 0, 0] if route == "concat" else [2, 1, 1, 1]  # the card's CA + 2 SA layers
    if list(ca_kernels.values()) != want:
        raise SystemExit(f"grad_check {route}: the card's launches {ca_kernels}, expected {want}")
    rel = {n: float((grads[1][n] - g).abs().max() / g.abs().max()) for n, g in grads[0].items()}
    worst = sorted(rel.items(), key=lambda kv: -kv[1] if math.isfinite(kv[1]) else -math.inf)[:3]
    update_err = float((updates[1] - updates[0]).norm() / updates[0].norm())
    # about three and four times the largest differences measured on the
    # card: the gradients 3.2e-6 (f32 on both sides, the sums run in other
    # orders; the card's gradient repeats bit for bit between processes,
    # PERF.md), well inside 1e-3; the update 7.7e-5 (the first AdamW update is about
    # lr * sign(g), and gradients within their rounding of 0 may take
    # opposite signs on the two sides). A zero update, a wrong sign or a rate
    # 1% off is off by 1e-2 or more
    tol, update_tol = 1e-5, 3e-4
    name = "grad_check" if route == "concat" else "grad_check_twoseg"
    log(f"{name}: " + json.dumps({"card": card, "cpu_threads": torch.get_num_threads(),
                                     "loss_cpu": losses[0], "loss_card": losses[1],
                                     "max_rel_err": worst[0][1], "tol": tol, "worst": worst,
                                     "n_params": len(rel), "update_rel_err": update_err,
                                     "update_tol": update_tol}))
    if not all(within(r, tol) for r in rel.values()):
        raise SystemExit(f"{name} failed: {worst}")
    if not within(update_err, update_tol):
        raise SystemExit(f"{name}: the card's optimizer update differs from the CPU's by {update_err}")


def grad_check_bf16_phase(card: str, route: str = "concat") -> None:
    """grad_check's model and batch (2048 tokens, 256 latents, 2 layers,
    full width) in bf16 compute on the card against the CPU, on the concat
    route or under "twoseg" on every side (``grad_check_twoseg_bf16``): per
    parameter, the card's bf16 gradient lies no further from the CPU's f32
    gradient than 1.5x the CPU's bf16 gradient (the plain versions, the same
    rounding points) does (L2). Both bf16 gradients carry bf16's rounding;
    the check asks the card's to carry no more than the CPU's evaluation of
    the same arithmetic."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels

    config = CausalLanguageModelConfig(**dict(FLAGSHIP, max_seq_len=2048, max_latents=256,
                                              num_self_attention_layers=2))
    rng = np.random.default_rng(SEED + 2)
    t = rng.integers(0, config.vocab_size, size=(2, 2049))
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 2, 2048 - 256, config.cross_attention_dropout)}
    weights = CausalLanguageModel(config, device="cpu", generator=torch.Generator().manual_seed(SEED)).state_dict()
    grads, losses = {}, {}
    for name, device, dtype in (("cpu_f32", "cpu", torch.float32), ("cpu_bf16", "cpu", torch.bfloat16),
                                ("card_bf16", "cuda", torch.bfloat16)):
        model = CausalLanguageModel(config, device=device, dtype=dtype)
        model.load_state_dict(weights)
        build.reset_launches()
        with fast_kernels(ROUTE_FEATURES[route]):
            loss, _ = tt.clm_loss_fn(256)(model, batch)
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    phase = "grad_check_bf16" if route == "concat" else "grad_check_twoseg_bf16"
    kernels = ("flash_packed_bwd_dq", "flash_2seg_bwd_dq")
    launches = {k + sfx: build.LAUNCHES[k + sfx] for k in kernels for sfx in (BF16, "")}
    # the card's CA (K4b, or K7b under twoseg) and 2 SA layers (K4b), all bf16
    ca = "flash_packed_bwd_dq" if route == "concat" else "flash_2seg_bwd_dq"
    want = {k + sfx: 0 for k in kernels for sfx in (BF16, "")}
    want["flash_packed_bwd_dq" + BF16] += 2
    want[ca + BF16] += 1
    if launches != want:
        raise SystemExit(f"{phase}: the card's launches {launches}, expected {want}")
    ratios = {n: l2_err(g, grads["cpu_f32"][n]) / max(l2_err(grads["cpu_bf16"][n], grads["cpu_f32"][n]), 1e-30)
              for n, g in grads["card_bf16"].items()}
    worst = sorted(ratios.items(), key=lambda kv: -kv[1] if math.isfinite(kv[1]) else -math.inf)[:3]
    log(f"{phase}: " + json.dumps({"card": card, "cpu_threads": torch.get_num_threads(), "losses": losses,
                                    "max_ratio": worst[0][1], "ratio_tol": 1.5, "worst": worst,
                                    "n_params": len(ratios)}))
    if not all(within(r, 1.5) for r in ratios.values()):
        raise SystemExit(f"{phase} failed: {worst}")


# the optim phase's optimizers (make_optimizer's arguments beside lr 1e-3 and
# clip 1.0); "frozen" freezes the first self-attention layer by the JAX
# package's path string
OPTIM_VARIANTS = {
    "adam": dict(optimizer="adam"),
    "adam_bf16_moments": dict(optimizer="adam", moment_dtype="bfloat16"),
    "lamb": dict(optimizer="lamb"),
    "sgd": dict(optimizer="sgd"),
    "adamw_accumulate2_frozen": dict(accumulate_grad_batches=2, frozen=["perceiver_ar/self_attention/layer_0"]),
    "lamb_accumulate3": dict(optimizer="lamb", accumulate_grad_batches=3),
}
OPTIM_CALLS = 4
# the card's parameters after OPTIM_CALLS calls against the CPU's from the
# same parameters and gradients, max abs difference over the largest
# parameter: the two run the same f32 operations (f64 for the compact
# moments' fused sums), whose results the card's and the CPU's kernels may
# round apart where a library function (pow, the norms' sums) differs in its
# last bit; a wrong rule, rate or selection is off by the update itself
# (lr 1e-3 against parameters of 0.1). The other state tensors (moments,
# the running mean, the counts) each within 1e-4 of their largest value: the
# clip's norm sums 4.4M squares in f32 in other orders on the two sides
# (measured 1.8e-5 apart on an H100 80GB HBM3), and the first moment is the
# clipped gradient's. With bf16 moments a moment that lies at a bf16 rounding
# boundary may round to its other neighbour on one side (the clip's scale
# differs in its last bit), as tests/test_torch_bf16_optim.py finds against
# optax: the moments within one bf16 step (2^-7 relative), the parameters
# within 3 x lr x 2^-7 (absolute)
OPTIM_CPU_TOL = {"params": 1e-6, "state": 1e-4}
OPTIM_CPU_TOL_BF16 = {"params": 3 * TRAIN_LR * 2**-7, "state": 2**-7}


def optim_phase(card: str) -> None:
    """Each optimizer of ``OPTIM_VARIANTS`` twice. First in
    ``make_train_step`` (the sentinel on, batch 2 in one chunk) on
    grad_check's model (full width, 2048 tokens, 256 latents, 2 layers) and
    batches, as a CUDA graph and eagerly from the same weights: losses,
    parameters and every optimizer state tensor after ``OPTIM_CALLS`` calls
    equal bit for bit. Then the optimizer alone on the card against the
    CPU: the same parameters and seeded gradients, ``OPTIM_CALLS`` calls,
    parameters and state within ``OPTIM_CPU_TOL`` (``OPTIM_CPU_TOL_BF16``
    with bf16 moments)."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    config = CausalLanguageModelConfig(**dict(FLAGSHIP, max_seq_len=2048, max_latents=256,
                                              num_self_attention_layers=2))
    weights = CausalLanguageModel(config, device="cpu", generator=torch.Generator().manual_seed(SEED)).state_dict()
    rng = np.random.default_rng(SEED + 6)
    batches = []
    for _ in range(OPTIM_CALLS):
        t = rng.integers(0, config.vocab_size, size=(2, 2049))
        batches.append({"input_ids": torch.from_numpy(t[:, :-1]).cuda(), "labels": torch.from_numpy(t[:, 1:]).cuda(),
                        "pad_mask": None, "prefix_keep_idx": tt.sample_prefix_keep_idx(
                            rng, 2, 2048 - 256, config.cross_attention_dropout)})

    def tx(model, options):
        options = dict(options)
        frozen = options.pop("frozen", None)
        mask = None if frozen is None else tt.freeze_mask(model, frozen)
        return tt.make_optimizer(TRAIN_LR, gradient_clip=1.0, frozen_mask=mask, **options)

    report = {}
    for name, options in OPTIM_VARIANTS.items():
        runs = {}
        for jit in (True, False):
            model = CausalLanguageModel(config, device="cuda")
            model.load_state_dict(weights)
            state = tt.TrainState.create(model, tx(model, options))
            step = tt.make_train_step(tt.clm_loss_fn(256), sentinel=True, jit=jit)
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
            runs[jit] = (losses, [t.detach().cpu().clone() for t in state.optimizer.state_tensors()])
            del model, state, step
            free_card()
        graph_eager = runs[True][0] == runs[False][0] and all(
            torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
        # the optimizer alone, on the card and on the CPU
        states = {}
        for device in ("cpu", "cuda"):
            model = CausalLanguageModel(config, device=device)
            model.load_state_dict(weights)
            opt = tx(model, options)(model.named_parameters())
            gen = torch.Generator().manual_seed(SEED + 7)
            for _ in range(OPTIM_CALLS):
                for p in model.parameters():
                    p.grad = (torch.randn(p.shape, generator=gen) * 1e-2).to(device)
                opt.step()
            states[device] = [t.detach().cpu() for t in opt.state_tensors()]
            del model, opt
        # the parameters lead state_tensors(); the model's state_dict is its parameters
        n = len(weights)
        p_err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(states["cuda"][:n], states["cpu"][:n]))
        p_scale = max(float(t.abs().max()) for t in states["cpu"][:n])
        s_err = max([rel_diff(a, b) for a, b in zip(states["cuda"][n:], states["cpu"][n:])] or [0.0])
        bf16 = "moment_dtype" in options
        errs = {"params": p_err if bf16 else p_err / p_scale, "state": s_err}
        tols = OPTIM_CPU_TOL_BF16 if bf16 else OPTIM_CPU_TOL
        report[name] = {"losses": runs[True][0], "graph_equals_eager": graph_eager, "card_vs_cpu": errs,
                        "card_vs_cpu_tol": tols, "params": "absolute" if bf16 else "relative to the largest"}
        free_card()
    log("optim: " + json.dumps({"card": card, "calls": OPTIM_CALLS, "cpu_threads": torch.get_num_threads(),
                                **report}))
    bad = {k: r for k, r in report.items() if not (
        r["graph_equals_eager"] and all(np.isfinite(r["losses"]))
        and all(within(r["card_vs_cpu"][x], r["card_vs_cpu_tol"][x]) for x in ("params", "state")))}
    if bad:
        raise SystemExit(f"optim: {bad}")


# ---------------------------------------------------------------------------
# the Perceiver IO image classifier
# ---------------------------------------------------------------------------


def image_classifier(device, dtype: torch.dtype = torch.float32, activation_checkpointing: bool = False,
                     **encoder_overrides):
    """The flagship classifier (``IMAGE_ENCODER``), seeded random weights (f32
    parameters; ``dtype`` the compute dtype), with activation checkpointing
    where asked, as ``bench.py --remat`` passes it."""
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig

    config = ImageClassifierConfig(
        encoder=ImageEncoderConfig(**dict(IMAGE_ENCODER, **encoder_overrides)),
        decoder=ClassificationDecoderConfig(**IMAGE_DECODER),
        num_latents=IMAGE_LATENTS, num_latent_channels=IMAGE_CHANNELS,
        activation_checkpointing=activation_checkpointing,
    )
    return ImageClassifier(config, dtype=dtype, device=device, generator=torch.Generator().manual_seed(SEED))


def image_batch(batch: int, image_shape, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(batch,) + tuple(image_shape)).astype(np.float32),
            "label": rng.integers(0, IMAGE_DECODER["num_classes"], size=batch)}


def check_launches(name: str, launches: dict, want: dict, times: int) -> None:
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v * times}
    if wrong:
        raise SystemExit(f"{name}: launches {wrong}, expected {times} x {want}")


def image_eval_phase(card: str, dtype: torch.dtype = torch.float32, f32_logits: torch.Tensor = None) -> dict:
    """The flagship classifier's forward at batch 16 through ``make_eval_step``
    (``no_grad``; a CUDA graph on the card), on the split-kv route (the
    default) and on the standard route (an all-False pad mask: the joined
    (B, 50176, 261) input, kv_norm, K8 on the 261-wide head the wrapper pads
    to 264), from the same weights and images: the first call of each (the
    warm-up, an eager forward) launches ``IMAGE_FORWARD`` exactly (the
    standard route adds the kv_norm's K1) and gives finite logits of shape
    (16, 1000) that agree within ``IMAGE_ROUTE_TOL`` across routes; a replay
    gives the eager forward's logits within ``GRAPH_RTOL``. With ``dtype``
    bf16 (``image_eval_bf16``): every launch a bf16 build (``IMAGE_FORWARD``
    under the bf16 names; the standard route's kv_norm reads the f32 joined
    input, one f32 K1), a replay equal to the eager forward bit for bit, the
    routes within ``IMAGE_ROUTE_TOL_BF16`` of each other and each within
    ``IMAGE_BF16_TOL`` of the f32 forward's logits (``f32_logits``), all
    relative in L2. Returns the split forward's launches and logits."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.ops import build

    bf16 = dtype == torch.bfloat16
    name = "image_eval" + (BF16 if bf16 else "")
    model = image_classifier("cuda", dtype)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: image classifier {IMAGE_ENCODER} {IMAGE_DECODER}, {IMAGE_LATENTS} x {IMAGE_CHANNELS} latents, "
        f"{n_params} parameters (f32), compute {str(dtype)[6:]}")
    x = torch.from_numpy(image_batch(IMAGE_BATCH, IMAGE_ENCODER["image_shape"], SEED + 4)["image"]).cuda()
    routes = {"split": {"image": x},
              "standard": {"image": x, "pad_mask": torch.zeros(IMAGE_BATCH, IMAGE_PIXELS, dtype=torch.bool,
                                                               device="cuda")}}
    forward_launches = IMAGE_FORWARD_BF16 if bf16 else IMAGE_FORWARD
    kv_norm = {"layer_norm_fwd": 1} if bf16 else {"layer_norm_fwd": IMAGE_FORWARD["layer_norm_fwd"] + 1}
    want = {"split": forward_launches, "standard": dict(forward_launches, **kv_norm)}

    def forward(model, batch):
        return model(batch["image"], pad_mask=batch.get("pad_mask"))

    logits, launches, ms, wall, graph_err = {}, {}, {}, {}, {}
    for route, batch in routes.items():
        step = tt.make_eval_step(forward)
        build.reset_launches()
        logits[route] = step(model, batch)
        torch.cuda.synchronize()
        launches[route] = dict(build.LAUNCHES)
        check_graph(f"{name}_{route}", step.captured.graph, nonzero_launches(), want[route])
        replay = step(model, batch)
        graph_err[route] = 0.0 if torch.equal(replay, logits[route]) else rel_diff(replay, logits[route])
        with torch.no_grad():
            ms[route] = time_ms(lambda: forward(model, batch), 5)
            wall[route] = {"graph": wall_ms(lambda: step(model, batch)), "eager": wall_ms(lambda: forward(model, batch))}
        del step
        free_card()
    want_shape = (IMAGE_BATCH, IMAGE_DECODER["num_classes"])
    if any(tuple(t.shape) != want_shape or not bool(torch.isfinite(t).all()) for t in logits.values()):
        raise SystemExit(f"{name}: logits not finite or not of shape {want_shape}")
    if bf16:
        # L2 distances relative to the f32 forward's logits' L2 size
        size = float(f32_logits.double().norm())
        err = l2_err(logits["split"], logits["standard"]) / size
        to_f32 = {r: l2_err(t, f32_logits) / size for r, t in logits.items()}
        tols = {"route": IMAGE_ROUTE_TOL_BF16, "to_f32": IMAGE_BF16_TOL, "graph": 0.0}
    else:
        err, to_f32 = max_err(logits["split"], logits["standard"]), None
        tols = {"route": IMAGE_ROUTE_TOL, "graph": GRAPH_RTOL}
    log(f"{name}: " + json.dumps({
        "card": card, "batch": IMAGE_BATCH, "dtype": str(dtype)[6:],
        ("l2_rel_split_vs_standard" if bf16 else "max_abs_err_split_vs_standard"): err, "l2_rel_to_f32": to_f32,
        "tols": tols, "graph_rel_diff_to_eager": graph_err, "forward_ms": ms, "wall_ms": wall,
        "images_per_s": {r: {k: IMAGE_BATCH / (t / 1e3) for k, t in w.items()} for r, w in wall.items()},
        "launches": {r: {k: v for k, v in l.items() if v} for r, l in launches.items()},
    }))
    TIMES[f"{name}_images_per_s"] = {k: IMAGE_BATCH / (t / 1e3) for k, t in wall["split"].items()}
    if not within(err, tols["route"]):
        raise SystemExit(f"{name}: the split route's logits differ from the standard route's by {err}")
    if bf16 and not all(within(e, tols["to_f32"]) for e in to_f32.values()):
        raise SystemExit(f"{name}: the bf16 logits leave the f32 forward's by {to_f32}")
    if not all(within(e, tols["graph"]) for e in graph_err.values()):
        raise SystemExit(f"{name}: the graph's logits leave the eager forward's: {graph_err}")
    for route in routes:
        check_launches(f"{name} {route}", launches[route], want[route], 1)
    return {"launches": launches["split"], "logits": logits["split"]}


class TrainTask(typing.NamedTuple):
    """One model's train step and its checks against the CPU's plain
    versions: ``model_train_phase``, ``model_train_pair``,
    ``model_grad_check_phase`` and ``model_trajectory_phase`` (``TASKS``)."""

    stem: str  # the phases' names: <stem>_train, <stem>_grad_check, <stem>_trajectory
    model: object  # (device, dtype, small=False, remat=False) -> the model, seeded; small: the checks' size
    batch: object  # (size, seed, small=False) -> a numpy batch
    loss_fn: object  # the loss-function factory: its name in training, or the factory
    step: dict  # a full-size f32 step's launches (their bf16 builds in bf16)
    batch_size: int
    lr: float
    steps: int
    trajectory_steps: int
    seeds: tuple  # the train batch's, the gradient check's and the trajectory's
    check_heads: int  # K8's, K9a's and K9b's launches each in the card's gradient at the checks' size
    grad_tol: float = None  # the f32 gradient check's, per parameter (None: checked in bf16 only)
    update_tol: float = None  # the f32 optimizer update's L2 distance, relative (None: not compared)
    first_step_lowers: bool = True  # else a later step below the first
    remat_step: dict = None  # a bf16 step's launches with activation checkpointing


def loss_factory(task: TrainTask):
    """The task's loss-function factory (``factory()`` the train loss,
    ``factory(deterministic=True)`` the checks')."""
    from perceiver_io_tpu_torch import training as tt

    return getattr(tt, task.loss_fn) if isinstance(task.loss_fn, str) else task.loss_fn


def model_train_phase(card: str, task: TrainTask, jit: bool = True, dtype: torch.dtype = torch.float32,
                      remat: bool = False) -> dict:
    """``task.steps`` AdamW steps (lr ``task.lr``, f32 moments, global clip
    1.0) of a model at full width on one fixed batch of ``task.batch_size``
    in one chunk, with the non-finite sentinel on, as a CUDA graph (``jit``)
    or eagerly: every loss finite, no step skipped, the loss lowered (by the
    first step, or with ``first_step_lowers`` false by a later one: on random
    weights Adam's first step, the rate times the sign of every gradient
    element, raises the text classifier's and the time series' loss on the
    card and on the CPU alike, see their trajectories), ``task.step``'s
    launches each step exactly (bf16: every launch a bf16 build; ``remat``:
    activation checkpointing, ``task.remat_step``'s) and the graph's kernel
    nodes by ``check_graph``; then one profiled step. Returns the steps'
    launches, losses, median step ms (the first step, which captures the
    graph, left out), busy share, peak memory and the parameters after
    them."""
    from torch.profiler import ProfilerActivity, profile

    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.ops import build

    bf16 = dtype == torch.bfloat16
    name = f"{task.stem}_train" + ("_remat" if remat else "") + (BF16 if bf16 else "") + ("" if jit else "_eager")
    want = task.remat_step if remat else as_bf16(task.step) if bf16 else task.step
    model = task.model("cuda", dtype, remat=remat)
    batch = {k: None if v is None else torch.from_numpy(v).cuda()
             for k, v in task.batch(task.batch_size, task.seeds[0]).items()}
    state = tt.TrainState.create(model, tt.make_optimizer(task.lr, gradient_clip=1.0))
    step = tt.make_train_step(loss_factory(task)(), sentinel=True, jit=jit)
    losses, step_ms, skipped = [], [], []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i in range(task.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        skipped.append(float(metrics["sentinel_skipped"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0 and jit:
            check_graph(name, step.captured.graph, nonzero_launches(), want)
    launches = dict(build.LAUNCHES)
    params = [p.detach().clone() for p in model.parameters()]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    summary = profile_summary(prof, prof_ms)
    log(f"{name}_profile: " + json.dumps({"card": card, **summary}))
    median_ms = statistics.median(step_ms[1:])
    log(f"{name}: " + json.dumps({
        "card": card, "step": "graph" if jit else "eager", "dtype": str(dtype)[6:], "batch": task.batch_size,
        "microbatch": 1, "lr": task.lr, "steps": task.steps, "losses": losses, "step_ms": step_ms,
        "median_step_ms": median_ms, "samples_per_s": task.batch_size / (median_ms / 1e3),
        "peak_memory_gb": peak_gb, "sentinel_skipped": skipped, "device_busy_share": summary["device_busy_share"],
        "launches_per_step": {k: launches[k] / task.steps for k in want}}))
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{name}: non-finite loss {losses}")
    if not (losses[1] if task.first_step_lowers else min(losses[1:])) < losses[0]:
        raise SystemExit(f"{name}: the loss did not fall below the first: {losses}")
    if any(skipped):
        raise SystemExit(f"{name}: the sentinel skipped a step: {skipped}")
    check_launches(name, launches, want, task.steps)
    return {"launches": launches, "losses": losses, "median_step_ms": median_ms,
            "busy_share": summary["device_busy_share"], "params": params, "peak_memory_gb": peak_gb}


def model_train_pair(card: str, task: TrainTask, dtype: torch.dtype = torch.float32, remat: bool = False,
                     plain: dict = None) -> dict:
    """The model's train phase as a CUDA graph, then eagerly, from the same
    weights and batch: the losses within ``GRAPH_RTOL`` relative, the
    differences printed; in bf16 the losses and the parameters after the
    steps equal bit for bit. With ``remat`` against ``plain`` (the pair
    without it): each step's loss within ``IMAGE_REMAT_LOSS_TOL`` of the
    plain step's (another route, see there) at a lower peak of device
    memory. Returns the graph run's launches, both runs' losses and peaks."""
    runs = {}
    name = f"{task.stem}_train" + ("_remat" if remat else "") + (BF16 if dtype == torch.bfloat16 else "")
    for jit in (True, False):
        runs["graph" if jit else "eager"] = model_train_phase(card, task, jit, dtype, remat)
        free_card()
    g, e = runs["graph"], runs["eager"]
    diffs = [rel_diff(a, b) for a, b in zip(g["losses"], e["losses"])]
    identical = g["losses"] == e["losses"] and all(torch.equal(a, b) for a, b in zip(g["params"], e["params"]))
    peaks = {k: r["peak_memory_gb"] for k, r in runs.items()}
    log(f"{name} graph against eager: " + json.dumps({
        "card": card, "identical": identical, "loss_rel_diff": diffs, "rtol": GRAPH_RTOL,
        "median_step_ms": {k: r["median_step_ms"] for k, r in runs.items()},
        "busy_share": {k: r["busy_share"] for k, r in runs.items()}, "peak_memory_gb": peaks}))
    if not all(within(d, GRAPH_RTOL) for d in diffs):
        raise SystemExit(f"{name}: the graph's losses leave the eager step's: {diffs}")
    if dtype == torch.bfloat16 and not identical:
        raise SystemExit(f"{name}: the graph's losses and parameters are not the eager step's bit for bit: {diffs}")
    TIMES[f"{name}_median_ms"] = {k: r["median_step_ms"] for k, r in runs.items()}
    TIMES[f"{name}_busy_share"] = {k: r["busy_share"] for k, r in runs.items()}
    TIMES[f"{name}_peak_memory_gb"] = peaks
    if plain is not None:
        base = f"{task.stem}_train" + BF16
        against = {kind: {"loss_rel_diff": [rel_diff(a, b) for a, b in zip(runs[kind]["losses"],
                                                                             plain["losses"][kind])],
                          "peak_memory_gb": [peaks[kind], plain["peak_memory_gb"][kind]],
                          "median_step_ms": [runs[kind]["median_step_ms"], TIMES[base + "_median_ms"][kind]]}
                   for kind in runs}
        log(f"{name} against {base} ([remat, plain]): " + json.dumps({
            "card": card, "loss_tol": IMAGE_REMAT_LOSS_TOL, **against}))
        for kind, a in against.items():
            if not all(within(d, IMAGE_REMAT_LOSS_TOL) for d in a["loss_rel_diff"]):
                raise SystemExit(f"{name} {kind}: losses leave {base}'s: {a}")
            if not a["peak_memory_gb"][0] < a["peak_memory_gb"][1]:
                raise SystemExit(f"{name} {kind}: peak memory not below {base}'s: {a}")
    return {"launches": g["launches"], "losses": {k: r["losses"] for k, r in runs.items()}, "peak_memory_gb": peaks}


def model_grad_check_phase(card: str, task: TrainTask, dtype: torch.dtype = torch.float32) -> None:
    """One loss's gradient of the model at the checks' size (``small``; batch
    2) on the card against the CPU's plain versions, from the same weights
    and batch, per parameter. f32: max abs difference over the CPU
    gradient's max abs value within ``task.grad_tol``; then, where
    ``task.update_tol`` is set, one optimizer update (clip 1.0, AdamW at
    ``task.lr``) from those gradients on each side, the L2 norm of their
    difference over the CPU update's norm within it. bf16: the card's bf16
    gradient no further from the CPU's f32 gradient than 1.5x the CPU's bf16
    gradient (the plain versions, the same rounding points) is, in L2. The
    key-projection biases, whose gradient is 0 in exact arithmetic, against
    an absolute bound instead: 1e-6 (f32) or ``ZERO_GRAD_BF16`` (on both
    bf16 sides) of the largest f32 gradient. The card's pass launches K8,
    K9a and K9b ``task.check_heads`` times each, in the build of its dtype
    only."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.ops import build

    bf16 = dtype == torch.bfloat16
    name = f"{task.stem}_grad_check" + (BF16 if bf16 else "")
    batch = task.batch(2, task.seeds[1], small=True)
    loss_fn = loss_factory(task)(deterministic=True)
    sides = ((("cpu_f32", "cpu", torch.float32), ("cpu_bf16", "cpu", dtype), ("card_bf16", "cuda", dtype)) if bf16
             else (("cpu_f32", "cpu", torch.float32), ("card_f32", "cuda", torch.float32)))
    grads, losses, seconds, updates = {}, {}, {}, {}
    for side, device, dt in sides:
        t0 = time.perf_counter()
        model = task.model(device, dt, small=True)
        build.reset_launches()
        loss, _ = loss_fn(model, batch)
        loss.backward()
        losses[side] = float(loss.detach())
        grads[side] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        if task.update_tol is not None and not bf16:
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            tt.TrainState.create(model, tt.make_optimizer(task.lr, gradient_clip=1.0)).apply_gradients()
            updates[side] = torch.cat([(p.detach().cpu() - before[n]).flatten()
                                       for n, p in model.named_parameters()])
        seconds[side] = time.perf_counter() - t0
        del model
    want = {k + sfx: task.check_heads if (sfx == BF16) == bf16 else 0 for k in HEADS_KERNELS for sfx in ("", BF16)}
    heads = {k: build.LAUNCHES[k] for k in want}
    if heads != want:
        raise SystemExit(f"{name}: the card's heads-major launches {heads}, expected {want}")
    ref, card_side = grads["cpu_f32"], sides[-1][0]
    zero = {n for n in ref if n.endswith("attention.k_proj.bias")}
    scale = max(float(g.abs().max()) for g in ref.values())
    if bf16:
        errs = {n: l2_err(g, ref[n]) / max(l2_err(grads["cpu_bf16"][n], ref[n]), 1e-30)
                for n, g in grads[card_side].items() if n not in zero}
        tol, zero_sides, zero_tol = 1.5, ("cpu_bf16", card_side), ZERO_GRAD_BF16 * scale
    else:
        errs = {n: float((grads[card_side][n] - g).abs().max() / g.abs().max()) for n, g in ref.items()
                if n not in zero}
        tol, zero_sides, zero_tol = task.grad_tol, ("cpu_f32", card_side), 1e-6 * scale
    zero_max = max((float(grads[s][n].abs().max()) for s in zero_sides for n in zero), default=0.0)
    worst = sorted(errs.items(), key=lambda kv: -kv[1] if math.isfinite(kv[1]) else -math.inf)[:3]
    update_err = float((updates[card_side] - updates["cpu_f32"]).norm() / updates["cpu_f32"].norm()) \
        if updates else None
    log(f"{name}: " + json.dumps({
        "card": card, "cpu_threads": torch.get_num_threads(), "losses": losses, "seconds": seconds,
        "rule": "L2 ratio to the CPU's bf16 gradient" if bf16 else "max abs err relative", "max": worst[0][1],
        "tol": tol, "worst": worst, "n_params": len(errs), "zero_grad_max": zero_max, "zero_grad_tol": zero_tol,
        "update_rel_err": update_err, "update_tol": task.update_tol if updates else None, "heads": heads}))
    if not all(within(e, tol) for e in errs.values()):
        raise SystemExit(f"{name} failed: {worst}")
    if not within(zero_max, zero_tol):
        raise SystemExit(f"{name}: key-bias gradients {zero_max} > {zero_tol}")
    if updates and not within(update_err, task.update_tol):
        raise SystemExit(f"{name}: the card's optimizer update differs from the CPU's by {update_err}")


def model_trajectory_phase(card: str, task: TrainTask) -> None:
    """``task.trajectory_steps`` train steps (``make_train_step`` with the
    sentinel, AdamW at ``task.lr``, clip 1.0) of the model at the checks'
    size, f32, on one fixed batch of 2 on the card and on the CPU's plain
    versions, from the same weights: each step's loss within
    ``IMAGE_TRAJECTORY_TOL`` of the CPU's, relative, and no step skipped.
    Where a train phase's losses rise, this phase says whether the port or
    the optimizer makes them."""
    from perceiver_io_tpu_torch import training as tt

    name = f"{task.stem}_trajectory"
    batch = task.batch(2, task.seeds[2], small=True)
    losses, skipped, seconds = {}, {}, {}
    for device in ("cpu", "cuda"):
        model = task.model(device, torch.float32, small=True)
        state = tt.TrainState.create(model, tt.make_optimizer(task.lr, gradient_clip=1.0))
        step = tt.make_train_step(loss_factory(task)(), sentinel=True)
        losses[device], skipped[device] = [], []
        t0 = time.perf_counter()
        for _ in range(task.trajectory_steps):
            state, metrics = step(state, batch)
            losses[device].append(float(metrics["loss"]))
            skipped[device].append(float(metrics["sentinel_skipped"]))
        seconds[device] = time.perf_counter() - t0
        del model, state, step
    rel = [abs(g - c) / abs(c) for c, g in zip(losses["cpu"], losses["cuda"])]
    log(f"{name}: " + json.dumps({
        "card": card, "lr": task.lr, "losses_cpu": losses["cpu"], "losses_card": losses["cuda"],
        "rel_err": rel, "tol": IMAGE_TRAJECTORY_TOL, "sentinel_skipped": skipped, "seconds": seconds}))
    if not all(within(r, IMAGE_TRAJECTORY_TOL) for r in rel):
        raise SystemExit(f"{name}: the card's losses {losses['cuda']} leave the CPU's {losses['cpu']}")
    if any(skipped["cpu"] + skipped["cuda"]):
        raise SystemExit(f"{name}: the sentinel skipped a step: {skipped}")


# ---------------------------------------------------------------------------
# the Perceiver IO task models (ROADMAP A13, part 1): the masked LM and its
# mask filler, the text classifier, optical flow and the time series
# ---------------------------------------------------------------------------


def mlm_model(device, dtype: torch.dtype = torch.float32, layers: int = None, classifier: bool = False):
    """The masked LM (or, with ``classifier``, the text classifier over its
    encoder) at ``MLM_ENCODER``'s width, seeded random weights, with
    ``layers`` self-attention layers (all 26 by default)."""
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.text import (
        MaskedLanguageModel,
        MaskedLanguageModelConfig,
        TextClassifier,
        TextClassifierConfig,
        TextDecoderConfig,
        TextEncoderConfig,
    )

    enc = TextEncoderConfig(**dict(MLM_ENCODER, **({} if layers is None else
                                                  {"num_self_attention_layers_per_block": layers})))
    top = dict(num_latents=MLM_LATENTS, num_latent_channels=MLM_CHANNELS)
    gen = torch.Generator().manual_seed(SEED)
    if classifier:
        config = TextClassifierConfig(encoder=enc, decoder=ClassificationDecoderConfig(**TEXT_CLF_DECODER), **top)
        return TextClassifier(config, dtype=dtype, device=device, generator=gen)
    config = MaskedLanguageModelConfig(encoder=enc, decoder=TextDecoderConfig(**MLM_DECODER), **top)
    return MaskedLanguageModel(config, dtype=dtype, device=device, generator=gen)


def flow_model(device, dtype: torch.dtype = torch.float32, **encoder_overrides):
    from perceiver_io_tpu_torch.models.vision import OpticalFlow, OpticalFlowConfig, OpticalFlowDecoderConfig
    from perceiver_io_tpu_torch.models.vision import OpticalFlowEncoderConfig

    config = OpticalFlowConfig(encoder=OpticalFlowEncoderConfig(**dict(FLOW_ENCODER, **encoder_overrides)),
                               decoder=OpticalFlowDecoderConfig(**FLOW_DECODER), num_latents=FLOW_LATENTS,
                               num_latent_channels=FLOW_CHANNELS)
    return OpticalFlow(config, dtype=dtype, device=device, generator=torch.Generator().manual_seed(SEED))


def ts_model(device, dtype: torch.dtype = torch.float32):
    from perceiver_io_tpu_torch.models.timeseries import (
        TimeSeriesDecoderConfig,
        TimeSeriesEncoderConfig,
        TimeSeriesPerceiver,
        TimeSeriesPerceiverConfig,
    )

    config = TimeSeriesPerceiverConfig(encoder=TimeSeriesEncoderConfig(**TS_ENCODER),
                                       decoder=TimeSeriesDecoderConfig(**TS_DECODER), num_latents=TS_LATENTS,
                                       num_latent_channels=TS_CHANNELS)
    return TimeSeriesPerceiver(config, dtype=dtype, device=device, generator=torch.Generator().manual_seed(SEED))


def sam_model(device, dtype: torch.dtype = torch.float32, layers: int = None):
    """The symbolic audio model at ``SAM``'s geometry, seeded random weights,
    with ``layers`` self-attention layers (all 12 by default)."""
    from perceiver_io_tpu_torch.models.audio import SymbolicAudioModel, SymbolicAudioModelConfig

    config = SymbolicAudioModelConfig(**dict(SAM, **({} if layers is None else {"num_self_attention_layers": layers})))
    return SymbolicAudioModel(config, dtype=dtype, device=device, generator=torch.Generator().manual_seed(SEED))


def sam_batch(batch: int, seed: int) -> dict:
    """``batch`` shifted windows of 6145 event tokens (``input_ids``,
    ``labels``; no padding) from the synthetic symbolic audio corpus (motifs
    of velocity, note-on, time-shift and note-off events,
    ``SyntheticSymbolicAudioDataModule``'s pieces), with a host-sampled keep
    set of 2048 of the 4096 prefix rows a row."""
    from perceiver_io_tpu_torch.data.audio.symbolic import SyntheticSymbolicAudioDataModule as corpus
    from perceiver_io_tpu_torch.training import sample_prefix_keep_idx

    rng = np.random.default_rng(seed)
    motifs = corpus._motifs(rng)
    n = SAM["max_seq_len"] + 1
    t = np.stack([np.concatenate([corpus._piece(None, rng, motifs) for _ in range(10)])[:n] for _ in range(batch)])
    prefix = SAM["max_seq_len"] - SAM["max_latents"]
    return {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
            "prefix_keep_idx": sample_prefix_keep_idx(rng, batch, prefix, 0.5)}


def sam_loss_fn(deterministic: bool = False):
    """``clm_loss_fn`` over the SAM's 2048 latents."""
    from perceiver_io_tpu_torch.training import clm_loss_fn

    return clm_loss_fn(SAM["max_latents"], deterministic)


def mlm_batch(batch: int, seed: int) -> dict:
    """``batch`` rows of 2048 byte tokens, the second half of the rows
    right-padded to 1024-2047 tokens, about 15% of the real tokens masked
    (labels there, ``IGNORE_INDEX`` elsewhere); a class label a row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(6, 262, size=(batch, MLM_QUERIES))
    pad = np.zeros(ids.shape, bool)
    for row in range(batch // 2, batch):
        pad[row, rng.integers(1024, MLM_QUERIES):] = True
    masked = (rng.random(ids.shape) < 0.15) & ~pad
    labels = np.where(masked, ids, -100)
    ids = np.where(masked, 3, np.where(pad, 0, ids))
    return {"input_ids": ids, "labels": labels, "pad_mask": pad, "label": rng.integers(0, 2, size=batch)}


def ts_batch(batch: int, seed: int) -> dict:
    """Windows of a sine mixture with noise (scripts/timeseries.py's
    synthetic series), ``TS_IN`` steps in and ``TS_OUT`` out."""
    rng = np.random.default_rng(seed)
    t = np.arange(TS_IN + TS_OUT)[None, :, None] + rng.integers(0, 10000, size=(batch, 1, 1))
    freqs = rng.uniform(0.002, 0.05, size=(1, 1, 7))
    series = (np.sin(2 * np.pi * freqs * t) + 0.05 * rng.normal(size=(batch, TS_IN + TS_OUT, 7))).astype(np.float32)
    return {"x": series[:, :TS_IN], "y": series[:, TS_IN:]}


def pick(batch: dict, *keys) -> dict:
    return {k: batch[k] for k in keys}


# the models the train and check phases drive (TrainTask): the image
# classifier (its checks at IMAGE_SMALL, with the optimizer update compared
# too), the masked LM and the text classifier (their checks at
# TASK_CHECK_LAYERS self-attention layers: K8 in the cross-attention and each
# layer) and the time series (its checks at full size: K8 10 times)
TASKS = {
    "image": TrainTask(
        "image", lambda device, dtype, small=False, remat=False: image_classifier(
            device, dtype, remat, **(IMAGE_SMALL if small else {})),
        lambda size, seed, small=False: image_batch(size, (IMAGE_SMALL if small else IMAGE_ENCODER)["image_shape"],
                                                    seed),
        "classification_loss_fn", IMAGE_STEP, IMAGE_BATCH, IMAGE_LR, IMAGE_STEPS, IMAGE_STEPS,
        (SEED + 5, SEED + 6, SEED + 7), check_heads=1, grad_tol=1e-5, update_tol=3e-4,
        remat_step=IMAGE_STEP_REMAT_BF16),
    "mlm": TrainTask(
        "mlm", lambda device, dtype, small=False, remat=False: mlm_model(
            device, dtype, TASK_CHECK_LAYERS if small else None),
        lambda size, seed, small=False: pick(mlm_batch(size, seed), "input_ids", "labels", "pad_mask"),
        "masked_lm_loss_fn", step_launches(MLM_FORWARD), MLM_BATCH, TASK_LR, TASK_STEPS, TASK_TRAJECTORY_STEPS,
        (SEED + 31, SEED + 33, SEED + 33), check_heads=TASK_CHECK_LAYERS + 1, first_step_lowers=False),
    "text_clf": TrainTask(
        "text_clf", lambda device, dtype, small=False, remat=False: mlm_model(
            device, dtype, TASK_CHECK_LAYERS if small else None, classifier=True),
        lambda size, seed, small=False: pick(mlm_batch(size, seed), "input_ids", "label", "pad_mask"),
        "classification_loss_fn", step_launches(MLM_FORWARD), MLM_BATCH, TASK_LR, TASK_STEPS, TASK_TRAJECTORY_STEPS,
        (SEED + 31, SEED + 33, SEED + 33), check_heads=TASK_CHECK_LAYERS + 1, first_step_lowers=False),
    "timeseries": TrainTask(
        "timeseries", lambda device, dtype, small=False, remat=False: ts_model(device, dtype),
        lambda size, seed, small=False: ts_batch(size, seed),
        "mse_loss_fn", step_launches(TS_FORWARD), TS_BATCH, TASK_LR, TASK_STEPS, TASK_TRAJECTORY_STEPS,
        (SEED + 30, SEED + 32, SEED + 32), check_heads=TS_FORWARD["flash_heads_fwd"], grad_tol=TS_GRAD_TOL,
        first_step_lowers=False),
    # the symbolic audio model (sam_train_bf16): its checks at SAM_CHECK_LAYERS
    # self-attention layers, no heads-major launch
    "sam": TrainTask(
        "sam", lambda device, dtype, small=False, remat=False: sam_model(
            device, dtype, SAM_CHECK_LAYERS if small else None),
        lambda size, seed, small=False: sam_batch(size, seed),
        sam_loss_fn,
        step_launches(SAM_FORWARD), SAM_BATCH, TASK_LR, TASK_STEPS, TASK_TRAJECTORY_STEPS,
        (SEED + 40, SEED + 41, SEED + 42), check_heads=0, first_step_lowers=False),
}

def mlm_fill_phase(card: str, dtype: torch.dtype = torch.float32, cpu_f32: dict = None) -> dict:
    """The masked LM's fill at full width: a batch of 8 byte sequences of
    2048 tokens (15% masked, four rows right-padded) through
    ``make_eval_step`` (a CUDA graph; its first call the eager forward):
    ``MLM_FORWARD``'s launches exactly (bf16: the bf16 builds), finite logits
    (8, 2048, 262), a replay within ``GRAPH_RTOL`` of the eager forward (bf16:
    bit for bit); the logits of rows 0 and 7 against the port on the CPU from
    the same weights: f32 within ``MLM_FILL_REL_TOL`` of the largest, bf16
    by ``check_bf16`` (1.5x the CPU's bf16 distance from its f32 logits, in
    L2). f32 only: ``MaskFiller`` on ``MLM_SAMPLES``, its top-1 fills the
    CPU filler's except at a near tie (top-2 gap under ``NEAR_TIE`` in the
    CPU's logits), which is printed. Prints ms a batch, sequences/s and the
    peak memory. Returns the CPU's f32 logits of the two rows (for the bf16
    phase) and the launches."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer
    from perceiver_io_tpu_torch.hf import MaskFiller
    from perceiver_io_tpu_torch.ops import build

    bf16 = dtype == torch.bfloat16
    name = "mlm_fill" + (BF16 if bf16 else "")
    want = as_bf16(MLM_FORWARD) if bf16 else MLM_FORWARD
    model = mlm_model("cuda", dtype)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != MLM_PARAMS:
        raise SystemExit(f"{name}: {n_params} parameters, deepmind/language-perceiver has {MLM_PARAMS}")
    host = mlm_batch(MLM_BATCH, SEED + 20)
    batch = {k: torch.from_numpy(host[k]).cuda() for k in ("input_ids", "pad_mask")}

    def forward(model, batch):
        return model(batch["input_ids"], pad_mask=batch["pad_mask"])

    step = tt.make_eval_step(forward)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    logits = step(model, batch)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check_graph(name, step.captured.graph, nonzero_launches(), want)
    check_launches(name, launches, want, 1)
    replay = step(model, batch)
    graph_err = 0.0 if torch.equal(replay, logits) else rel_diff(replay, logits)
    if tuple(logits.shape) != (MLM_BATCH, MLM_QUERIES, 262) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{name}: logits not finite or not of shape {(MLM_BATCH, MLM_QUERIES, 262)}")
    if not within(graph_err, 0.0 if bf16 else GRAPH_RTOL):
        raise SystemExit(f"{name}: the graph's logits leave the eager forward's by {graph_err}")
    batch_ms = wall_ms(lambda: step(model, batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = [0, MLM_BATCH - 1]
    t0 = time.perf_counter()
    with torch.no_grad():
        if cpu_f32 is None:
            cpu_model = mlm_model("cpu")
            cpu_f32 = {"logits": cpu_model(torch.from_numpy(host["input_ids"][rows]),
                                           pad_mask=torch.from_numpy(host["pad_mask"][rows]))}
        cpu_bf16 = None
        if bf16:
            cpu_bf16 = mlm_model("cpu", dtype)(torch.from_numpy(host["input_ids"][rows]),
                                               pad_mask=torch.from_numpy(host["pad_mask"][rows]))
    cpu_s = time.perf_counter() - t0
    card_rows = logits[rows].cpu()
    report = {"card": card, "dtype": str(dtype)[6:], "batch": MLM_BATCH, "parameters": n_params,
              "graph_rel_diff_to_eager": graph_err, "batch_ms_graph": batch_ms,
              "sequences_per_s": MLM_BATCH / (batch_ms / 1e3),
              "tokens_per_s": MLM_BATCH * MLM_QUERIES / (batch_ms / 1e3),
              "peak_memory_gb": peak_gb, "cpu_reference_s": cpu_s, "cpu_threads": torch.get_num_threads(),
              "launches": {k: v for k, v in launches.items() if v}}
    if bf16:
        report["bf16_rule"] = check_bf16(f"{name} logits against the CPU", card_rows, cpu_bf16, cpu_f32["logits"],
                                         1.5)
    else:
        err = rel_diff(card_rows, cpu_f32["logits"])
        report.update(rel_err_to_cpu=err, tol=MLM_FILL_REL_TOL)
        if not within(err, MLM_FILL_REL_TOL):
            raise SystemExit(f"{name}: the card's logits leave the CPU's by {err} (relative)")
        tok = ByteTokenizer()
        fills = {"card": MaskFiller(model, tok).fill(MLM_SAMPLES, num_predictions=1)}
        cpu_filler = MaskFiller(cpu_model, tok, device="cpu")
        fills["cpu"] = cpu_filler.fill(MLM_SAMPLES, num_predictions=1)
        ids, pad = tok.pad_sequences([cpu_filler._encode_masked(t) for t in MLM_SAMPLES], max_length=MLM_QUERIES)
        with torch.no_grad():
            top2 = cpu_model(torch.from_numpy(ids).long(), pad_mask=torch.from_numpy(pad)).topk(2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1]).numpy()
        near = []
        for row, (got, want_fill) in enumerate(zip(fills["card"], fills["cpu"])):
            if got != want_fill:
                gap = float(gaps[row][ids[row] == tok.mask_token_id].min())
                near.append({"sample": row, "card": got, "cpu": want_fill, "min_top2_gap": gap})
                if not within(gap, NEAR_TIE):
                    raise SystemExit(f"{name}: the card's fill {got} is not the CPU's {want_fill} (gap {gap})")
        report.update(fills=fills["card"], near_ties=near)
        del cpu_model
    log(f"{name}: " + json.dumps(report))
    TIMES[f"{name}_sequences_per_s"] = report["sequences_per_s"]
    return {"launches": launches, "cpu_f32": cpu_f32}


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of the forward path (K8, K2, K1) computing its
    plain PyTorch version on the card instead: the reference a forward
    through the kernels is held to, on the same device, weights and input."""
    from perceiver_io_tpu_torch.ops import flash_attention as tflash
    from perceiver_io_tpu_torch.ops import layernorm as tln

    saved = tflash.heads_fwd_cuda, tflash._fwd_cuda, tln.layer_norm_cuda
    tflash.heads_fwd_cuda = tflash._heads_fwd_plain
    tflash._fwd_cuda = lambda q, k, v, h, bias, causal, sm_scale, nsplit=None: tflash._fwd_plain(
        q, k, v, h, bias, causal, sm_scale)
    tln.layer_norm_cuda = lambda x, w, b, eps, dtype, want_stats=False: tln.layer_norm_reference_stats(
        x, w, b, eps, dtype)
    try:
        yield
    finally:
        tflash.heads_fwd_cuda, tflash._fwd_cuda, tln.layer_norm_cuda = saved


def flow_phase(card: str, dtype: torch.dtype = torch.float32, f32_plain: torch.Tensor = None) -> dict:
    """Optical flow at deepmind/optical-flow-perceiver's width: one 368 x 496
    pair at batch 1, eagerly: ``FLOW_FORWARD``'s launches exactly (bf16:
    ``FLOW_FORWARD_BF16``), a finite (1, 368, 496, 2) flow, held to the same
    forward with every kernel on its plain version on the card (``plain_kernels``;
    f32 within ``FLOW_REL_TOL`` of the largest, bf16 by ``check_bf16``
    against the f32 phase's plain forward, ``f32_plain``, its element rule at
    ``FLOW_BF16_REL``); then ``OpticalFlowProcessor.process``
    on a one-patch pair (20 x the forward's flow within 1e-6 relative: the
    grid's four copies of the patch blend to it) and on a generated ``FLOW_BIG`` pair (2 x 2
    overlapping patches blended): finite, of the frame's shape. Prints ms a
    pair and pairs/s. Returns the forward's launches and the f32 plain flow."""
    from perceiver_io_tpu_torch.data.vision import OpticalFlowProcessor
    from perceiver_io_tpu_torch.ops import build

    bf16 = dtype == torch.bfloat16
    name = "flow" + (BF16 if bf16 else "")
    want = FLOW_FORWARD_BF16 if bf16 else FLOW_FORWARD
    model = flow_model("cuda", dtype)
    rng = np.random.default_rng(SEED + 40)
    frames = [rng.integers(0, 256, size=FLOW_SHAPE + (3,), dtype=np.uint8) for _ in range(2)]
    proc = OpticalFlowProcessor(patch_size=FLOW_SHAPE)
    # a pair of the patch's size makes the reference's grid of 2 x 2 corners,
    # all at (0, 0): four copies of one patch; the forward takes one
    x = torch.from_numpy(proc.preprocess(frames)[:1]).cuda()  # (1, 2, 368, 496, 27)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with torch.no_grad():
        flow = model(x)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        check_launches(name, launches, want, 1)
        build.reset_launches()
        with plain_kernels():
            plain = model(x)
        if any(build.LAUNCHES.values()):
            raise SystemExit(f"{name}: the plain forward launched {nonzero_launches()}")
    if tuple(flow.shape) != (1,) + FLOW_SHAPE + (2,) or not bool(torch.isfinite(flow).all()):
        raise SystemExit(f"{name}: flow not finite or not of shape {(1,) + FLOW_SHAPE + (2,)}")
    report = {"card": card, "dtype": str(dtype)[6:], "pair": FLOW_SHAPE,
              "launches": {k: v for k, v in launches.items() if v}}
    if bf16:
        report["bf16_rule"] = check_bf16(f"{name} against the f32 plain forward", flow, plain, f32_plain, 1.5,
                                         rel=FLOW_BF16_REL)
    else:
        err = rel_diff(flow, plain)
        report.update(rel_err_to_plain=err, tol=FLOW_REL_TOL)
        if not within(err, FLOW_REL_TOL):
            raise SystemExit(f"{name}: the kernels' flow leaves the plain versions' by {err} (relative)")

    def model_fn(batch):
        with torch.no_grad():
            return model(torch.from_numpy(batch).cuda()).float().cpu().numpy()

    one = proc.process(model_fn, [frames])
    one_err = rel_diff(torch.from_numpy(one), 20 * flow.float().cpu())
    big = [rng.integers(0, 256, size=FLOW_BIG + (3,), dtype=np.uint8) for _ in range(2)]
    t0 = time.perf_counter()
    blended = proc.process(model_fn, [big])
    process_s = time.perf_counter() - t0
    if not within(one_err, 1e-6):
        raise SystemExit(f"{name}: a one-patch process leaves 20 x the forward by {one_err}")
    if blended.shape != (1,) + FLOW_BIG + (2,) or not np.isfinite(blended).all():
        raise SystemExit(f"{name}: the blended flow is not finite or not of shape {(1,) + FLOW_BIG + (2,)}")
    with torch.no_grad():
        pair_ms = wall_ms(lambda: model(x))
        device_ms = time_ms(lambda: model(x), 3)
    report.update(one_patch_rel_err=one_err, big_pair=FLOW_BIG, big_patches=len(proc.compute_patch_grid_indices(
        FLOW_BIG)), big_process_s=process_s, pair_ms=pair_ms, pair_device_ms=device_ms,
        pairs_per_s=1e3 / pair_ms, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{name}: " + json.dumps(report))
    TIMES[f"{name}_pairs_per_s"] = report["pairs_per_s"]
    return {"launches": launches, "plain": plain}


# ---------------------------------------------------------------------------
# telemetry (ROADMAP A11.2 + A11.3): probes in the captured steps, the load
# runner, the SLO report, the scrape server, the flight recorder, the rollup
# ---------------------------------------------------------------------------

# train_probes_bf16's trainer: a fit of this many steps over fit_batches with
# its NaN batch at FIT_PROBE_POISON (1-based), a log row every 2 steps
FIT_PROBE_STEPS, FIT_PROBE_POISON = 4, 3
# load_bf16: the load runner's requests (2048 and 8192-token prompts, budgets
# of 32, the serve's range), the requests of each measured loop (all warm: a
# TTFT p99 over 128 samples), the closed loop's concurrency, and the open
# loop's rate as a share of what the closed loop's requests sustain
LOAD_PROMPTS, LOAD_BUDGETS, LOAD_REQUESTS, LOAD_CONCURRENCY, LOAD_RATE_SHARE = (2048, 8192), (32,), 128, 2, 0.5


class EventRelay:
    """An event sink that forwards to ``target`` and drops rows while it is
    None: generate fns bind their sink when built, so a warm-up through the
    same fns stays out of the measured runs' logs."""

    target = None

    def emit(self, event: str, **fields) -> None:
        if self.target is not None:
            self.target.emit(event, **fields)

    def emit_rows(self, event: str, rows) -> None:
        if self.target is not None:
            self.target.emit_rows(event, rows)


def flagship_bf16():
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    return CausalLanguageModel(CausalLanguageModelConfig(**FLAGSHIP), device="cuda",
                               generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16)


def train_probes_bf16_phase(card: str, train_bf16: dict) -> dict:
    """train_bf16's graphed step with ``ProbeConfig()``: the same seed,
    weights, batch and keep sets for its five steps. Its graph holds
    train_bf16's hand-written kernel nodes, in kind and count, plus the
    stats' reductions; its losses equal train_bf16's bit for bit; step ms
    beside train_bf16's graph step. Steps 4 and 5 are consecutive replays:
    their snapshots hold different stats, and step 4's reads the same after
    step 5 (copies, not the graph's buffers). Then ``Trainer.fit`` with
    probes and the sentinel over ``fit_batches`` with a NaN batch at
    ``FIT_PROBE_POISON``: one ``probe.blast`` at that step, ``trigger``
    skip, its scope a gradient bucket (the poison multiplies the loss: every
    activation stays finite), ``probe`` rows at the log boundaries. Returns
    the five steps' launches."""
    import os
    import tempfile

    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.obs import probes
    from perceiver_io_tpu_torch.ops import build

    model = flagship_bf16()
    n, lat = FLAGSHIP["max_seq_len"], FLAGSHIP["max_latents"]
    rng = np.random.default_rng(SEED)
    t = torch.from_numpy(rng.integers(0, FLAGSHIP["vocab_size"], size=(TRAIN_BATCH, n + 1))).cuda()
    tokens = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None}
    state = tt.TrainState.create(model, tt.make_optimizer(TRAIN_LR, gradient_clip=1.0, moment_dtype="bfloat16"))
    step = tt.make_train_step(poisonable(tt.clm_loss_fn(lat)), microbatch=TRAIN_MICROBATCH, sentinel=True,
                              probes=probes.ProbeConfig())
    per_step = train_per_step("concat", "", BF16)
    losses, step_ms, snaps = [], [], []
    build.reset_launches()
    for i in range(TRAIN_STEPS):
        b = dict(tokens, prefix_keep_idx=tt.sample_prefix_keep_idx(rng, TRAIN_BATCH, n - lat, 0.5),
                 poison=np.ones(TRAIN_BATCH, np.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        snaps.append(metrics["probes"])
        if i == 0:
            check_graph("train_probes_bf16", step.captured.graph, nonzero_launches(), per_step)
    launches = dict(build.LAUNCHES)
    fourth, fifth = probes.snapshot_to_host(snaps[3]), probes.snapshot_to_host(snaps[4])
    fourth_again = probes.snapshot_to_host(snaps[3])
    names = list(dict.fromkeys(k for ks in GRAPH_KERNELS.values() for k in ks))
    probed_nodes, plain_nodes = GRAPH_NODES["train_probes_bf16"]["nodes"], GRAPH_NODES["train_bf16"]["nodes"]
    report = {
        "card": card, "scopes": len(fifth), "first_scopes": list(fifth)[:4],
        "losses": losses, "train_bf16_losses": train_bf16["graph"]["losses"],
        "median_step_ms": {"probes": statistics.median(step_ms), "no_probes": train_bf16["graph"]["median_step_ms"]},
        "kernel_nodes": {"probes": probed_nodes["kernel nodes"], "no_probes": plain_nodes["kernel nodes"]},
        "step_4_and_5_differ": fourth != fifth, "step_4_unchanged_by_step_5": fourth == fourth_again,
        "step_5_finite": all(math.isfinite(v) for st in fifth.values() for v in st.values()),
    }
    report["probe_overhead_ms"] = report["median_step_ms"]["probes"] - report["median_step_ms"]["no_probes"]
    log("train_probes_bf16: " + json.dumps(report))
    if losses != train_bf16["graph"]["losses"]:
        raise SystemExit(f"train_probes_bf16: losses {losses} are not train_bf16's {train_bf16['graph']['losses']}")
    if {k: probed_nodes[k] for k in names} != {k: plain_nodes[k] for k in names}:
        raise SystemExit(f"train_probes_bf16: hand-written kernel nodes {probed_nodes} are not train_bf16's "
                         f"{plain_nodes}")
    if not probed_nodes["kernel nodes"] > plain_nodes["kernel nodes"]:
        raise SystemExit("train_probes_bf16: the probed graph holds no reduction of its own")
    if not (report["step_4_and_5_differ"] and report["step_4_unchanged_by_step_5"] and report["step_5_finite"]):
        raise SystemExit(f"train_probes_bf16: the snapshots are not per-step copies: {report}")
    TIMES["train_probes_bf16_median_ms"] = report["median_step_ms"]
    del state, step, snaps, model
    free_card()

    # the trainer: probes + sentinel, one NaN batch
    config, schedule, state = fit_state()
    with tempfile.TemporaryDirectory() as root:
        trainer = tt.Trainer(poisonable(tt.clm_loss_fn(lat)), config=tt.TrainerConfig(
            max_steps=FIT_PROBE_STEPS, log_interval=2, microbatch=TRAIN_MICROBATCH, prefetch_batches=2,
            sentinel=True, probes=True), logger=tt.MetricsLogger(os.path.join(root, "logs"), use_tensorboard=False),
            lr_schedule=schedule)
        trainer.fit(state, fit_batches((FIT_PROBE_POISON,)), model_config=config)
        trainer.close()
        with open(os.path.join(root, "logs", "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
    blasts = [e for e in events if e["event"] == "probe.blast"]
    probe_rows = [e["step"] for e in events if e["event"] == "probe"]
    report = {"card": card, "blasts": [{k: b[k] for k in ("step", "trigger", "scope", "n_affected", "n_scopes")}
                                       for b in blasts], "probe_rows": probe_rows}
    log("train_probes_bf16 fit: " + json.dumps(report))
    b = blasts[0] if len(blasts) == 1 else None
    if (b is None or b["step"] != FIT_PROBE_POISON or b["trigger"] != "skip" or not b["scope"].startswith("grad.")
            or not all(s.startswith(("grad.", "update.")) for s in b["affected"]) or not probe_rows):
        raise SystemExit(f"train_probes_bf16 fit: the blast is not the poisoned step's gradient: {report}")
    del state, trainer
    free_card()
    return launches


def decode_probes_bf16_phase(card: str) -> dict:
    """The decode pair (decode_pair's batch-1 8192-token prompt, 128 greedy
    tokens, bf16 compute, f32 caches) with ``probes=True``: its stream token
    for token the unprobed pair's, each token's ``kv_cache_frac`` the host's
    ``(length - start) / capacity``, no non-finite logit; decode tok/s of
    both. Then a ``RequestFrontEnd(FrontEndConfig(probes=True))`` request
    on poisoned weights (``FaultInjector.poison_at``) opens the breaker
    through the ``nonfinite-logits`` sentinel and the next request sheds
    ``breaker_open``; the weights come back unchanged. Returns the probed
    pair's launches."""
    import tempfile

    from perceiver_io_tpu_torch import generation, serving
    from perceiver_io_tpu_torch.obs.events import EventLog, merged_events
    from perceiver_io_tpu_torch.ops import build

    model = flagship_bf16()
    new = DECODE_NEW_TOKENS
    config = generation.GenerationConfig(max_new_tokens=new)
    ids = np.random.default_rng(SEED + 4).integers(0, FLAGSHIP["vocab_size"], size=(1, DECODE_PROMPT))
    runs = {}
    for probes in (False, True):
        prefill, step = generation.make_decode_fns(model, NUM_LATENTS, config, torch.float32, probes=probes,
                                                   device="cuda")
        build.reset_launches()
        token, state = prefill(ids)
        tokens, healths = [token], []
        for i in range(new - 1):
            if probes:
                healths.append({k: v.clone() for k, v in state["probe"].items()})
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, token = step(state)
            tokens.append(token)
        torch.cuda.synchronize()
        runs[probes] = {"stream": torch.stack(tokens, 1).cpu(), "tok_s": (new - 2) / (time.perf_counter() - t0),
                        "healths": healths, "launches": nonzero_launches()}
        del prefill, step, state
    capacity = DECODE_PROMPT + new
    frac = [float(np.float32(DECODE_PROMPT + i) / np.float32(capacity)) for i in range(new - 1)]
    got = [float(h["kv_cache_frac"]) for h in runs[True]["healths"]]
    report = {"card": card, "tok_s": {"probes": runs[True]["tok_s"], "no_probes": runs[False]["tok_s"]},
              "streams_equal": torch.equal(runs[True]["stream"], runs[False]["stream"]),
              "kv_cache_frac_equal_host": got == frac,
              "nonfinite_logit_frac_max": max(float(h["nonfinite_logit_frac"]) for h in runs[True]["healths"]),
              "logit_entropy_first_last": [float(runs[True]["healths"][i]["logit_entropy"]) for i in (0, -1)]}
    TIMES["decode_probes_bf16_tok_s"] = report["tok_s"]
    log("decode_probes_bf16: " + json.dumps(report))
    if not (report["streams_equal"] and report["kv_cache_frac_equal_host"]) or report["nonfinite_logit_frac_max"]:
        raise SystemExit(f"decode_probes_bf16: {report}")

    # the breaker's sentinel feed on the card
    from perceiver_io_tpu_torch.serving import RequestSpec

    rng = np.random.default_rng(SEED + 5)
    specs = [RequestSpec(i, 2048, 8, rng.integers(0, FLAGSHIP["vocab_size"], size=(1, 2048)), i) for i in range(2)]
    before = [p.detach().clone() for p in model.parameters()]
    with tempfile.TemporaryDirectory() as out:
        clock = serving.ManualClock()
        fe = serving.RequestFrontEnd(model, num_latents=NUM_LATENTS, config=serving.FrontEndConfig(probes=True),
                                     events=EventLog(out, main_process=True), clock=clock, sleep=clock.sleep,
                                     injector=serving.FaultInjector().poison_at(0), device="cuda")
        recs = fe.run_closed(specs, concurrency=1)
        rows = merged_events(out)
    breaker = [e["reason"] for e in rows if e.get("event") == "serve.breaker"]
    nonfinite = [e.get("nonfinite_logit_frac") for e in rows if e.get("event") == "request"]
    restored = all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    report = {"card": card, "outcomes": [(r.outcome, r.shed_reason) for r in recs], "breaker": fe.breaker.state,
              "reasons": breaker, "nonfinite_logit_frac": nonfinite, "weights_restored": restored}
    log("decode_probes_bf16 breaker: " + json.dumps(report))
    if (report["outcomes"] != [("ok", None), ("shed", "breaker_open")] or report["breaker"] != "open"
            or breaker[:1] != ["nonfinite-logits"] or not nonfinite or not nonfinite[0] > 0 or not restored):
        raise SystemExit(f"decode_probes_bf16: the poisoned request did not open the breaker: {report}")
    launches = runs[True]["launches"]
    del model, fe, runs, before
    free_card()
    return launches


def load_bf16_phase(card: str) -> dict:
    """The load runner at the flagship (bf16 compute, f32 caches). One
    request of each prompt length first captures its decode step on the
    fns (its rows dropped, the registry's latency histograms then reset),
    so that the measured loops hold no capture: a closed loop of
    ``LOAD_REQUESTS`` at concurrency ``LOAD_CONCURRENCY``, then an open loop
    of as many at ``LOAD_RATE_SHARE`` of the closed loop's service rate, on
    the same fns, each into an event log of its own (the histograms reset
    between them); TTFT, TPOT p50/p99 and tok/s of both, each window's
    requests all warm; ``build_slo_report`` over each log agrees with
    ``summarize_load``'s request and token counts. A ``FlightRecorder``
    wraps the closed loop's log with no bounds (no dump); its TTFT bound is
    then set below the closed loop's least TTFT and one request on the same
    fns writes exactly one dump, naming that request's span. Then an
    ``ObsServer`` over an ``EngineFrontEnd`` (the serve's geometry, bf16
    pools) answers ``/metrics``, ``/slo`` and ``/healthz`` while a thread
    serves four of the serve's requests; the engine launches K3. Returns the
    engine serve's launches."""
    import os
    import tempfile
    import threading
    import urllib.request

    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events
    from perceiver_io_tpu_torch.obs.flightrec import FlightRecorder, SLOBounds
    from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec, run_load
    from perceiver_io_tpu_torch.obs.metrics import MetricsRegistry
    from perceiver_io_tpu_torch.obs.server import ObsServer
    from perceiver_io_tpu_torch.obs.slo import build_slo_report
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd

    model = flagship_bf16()
    spec = WorkloadSpec(seed=SEED, prompt_lens=LOAD_PROMPTS, max_new_tokens=LOAD_BUDGETS)
    relay, registry = EventRelay(), MetricsRegistry()
    kw = dict(num_latents=NUM_LATENTS, base_config=generation.GenerationConfig(), snapshot_interval_s=0.0,
              events=relay, registry=registry, device="cuda")

    def fresh_window(target):
        relay.target = target
        for name in ("generate_ttft_s", "generate_tpot_s", "generate_queue_wait_s"):
            registry.histogram(name).reset()

    fns, t0 = {}, time.perf_counter()
    for length in LOAD_PROMPTS:
        fns = run_load(model, dataclasses.replace(spec, prompt_lens=(length,)), n_requests=1, generate_fns=fns,
                       **kw).generate_fns
    warm_up_s = time.perf_counter() - t0
    root = tempfile.mkdtemp()
    rec = FlightRecorder(EventLog(os.path.join(root, "closed"), main_process=True), slo=SLOBounds())
    fresh_window(rec)
    closed = run_load(model, spec, mode="closed", n_requests=LOAD_REQUESTS, concurrency=LOAD_CONCURRENCY,
                      generate_fns=fns, **kw)
    rate = LOAD_RATE_SHARE * len(closed.records) / sum(r.ttft_s + r.decode_s for r in closed.records)
    fresh_window(EventLog(os.path.join(root, "open"), main_process=True))
    open_ = run_load(model, spec, mode="open", n_requests=LOAD_REQUESTS, rate_rps=rate, generate_fns=fns, **kw)
    report = {"card": card, "spec": spec.to_dict(), "warm_up_s": warm_up_s}
    for name, run in (("closed", closed), ("open", open_)):
        s = run.summary
        stream = merged_events(os.path.join(root, name))
        slo = build_slo_report(stream)
        problems = validate_events(os.path.join(root, name), warnings_out=[])
        report[name] = {k: s.get(k) for k in ("n_requests", "concurrency", "target_rps", "achieved_rps",
                                              "throughput_tok_s", "n_cold", "ttft_s", "tpot_s", "queue_wait_s",
                                              "breakdown_ms")}
        report[name]["slo"] = {k: slo.get(k) for k in ("n_requests", "outcomes", "tokens_out", "ttft_s", "tpot_s")}
        if (slo["n_requests"] != s["n_requests"] or slo["outcomes"].get("ok", 0) != s["n_requests"] - s["errors"]
                or slo["tokens_out"] != s["tokens_out"] or s["errors"] or problems):
            raise SystemExit(f"load_bf16 {name}: the SLO report disagrees with the load summary, or the stream is "
                             f"invalid ({problems}): {report[name]}")
        if s["n_cold"] or s["n_requests"] != LOAD_REQUESTS or s.get("tpot_s", {"low_n": True}).get("low_n"):
            raise SystemExit(f"load_bf16 {name}: a capture inside the window, or too few samples: {report[name]}")
    if rec.dumps:
        raise SystemExit(f"load_bf16: the recorder dumped without bounds: {rec.dumps}")
    rec.slo = SLOBounds(ttft_s=0.5 * min(r.ttft_s for r in closed.records))
    relay.target = rec
    run_load(model, spec, n_requests=1, generate_fns=fns, **kw)
    last = [e for e in merged_events(os.path.join(root, "closed")) if e.get("event") == "request"][-1]
    dump = json.load(open(rec.dumps[0])) if len(rec.dumps) == 1 else {}
    report["flight"] = {"dumps": [os.path.basename(p) for p in rec.dumps], "ttft_bound_s": rec.slo.ttft_s,
                        "trigger_span_is_the_request": dump.get("trigger_span_id") == last.get("span_id")}
    TIMES["load_bf16"] = {k: report[k] for k in ("closed", "open")}
    if report["flight"]["dumps"] != ["flight-slo_ttft-1.json"] or not report["flight"]["trigger_span_is_the_request"]:
        raise SystemExit(f"load_bf16: the planted TTFT breach wrote {report['flight']}")
    del closed, open_, rec

    # the scrape server over the engine while it serves
    out = os.path.join(root, "engine")
    engine = EngineFrontEnd(model, num_latents=NUM_LATENTS, engine_config=EngineConfig(**SERVE_GEOMETRY),
                            cache_dtype=torch.bfloat16, events=EventLog(out, main_process=True), device="cuda")
    specs = serve_specs()[:4]
    scrapes, failures = [], []
    build.reset_launches()
    with ObsServer(registry=engine.registry, run_dir=out, health=engine.health) as server:
        worker = threading.Thread(target=lambda: engine.run_closed(specs, concurrency=len(specs)))
        worker.start()
        while worker.is_alive() or len(scrapes) < 3:
            for path in ("/metrics", "/slo", "/healthz"):
                try:
                    with urllib.request.urlopen(server.url + path, timeout=30) as r:
                        scrapes.append((path, r.status, len(r.read())))
                except Exception as e:  # noqa: BLE001 -- reported below
                    failures.append((path, repr(e)))
            time.sleep(0.05)
        worker.join()
        torch.cuda.synchronize()
        with urllib.request.urlopen(server.url + "/slo", timeout=30) as r:
            final = json.loads(r.read())
        with urllib.request.urlopen(server.url + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
    launches = nonzero_launches()
    report["server"] = {"scrapes": len(scrapes), "failures": failures[:3], "slo_n_requests": final.get("n_requests"),
                        "books": engine.books(), "k3_launches": launches.get("paged_decode" + BF16, 0),
                        "metrics_lines": metrics.count("\n")}
    log("load_bf16: " + json.dumps(report))
    if (failures or any(status != 200 for _, status, _ in scrapes) or final.get("n_requests") != len(specs)
            or not engine.books()["balanced"] or not report["server"]["k3_launches"]
            or "engine_batch_fill_frac" not in metrics):
        raise SystemExit(f"load_bf16: the server over the serving engine: {report['server']}")
    del engine, model
    free_card()
    return launches


def profile_rollup_phase(card: str) -> None:
    """``obs.profiler.rollup`` over one eager train step (train_bf16's, after
    one eager step outside the profile) and one graphed serve (the engine's
    captured step, two of the serve's requests): the top scopes and kernels
    of each; K2, K4a, K4b and K1's bf16 builds under the ``train_step``
    scope, K3's under ``decode_paged`` (the replays' kernels under the
    replay's scope)."""
    from torch.profiler import ProfilerActivity, profile

    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.obs import profiler
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd

    model = flagship_bf16()
    batch = next(fit_batches())
    state = tt.TrainState.create(model, tt.make_optimizer(TRAIN_LR, gradient_clip=1.0, moment_dtype="bfloat16"))
    step = tt.make_train_step(poisonable(tt.clm_loss_fn(FLAGSHIP["max_latents"])), microbatch=TRAIN_MICROBATCH,
                              jit=False)
    step(state, batch)
    torch.cuda.synchronize()
    engine = EngineFrontEnd(model, num_latents=NUM_LATENTS, engine_config=EngineConfig(**SERVE_GEOMETRY),
                            cache_dtype=torch.bfloat16, device="cuda")
    runs = {}
    for name, fn in (("train_step", lambda: step(state, batch)),
                     ("serve", lambda: engine.run_closed(serve_specs()[:2], concurrency=2))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        planes = {r.plane: r for r in profiler.rollup(prof)}
        device = [r for p, r in planes.items() if p.startswith("/device")]
        if not device:
            raise SystemExit(f"profile_rollup {name}: no device plane in the capture ({sorted(planes)})")
        runs[name] = device[0]
        log(f"profile_rollup {name}: " + json.dumps({
            "card": card, "plane": device[0].plane, "total_ms": device[0].total_ps / 1e9,
            "top_scopes": [[s, d / 1e9, c] for s, d, c in device[0].top(6)],
            "top_kernels": [[op[:120], d / 1e9, c] for op, d, c in device[0].top_ops(8)]}))
    want = {"train_step": ("flash_packed_kernel", "flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                           "_layer_norm_fwd_kernel"), "serve": ("paged_walk_kernel", "paged_merge_kernel")}
    for name, kernels in want.items():
        scope = "train_step" if name == "train_step" else "decode_paged"
        missing = [k for k in kernels if not any(op.split("/")[0] == scope and k in op for op in runs[name].ops)]
        if missing:
            raise SystemExit(f"profile_rollup {name}: {missing} not under the {scope} scope: "
                             f"{[op[:100] for op, _, _ in runs[name].top_ops(20)]}")
    del state, step, engine, model
    free_card()


# ---------------------------------------------------------------------------
# the symbolic audio model, the inference tier and the training CLI (ROADMAP
# A13, part 2)
# ---------------------------------------------------------------------------


def sam_prompt(n: int) -> np.ndarray:
    """The first ``n`` event tokens of ``midi.encode_notes`` over seeded
    notes (a pitch walk with random velocities, onsets and lengths)."""
    from perceiver_io_tpu_torch.data.audio import midi

    rng = np.random.default_rng(SEED + 50)
    notes, t = [], 0.0
    while True:
        t += float(rng.choice([0.0, 0.05, 0.12, 0.25, 0.5]))
        notes.append(midi.Note(int(rng.integers(30, 110)), int(rng.integers(36, 96)), t,
                               t + float(rng.uniform(0.05, 1.2))))
        if len(notes) % 256 == 0:
            ids = midi.encode_notes(notes)
            if len(ids) >= n:
                return np.asarray(ids[:n], np.int64)


def pipeline_fn(pipe, num_latents: int, max_new_tokens: int = SAM_NEW, top_k: int = SAM_TOP_K):
    """The generate fn a pipeline keeps for one window and budget at one
    ``top_k`` (its cache key: latents, the two storage dtypes, then
    ``GenerationConfig``'s fields)."""
    from perceiver_io_tpu_torch.generation import GenerationConfig

    at = {f.name: 3 + i for i, f in enumerate(dataclasses.fields(GenerationConfig))}
    fns = [fn for key, fn in pipe._gen_cache.items()
           if key[0] == num_latents and key[at["max_new_tokens"]] == max_new_tokens and key[at["top_k"]] == top_k]
    if len(fns) != 1:
        raise SystemExit(f"pipeline: {len(fns)} generate fns for {num_latents} latents, {max_new_tokens} tokens, "
                         f"top_k {top_k}")
    return fns[0]


def sam_generate_phase(card: str, root: str, dtype: torch.dtype = torch.float32) -> dict:
    """The symbolic audio model at the GiantMIDI-Piano geometry (``SAM``,
    seeded random weights, saved with ``save_pretrained``) through
    ``pipeline("symbolic-audio-generation", model_dir=...)`` on the card, in
    ``dtype`` compute: the 6000-token prompt, 512 new tokens at ``top_k`` 15
    (both windows slide; ``num_latents`` raised to 1904).

    - the prefill (a 1-token call) launches K2 13 times and K1, in the build
      of ``dtype`` only; the decode step is a captured graph whose kernel
      nodes hold K1 and no K2 or K3 (``check_graph``), replayed 511 times;
    - two calls with one seed give the same ids, those of the pipeline's
      generate fn less the PAD tokens; every id lies below ``PAD_ID`` and
      ``decode_events`` returns notes;
    - the ``top_k=1`` stream equals the greedy stream of every kernel on its
      plain version on the card (``plain_kernels``) up to the first near tie
      of the plain logits (``check_streams``, which prints it);
    - the graphed stream equals the eager step's (``generation._eager_step``)
      token for token from the same prefill and generator;
    - prefill ms, decode tok/s and the card's memory at three prompt lengths
      (``SAM_PROMPT_LENGTHS``), every generate fn kept, as a server keeps
      them.

    Returns the launches of the main call and the directory, prompt and ids
    the Lightning round trip reads."""
    import types

    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.data.audio import midi
    from perceiver_io_tpu_torch.hf import pipeline
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.training import save_pretrained

    bf16 = dtype == torch.bfloat16
    sfx = BF16 if bf16 else ""
    name = "sam_generate" + sfx
    directory = f"{root}/sam{sfx}"
    model = sam_model("cuda", dtype)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != SAM_PARAMS:
        raise SystemExit(f"{name}: {n_params} parameters, not {SAM_PARAMS}")
    save_pretrained(directory, model, model.config)
    del model
    free_card()
    pipe = pipeline("symbolic-audio-generation", model_dir=directory, dtype=dtype)
    model = pipe.model
    prompt = sam_prompt(SAM_PROMPT)
    x = torch.as_tensor(prompt[None])
    build.reset_launches()
    pipe(prompt, max_new_tokens=1, seed=SEED)
    prefill = nonzero_launches()
    k2, k1 = "flash_packed_fwd" + sfx, "layer_norm_fwd" + sfx
    if prefill.get(k2) != SAM_FORWARD["flash_packed_fwd"] or not prefill.get(k1) or set(prefill) - {k2, k1}:
        raise SystemExit(f"{name}: the prefill launched {prefill}, expected K2 {SAM_FORWARD['flash_packed_fwd']} "
                         f"times and K1, in {str(dtype)[6:]} alone")
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe(prompt, seed=SEED)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main_launches = nonzero_launches()
    # a replay counts its captured launches (graphs.py), so the 511 steps
    # after the prefill count the step's launches 511 times
    decode = {k: n - prefill.get(k, 0) for k, n in main_launches.items() if n - prefill.get(k, 0)}
    step_launch = {k: n // (SAM_NEW - 1) for k, n in decode.items()}
    if any(n % (SAM_NEW - 1) for n in decode.values()):
        raise SystemExit(f"{name}: the decode's launches {decode} are not {SAM_NEW - 1} equal steps")
    fn = pipeline_fn(pipe, SAM_PROMPT_LATENTS)
    step, _ = next(iter(fn.decode_states._states.values()))
    if not isinstance(step.body, generation._GraphedStep):
        raise SystemExit(f"{name}: the decode step on the card is not the captured graph")
    check_graph(name, step.body.graph, step_launch, {k2: 0, "paged_decode" + sfx: 0})
    again = pipe(prompt, seed=SEED)
    raw = fn(x, generator=torch.Generator().manual_seed(SEED)).cpu()[0, SAM_PROMPT:]
    ids = out.token_ids
    checks = {"same_ids_for_one_seed": np.array_equal(ids, again.token_ids),
              "ids_are_the_fn_stream_less_pad": np.array_equal(
                  ids, np.concatenate([prompt, raw.numpy()])[np.concatenate([prompt, raw.numpy()]) != midi.PAD_ID]),
              "ids_below_pad": bool((ids < midi.PAD_ID).all()), "notes": len(out.notes)}
    if not all(checks.values()):
        raise SystemExit(f"{name}: {checks}")
    # greedy (top_k 1) through the kernels against every kernel on its plain
    # version, up to the plain logits' first near tie
    greedy = pipe(prompt, top_k=1, seed=SEED)
    got = pipeline_fn(pipe, SAM_PROMPT_LATENTS, top_k=1)(x).cpu()[0, SAM_PROMPT:].tolist()
    if not np.array_equal(greedy.token_ids[SAM_PROMPT:], [t for t in got if t != midi.PAD_ID]):
        raise SystemExit(f"{name}: the greedy pipeline's ids are not its generate fn's")
    spec = types.SimpleNamespace(index=0, input_ids=prompt[None], max_new_tokens=SAM_NEW, prompt_len=SAM_PROMPT)
    with plain_kernels():
        agreed = check_streams(f"{name} top_k=1 against the plain versions", model, [spec], {0: got},
                               NEAR_TIE_BF16 if bf16 else NEAR_TIE, num_latents=SAM_PROMPT_LATENTS)
    # the graphed pair against the eager body, sampled at the pipeline's
    # settings from one prefill each
    config = generation.GenerationConfig(max_new_tokens=SAM_NEW, do_sample=True, top_k=SAM_TOP_K)
    streams, tok_s = {}, {}
    for kind in ("graph", "eager"):
        prefill_fn, pair_step = generation.make_decode_fns(model, SAM_PROMPT_LATENTS, config, device="cuda")
        if kind == "eager":
            body = generation._eager_step(model, config, model.device)

            def pair_step(st, body=body):
                st, tok = body(st)
                return st, tok.clone()
        token, state = prefill_fn(x, generator=torch.Generator().manual_seed(SEED))
        tokens = [token]
        state, token = pair_step(state)
        tokens.append(token)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SAM_NEW - 2):
            state, token = pair_step(state)
            tokens.append(token)
        torch.cuda.synchronize()
        tok_s[kind] = (SAM_NEW - 2) / (time.perf_counter() - t0)
        streams[kind] = torch.cat(tokens).cpu()
        del prefill_fn, pair_step, state
    graph_equal = torch.equal(streams["graph"], streams["eager"]) and torch.equal(streams["graph"], raw)
    # three prompt lengths: prefill ms (a 1-token call), decode tok/s (the
    # 512-token call less the prefill), the card's memory after each
    lengths = {}
    for n in SAM_PROMPT_LENGTHS:
        p = sam_prompt(n)
        pipe(p, max_new_tokens=1, seed=SEED)
        pipe(p, seed=SEED)  # the first call of a geometry captures its step
        times = {}
        for label, budget in (("prefill_ms", 1), ("call_ms", SAM_NEW)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe(p, max_new_tokens=budget, seed=SEED)
            torch.cuda.synchronize()
            times[label] = 1e3 * (time.perf_counter() - t0)
        lengths[n] = {"num_latents": max(1, min(n - (SAM["max_seq_len"] - SAM["max_latents"]), SAM["max_latents"])),
                      **times, "decode_tok_s": (SAM_NEW - 1) / ((times["call_ms"] - times["prefill_ms"]) / 1e3),
                      "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "generate_fns": len(pipe._gen_cache)}
        log(f"{name} prompt={n}: " + json.dumps(lengths[n]))
    report = {"card": card, "dtype": str(dtype)[6:], "parameters": n_params, "prompt": SAM_PROMPT,
              "new_tokens": SAM_NEW, "top_k": SAM_TOP_K, "num_latents": SAM_PROMPT_LATENTS,
              "first_call_s": first_s, "prefill_launches": prefill, "step_launches": step_launch, **checks,
              "ids": len(ids), "greedy_agreed_with_plain": agreed[0], "graph_equal_eager": graph_equal,
              "pair_tok_s": tok_s, "by_prompt_length": lengths}
    log(f"{name}: " + json.dumps(report))
    if not graph_equal:
        raise SystemExit(f"{name}: the graphed stream differs from the eager one or the pipeline's")
    TIMES[f"{name}_pair_tok_s"] = tok_s
    kept = {"launches": main_launches, "directory": directory, "prompt": prompt, "ids": ids}
    del pipe, model, fn, step
    free_card()
    return kept


def lightning_roundtrip_phase(card: str, root: str, sam: dict) -> None:
    """The f32 SAM of ``sam_generate`` exported as a reference Lightning
    checkpoint (``save_lightning_checkpoint``: ``model.``-prefixed reference
    names, flat hyper-parameters) and imported back
    (``import_symbolic_audio_checkpoint``): the same config, every tensor
    bit for bit; the imported model, on the card, gives the pipeline's ids
    for the same prompt and seed, through K2 and K1."""
    from perceiver_io_tpu_torch.hf import (
        SymbolicAudioGenerationPipeline,
        auto_model_for_config,
        from_pretrained,
        import_symbolic_audio_checkpoint,
        save_lightning_checkpoint,
    )
    from perceiver_io_tpu_torch.ops import build

    model = from_pretrained(sam["directory"])
    path = f"{root}/sam.ckpt"
    t0 = time.perf_counter()
    save_lightning_checkpoint(path, model, model.config)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    config, sd = import_symbolic_audio_checkpoint(path)
    import_s = time.perf_counter() - t0
    want = model.state_dict()
    exact = sorted(sd) == sorted(want) and all(torch.equal(sd[k], want[k].cpu()) for k in want)
    del model
    free_card()
    back = auto_model_for_config(config)
    back.load_state_dict(sd, strict=True)
    build.reset_launches()
    out = SymbolicAudioGenerationPipeline(back)(sam["prompt"], seed=SEED)
    launches = nonzero_launches()
    same_ids = np.array_equal(out.token_ids, sam["ids"])
    import os

    report = {"card": card, "checkpoint_mb": os.path.getsize(path) / 2**20, "save_s": save_s, "import_s": import_s,
              "config_equal": config == back.config, "tensors_bit_for_bit": exact, "ids_equal": same_ids,
              "launches": launches}
    log("lightning_roundtrip: " + json.dumps(report))
    if not (exact and same_ids) or not (launches.get("flash_packed_fwd") and launches.get("layer_norm_fwd")):
        raise SystemExit(f"lightning_roundtrip failed: {report}")
    os.remove(path)
    del back
    free_card()


def cli_rows(run_dir: str) -> list:
    import csv

    with open(f"{run_dir}/metrics.csv") as f:
        return list(csv.DictReader(f))


def cli_fit_phase(card: str, name: str, main, argv: list, steps: int, want: tuple, after=None) -> dict:
    """A task CLI's ``fit`` on the card (``python -m ... fit`` through its
    ``main``): ``steps`` steps logged every step, then its validation; every
    kernel of ``want`` launched, its metrics log holding ``steps`` finite
    train losses and a finite validation loss; ``after(state, report)``, when
    given, checks the trained state before it is dropped. Returns its
    launches."""
    from perceiver_io_tpu_torch.ops import build

    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = main(["fit", *argv, f"--trainer.max_steps={steps}", "--trainer.log_interval=1",
                     "--trainer.tensorboard=false"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = nonzero_launches()
    run_dir = next(a.split("=", 1)[1] for a in argv if a.startswith("--trainer.default_root_dir=")) + "/" + \
        next(a.split("=", 1)[1] for a in argv if a.startswith("--trainer.name="))
    rows = cli_rows(run_dir)
    losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
    val = [float(r["val_loss"]) for r in rows if r.get("val_loss")]
    rates = [float(r["steps_per_sec"]) for r in rows if r.get("steps_per_sec")]
    report = {"card": card, "argv": argv, "steps": int(state.step), "seconds": seconds, "train_loss": losses,
              "val_loss": val, "steps_per_sec": rates, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "device": str(next(state.model.parameters()).device), "launches": launches}
    log(f"{name}: " + json.dumps(report))
    missing = [k for k in want if not launches.get(k)]
    if int(state.step) != steps or len(losses) != steps or not all(map(math.isfinite, losses + val)) or not val \
            or missing or report["device"] != "cuda:0":
        raise SystemExit(f"{name}: steps {state.step}, losses {losses}, val {val}, kernels not launched {missing}")
    if after is not None:
        after(state, report)
    del state
    free_card()
    return launches


def sam_cli_fit_phase(card: str, root: str) -> dict:
    """``scripts/audio/symbolic.py fit`` at train.sh's flags (synthetic data,
    6144 tokens, batch 16, bf16, 2048 latents x 768, 12 layers) for a few
    steps: its corpus (``SAM_CORPUS_PIECES`` pieces a split, enough windows
    for a batch of 16) built first into the directory the CLI reads."""
    from perceiver_io_tpu_torch.data.audio.symbolic import SyntheticSymbolicAudioDataModule
    from perceiver_io_tpu_torch.scripts.audio import symbolic

    data_dir = f"{root}/sam_data"
    SyntheticSymbolicAudioDataModule(data_dir, max_seq_len=SAM["max_seq_len"], num_train_pieces=SAM_CORPUS_PIECES,
                                     num_valid_pieces=SAM_CORPUS_PIECES).prepare_data()
    argv = ["--data.dataset=synthetic", f"--data.dataset_dir={data_dir}", f"--data.max_seq_len={SAM['max_seq_len']}",
            f"--data.batch_size={SAM_BATCH}", "--trainer.precision=bf16", f"--model.max_latents={SAM['max_latents']}",
            f"--model.num_channels={SAM['num_channels']}",
            f"--model.num_self_attention_layers={SAM['num_self_attention_layers']}",
            f"--trainer.default_root_dir={root}", "--trainer.name=sam_cli", "--trainer.checkpoint=false"]
    return cli_fit_phase(card, "sam_cli_fit_bf16", symbolic.main, argv, CLI_STEPS["sam"],
                         tuple(k + BF16 for k in TRAIN_KERNELS))


def mnist_fit_phase(card: str, root: str) -> dict:
    """``scripts/vision/image_classifier.py fit --smoke`` (synthetic digits,
    the script's presets, batch 64, f32) for ``CLI_STEPS["mnist"]`` steps:
    K8/K9a/K9b (the CA's one head of 131), K2/K4 (8 heads of 16), K1/K5."""
    from perceiver_io_tpu_torch.scripts.vision import image_classifier

    argv = ["--smoke", f"--trainer.default_root_dir={root}", "--trainer.name=mnist", "--trainer.checkpoint=false"]
    return cli_fit_phase(card, "mnist_fit", image_classifier.main, argv, CLI_STEPS["mnist"],
                         HEADS_KERNELS + TRAIN_KERNELS)


def timeseries_fit_phase(card: str, root: str) -> dict:
    """``scripts/timeseries.py fit`` at its defaults (timeseries_train's
    model, batch 8, f32) on a CSV of ``TS_CSV_ROWS`` rows of 7 channels
    written here: K8/K9a/K9b, K1/K5."""
    from perceiver_io_tpu_torch.scripts import timeseries

    rng = np.random.default_rng(SEED + 60)
    t = np.arange(TS_CSV_ROWS)[:, None]
    series = np.sin(2 * np.pi * rng.uniform(0.002, 0.05, size=(1, 7)) * t) + 0.05 * rng.normal(size=(TS_CSV_ROWS, 7))
    path = f"{root}/series.csv"
    np.savetxt(path, np.concatenate([t, series], axis=1), delimiter=",", comments="", fmt="%.5f",
               header="date," + ",".join(f"ch{i}" for i in range(7)))
    argv = [f"--data.train_path={path}", f"--data.val_path={path}", f"--trainer.default_root_dir={root}",
            "--trainer.name=timeseries", "--trainer.checkpoint=false"]
    return cli_fit_phase(card, "timeseries_fit", timeseries.main, argv, CLI_STEPS["timeseries"],
                         HEADS_KERNELS + ("layer_norm_fwd", "layer_norm_bwd"))


def pipelines_phase(card: str, root: str) -> dict:
    """The other pipeline tasks, each through ``pipeline(task, model_dir=...)``
    from a ``save_pretrained`` directory of seeded weights at reduced depth
    (``PIPELINE_DEPTH``; their full-depth forwards run in earlier phases),
    f32, each output equal to the same model called directly on the card:

    - ``text-generation``: the flagship CLM on a 4000-byte prompt, 512
      latents, sampled (``top_k`` 10, one seed) against its generate fn, and
      ``num_beams=2`` against ``beam_search``;
    - ``fill-mask``: the masked LM at language-perceiver width against
      ``MaskFiller.fill``;
    - ``sentiment-analysis``: the text classifier against the forward's
      top-k;
    - ``image-classification``: the classifier of ``bench.py`` (224 x 224 x
      3, two images) against the forward's top-k;
    - ``optical-flow``: optical flow on one 368 x 496 pair against
      ``OpticalFlowProcessor.process`` over the forward.

    Returns each task's launches."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer
    from perceiver_io_tpu_torch.data.vision import OpticalFlowProcessor
    from perceiver_io_tpu_torch.hf import MaskFiller, pipeline
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.training import save_pretrained

    rng = np.random.default_rng(SEED + 70)
    tok = ByteTokenizer()
    text = "".join(chr(c) for c in rng.integers(97, 123, size=PIPELINE_PROMPT))
    texts = ["a fine, quiet film", "loud and overlong " * 40]
    images = rng.integers(0, 256, size=(2, 224, 224, 3)).astype(np.uint8)
    pair = [rng.integers(0, 256, size=FLOW_SHAPE + (3,)).astype(np.uint8) for _ in range(2)]
    makers = {
        "text-generation": lambda: CausalLanguageModel(CausalLanguageModelConfig(
            **dict(FLAGSHIP, num_self_attention_layers=PIPELINE_DEPTH)), device="cuda",
            generator=torch.Generator().manual_seed(SEED)),
        "fill-mask": lambda: mlm_model("cuda", layers=PIPELINE_DEPTH),
        "sentiment-analysis": lambda: mlm_model("cuda", layers=PIPELINE_DEPTH, classifier=True),
        "image-classification": lambda: image_classifier("cuda", num_self_attention_layers_per_block=PIPELINE_DEPTH,
                                                         num_self_attention_blocks=1),
        "optical-flow": lambda: flow_model("cuda", num_self_attention_layers_per_block=PIPELINE_DEPTH),
    }

    @torch.no_grad()
    def top(model, x, **kw):
        probs = torch.softmax(model(x, **kw).float(), dim=-1)
        values, index = torch.topk(probs, 2, dim=-1)
        return [[{"label": int(i), "score": float(v)} for v, i in zip(vs, ix)]
                for vs, ix in zip(values.tolist(), index.tolist())]

    launches, report = {}, {"card": card, "depth": PIPELINE_DEPTH}
    for task, make in makers.items():
        model = make()
        directory = f"{root}/{task}"
        save_pretrained(directory, model, model.config)
        del model
        pipe = pipeline(task, model_dir=directory)
        model = pipe.model if hasattr(pipe, "model") else pipe.filler.model
        build.reset_launches()
        t0 = time.perf_counter()
        if task == "text-generation":
            got = pipe(text, max_new_tokens=PIPELINE_NEW, num_latents=NUM_LATENTS, top_k=10, seed=SEED)
            ids, pad = tok.pad_sequences(tok.batch_encode([text]), padding_side="left")
            config = generation.GenerationConfig(max_new_tokens=PIPELINE_NEW, do_sample=True, top_k=10)
            direct = generation.make_generate_fn(model, NUM_LATENTS, config, device="cuda")(
                ids, torch.as_tensor(pad), generator=torch.Generator().manual_seed(SEED))
            want = tok.batch_decode(direct.cpu().numpy().tolist())[0]
            beams = pipe(text, max_new_tokens=PIPELINE_BEAM_NEW, num_latents=NUM_LATENTS, do_sample=False,
                         num_beams=2)
            best, _ = generation.beam_search(model, ids, NUM_LATENTS, num_beams=2, max_new_tokens=PIPELINE_BEAM_NEW,
                                             device="cuda")
            equal = got == want and beams == tok.batch_decode(best.cpu().numpy().tolist())[0]
            detail = {"sampled_chars": len(got), "beam_chars": len(beams)}
        elif task == "fill-mask":
            got = pipe(list(MLM_SAMPLES), top_k=5)
            want = MaskFiller(model, tok, device="cuda").fill(list(MLM_SAMPLES), 5)
            equal, detail = got == want, {"top1": [row[0] for row in got]}
        elif task == "sentiment-analysis":
            got = pipe(texts, top_k=2)
            ids, pad = tok.pad_sequences(tok.batch_encode(texts), max_length=MLM_QUERIES, padding_side="right")
            want = top(model, torch.as_tensor(ids).cuda().long(), pad_mask=torch.as_tensor(pad).cuda())
            equal, detail = got == want, {"top": got}
        elif task == "image-classification":
            got = pipe(images, top_k=2)
            want = top(model, torch.as_tensor(pipe.preprocess(images)).cuda().float())
            equal, detail = got == want, {"top": got}
        else:
            got = pipe(pair)

            @torch.no_grad()
            def model_fn(patches):
                return model(torch.as_tensor(patches).cuda().float()).cpu().numpy()

            want = OpticalFlowProcessor(patch_size=FLOW_SHAPE).process(model_fn, [pair])[0]
            equal = got.shape == FLOW_SHAPE + (2,) and np.array_equal(got, want) and bool(np.isfinite(got).all())
            detail = {"shape": list(got.shape), "max_abs": float(np.abs(got).max())}
        torch.cuda.synchronize()
        launches[task] = nonzero_launches()
        report[task] = {"equal": bool(equal), "seconds": time.perf_counter() - t0, "launches": launches[task],
                        **detail}
        log(f"pipelines {task}: " + json.dumps(report[task]))
        if not equal:
            raise SystemExit(f"pipelines {task}: the pipeline's output differs from the direct call: {report[task]}")
        kernels = {"text-generation": ("flash_packed_fwd", "layer_norm_fwd"),
                   "optical-flow": ("flash_heads_fwd", "flash_packed_fwd", "layer_norm_fwd")}.get(
            task, ("flash_heads_fwd", "flash_packed_fwd", "layer_norm_fwd"))
        missing = [k for k in kernels if not launches[task].get(k)]
        if missing:
            raise SystemExit(f"pipelines {task}: kernels not launched: {missing}")
        del pipe, model
        free_card()
    log("pipelines: " + json.dumps(report))
    return launches


def a13_phases(card: str, by_phase: dict) -> None:
    """The SAM's generation (f32 and bf16) and its Lightning round trip, its
    bf16 train step with the checks against the CPU and its CLI fit, the
    other pipeline tasks, the MNIST and time-series CLI fits; each phase's
    launches into ``by_phase``."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        sam = sam_generate_phase(card, root)
        by_phase["sam_generate"] = sam["launches"]
        lightning_roundtrip_phase(card, root, sam)
        by_phase["sam_generate" + BF16] = sam_generate_phase(card, root, torch.bfloat16)["launches"]
        del sam
        free_card()
        by_phase["sam_train" + BF16] = model_train_pair(card, TASKS["sam"], torch.bfloat16)["launches"]
        model_grad_check_phase(card, TASKS["sam"], torch.bfloat16)
        model_trajectory_phase(card, TASKS["sam"])
        free_card()
        by_phase["sam_cli_fit" + BF16] = sam_cli_fit_phase(card, root)
        for task, launches in pipelines_phase(card, root).items():
            by_phase[f"pipeline {task}"] = launches
        by_phase["mnist_fit"] = mnist_fit_phase(card, root)
        by_phase["timeseries_fit"] = timeseries_fit_phase(card, root)
    free_card()


def text_clm_cli_fit_phase(card: str, root: str) -> dict:
    """``scripts/text/clm.py fit`` at its paper preset (its defaults,
    ``TEXT_CLM``, batch 8) in bf16 on ``textfile`` data: the repository's
    ``docs/*.md`` joined for training, ``README.md`` for validation, whose
    end generates ``TEXT_SAMPLE_TOKENS`` tokens from ``TEXT_SAMPLE_PROMPT``
    on the card. K1, K2, K4a, K4b and K5 bf16 launch. K2's, K4a's and K4b's
    launches over the train steps alone (read before the first validation)
    by kv rows are exactly ``TEXT_CLM_PER_STEP`` a step, and go into the
    ``TEXT_CLM_ROWS`` kernel cases; the sample is logged; steps/s and the
    peak memory recorded. Returns its launches."""
    import glob
    import os

    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.scripts.text import clm
    from perceiver_io_tpu_torch.training.trainer import Trainer

    train = f"{root}/docs.txt"
    with open(train, "w") as out:
        for path in sorted(glob.glob("docs/*.md")):
            with open(path) as f:
                out.write(f.read() + "\n\n")
    steps = CLI_STEPS["text_clm"]
    argv = ["--data.dataset=textfile", f"--data.train_file={train}", "--data.valid_file=README.md",
            f"--data.cache_dir={root}/text_cache", "--trainer.precision=bf16",
            f"--task.sample_prompt={TEXT_SAMPLE_PROMPT}", f"--task.num_sample_tokens={TEXT_SAMPLE_TOKENS}",
            f"--trainer.default_root_dir={root}", "--trainer.name=text_clm", "--trainer.checkpoint=false"]

    def after(state, report):
        config = {k: getattr(state.model.config, k) for k in TEXT_CLM}
        with open(f"{root}/text_clm/samples.txt") as f:
            samples = f.read()
        head = f"--- step {steps} [generated_text] ---\n{TEXT_SAMPLE_PROMPT}"
        TIMES["text_clm_cli_fit" + BF16] = {k: report[k] for k in ("steps_per_sec", "peak_memory_gb", "train_loss")}
        log(f"text_clm_cli_fit_bf16 config={json.dumps(config)} train_bytes={os.path.getsize(train)} "
            f"sample_chars={len(samples)} card={card}")
        if config != TEXT_CLM or state.model.dtype != torch.bfloat16 or not samples.startswith(head):
            raise SystemExit(f"text_clm_cli_fit_bf16: config {config}, dtype {state.model.dtype}, or no sample "
                             f"from the prompt: {samples[:200]!r}")

    trained, validate = {}, Trainer.validate

    def validate_after_counting(self, state, val_loader):
        if not trained:
            trained.update(steps=int(state.step), by_kv=dict(build.LAUNCHES_BY_KV))
        return validate(self, state, val_loader)

    Trainer.validate = validate_after_counting
    try:
        launches = cli_fit_phase(card, "text_clm_cli_fit" + BF16, clm.main, argv, steps,
                                 tuple(k + BF16 for k in TRAIN_KERNELS), after)
    finally:
        Trainer.validate = validate
    per_step = {f"{kernel} kv={kv}": n / trained["steps"] for (kernel, kv), n in sorted(trained["by_kv"].items())}
    want = {f"{kernel}{BF16} kv={TEXT_CLM_KV[case]}": n for case, n in TEXT_CLM_PER_STEP.items()
            for kernel in ("flash_packed_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq")}
    TIMES["text_clm_cli_fit" + BF16]["launches_per_step"] = per_step
    log(f"text_clm_cli_fit_bf16 launches a train step by kv rows, over {trained['steps']} steps: "
        f"{json.dumps(per_step)} card={card}")
    if trained["steps"] != steps or per_step != want:
        raise SystemExit(f"text_clm_cli_fit_bf16: K2/K4a/K4b launches a train step {per_step} over "
                         f"{trained['steps']} steps, not {want} over {steps}")
    for case, kernel, row in TEXT_CLM_ROWS:
        row["launches_per_step"] = per_step[f"{kernel}{BF16} kv={TEXT_CLM_KV[case]}"]
    return launches


def attention_family(name: str, launches: dict, suffix: str, family: str) -> None:
    """The attention kernels a CLI's heads took: all three kernels of
    ``family`` (K2/K4 or K8/K9) and K1/K5, each in the ``suffix`` build;
    fails on a missing one or on any launch of the other family or of the
    other build."""
    families = {"K2/K4": ("flash_packed_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq"),
                "K8/K9": HEADS_KERNELS}
    want = families[family] + ("layer_norm_fwd", "layer_norm_bwd")
    took = {k: n for k, n in launches.items() if n}
    log(f"{name} kernels: {json.dumps(took)} (want {family} with K1/K5, {suffix or '_f32'} builds)")
    if set(took) != {k + suffix for k in want}:
        raise SystemExit(f"{name}: launched {took}, not {family} and K1/K5 alone in the {suffix or '_f32'} builds")


def text_mlm_classifier_phases(card: str, root: str, by_phase: dict) -> None:
    """``scripts/text/mlm.py fit`` at its defaults (64 latents x 64, 8
    layers, 256 tokens, batch 64) in bf16 on the synthetic corpus, its
    weights saved by ``save_pretrained``; then ``scripts/text/classifier.py
    fit`` (f32, its defaults) on the synthetic ``clf`` corpus, its encoder
    warm-started from that artifact and frozen: after the fit the encoder
    (``classifier.ENCODER_PREFIX``) equals the artifact's bit for bit. Each
    phase's heads take K2/K4 (head widths that pack) beside K1/K5, and no
    other kernel."""
    from perceiver_io_tpu_torch.scripts.text import classifier, mlm
    from perceiver_io_tpu_torch.training import load_pretrained, save_pretrained

    artifact = f"{root}/mlm_artifact"
    flags = ["--data.dataset=synthetic", f"--data.cache_dir={root}/text_cache", f"--trainer.default_root_dir={root}",
             "--trainer.checkpoint=false"]
    name = "text_mlm_cli_fit" + BF16
    by_phase[name] = cli_fit_phase(card, name, mlm.main, [*flags, "--trainer.precision=bf16", "--trainer.name=mlm"],
                                   CLI_STEPS["text_mlm"], (),
                                   lambda state, report: save_pretrained(artifact, state.model, state.model.config))
    attention_family(name, by_phase[name], BF16, "K2/K4")
    source, _ = load_pretrained(artifact)

    def frozen(state, report):
        weights = state.model.state_dict()
        encoder = [k for k in weights if k.startswith(classifier.ENCODER_PREFIX + ".")]
        differ = [k for k in encoder if not torch.equal(weights[k].cpu(), source[k])]
        log(f"text_classifier_cli_fit encoder tensors={len(encoder)} equal to the artifact's="
            f"{len(encoder) - len(differ)} card={card}")
        if not encoder or differ:
            raise SystemExit(f"text_classifier_cli_fit: the frozen encoder moved: {differ[:5]}")

    by_phase["text_classifier_cli_fit"] = cli_fit_phase(
        card, "text_classifier_cli_fit", classifier.main,
        [*flags, "--trainer.name=classifier", f"--model.encoder.params={artifact}", "--model.encoder.freeze=true"],
        CLI_STEPS["text_clf"], (), frozen)
    attention_family("text_classifier_cli_fit", by_phase["text_classifier_cli_fit"], "", "K2/K4")


def serve_fleet_bf16_phase(card: str, root: str) -> dict:
    """A ``FleetRouter`` over two ``EngineFrontEnd`` replicas of serve_bf16's
    model and engine (bf16 pools, their decode steps captured at
    construction on the shared capture stream, one model's weights), each
    with a journal under ``root``, on one ``ManualClock``: ``FLEET_REQUESTS``
    greedy requests at 8 live, r0 killed at its ``FLEET_KILL_STEP``-th drive
    step and its journal replayed onto r1. The fleet's books balance with
    one failover and every request ok, its audit is empty, every request
    reaches exactly one terminal outcome across the replicas and r0's
    journal closes by handoff; K3, K2 and K1 bf16 launch; every stream (and
    one engine's on the same requests) equals the sequential bf16 stream up
    to its first near tie. The failover's seconds, the fleet's and the one
    engine's tok/s are recorded; the dropped fleet gives its memory back.
    Returns the fleet's launches."""
    from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import FaultInjector, FleetRouter, ManualClock, RequestJournal, RequestSpec

    bf16 = torch.bfloat16
    model = flagship_bf16()
    specs = drawn_specs(RequestSpec, FLEET_REQUESTS, FLEET_PROMPTS, FLEET_BUDGETS, SEED + 80)
    run_dir = f"{root}/fleet"
    free_card()
    before = torch.cuda.memory_allocated()
    clock, events = ManualClock(), EventLog(run_dir, main_process=True)
    injector = FaultInjector().kill_replica_at("r0", FLEET_KILL_STEP)
    router = FleetRouter(clock=clock, events=events, injector=injector)
    replicas = {}
    for rid in ("r0", "r1"):
        replicas[rid], _ = serve_engine(model, graphed=True, cache_dtype=bf16, clock=clock, sleep=clock.sleep,
                                        injector=injector, events=events, journal=f"{run_dir}/journal-{rid}.jsonl")
        router.add_replica(rid, replicas[rid])
    failover_s = []
    failover = router.failover

    def timed_failover(*args, **kwargs):
        t = time.perf_counter()
        info = failover(*args, **kwargs)
        failover_s.append(time.perf_counter() - t)
        return info

    router.failover = timed_failover
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router.run_closed(specs, concurrency=2 * SERVE_SLOTS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = nonzero_launches()
    books, problems = router.books(), router.audit()
    terminal = collections.Counter(r.index for fe in replicas.values() for r in fe.records if r.outcome is not None)
    served = {**replicas["r0"].served_tokens, **replicas["r1"].served_tokens}
    dead = RequestJournal(f"{run_dir}/journal-r0.jsonl").books()
    rows = [e for e in merged_events(run_dir) if e.get("event") == "serve.failover"]
    decoded = sum(len(served[s.index]) - 1 for s in specs)
    report = {"card": card, "requests": len(specs), "books": {k: v for k, v in books.items() if k != "replicas"},
              "audit": problems, "dead_journal": dead, "failover_s": failover_s,
              "failover_rows": [{k: r.get(k) for k in ("dead_replica", "survivor", "n_replayed", "n_parked",
                                                       "n_queued")} for r in rows],
              "wall_s": wall_s, "decoded": decoded, "fleet_tok_s": decoded / wall_s,
              "steps": {rid: fe._engine_steps for rid, fe in replicas.items()},
              "k3": launches.get("paged_decode" + BF16, 0), "launches": launches}
    invalid = validate_events(run_dir, strict_spans=False)
    log("serve_fleet_bf16: " + json.dumps(report))
    if (not books["balanced"] or books["failovers"] != 1 or books["outcomes"]["ok"] != len(specs) or problems
            or books["orphaned"] < 1 or terminal != {s.index: 1 for s in specs} or not dead["balanced"]
            or dead.get("pending") or len(rows) != 1 or len(failover_s) != 1 or invalid):
        raise SystemExit(f"serve_fleet_bf16: the failover's books: {report}, terminal outcomes {dict(terminal)}, "
                         f"events {invalid}")
    missing = [k + BF16 for k in SERVE_KERNELS if not launches.get(k + BF16)]
    if missing:
        raise SystemExit(f"serve_fleet_bf16: kernels not launched: {missing}")
    del router, replicas, failover, timed_failover
    free_card()
    kept = torch.cuda.memory_allocated() - before
    log(f"serve_fleet_bf16 dropped: {kept} bytes kept of the fleet's, card={card}")
    if kept > FLEET_LEAK_BYTES:
        raise SystemExit(f"serve_fleet_bf16: the dropped fleet keeps {kept} bytes on the card")

    # one engine on the same requests, and both against the sequential streams
    engine, _ = serve_engine(model, graphed=True, cache_dtype=bf16)
    t0 = time.perf_counter()
    engine.run_closed(specs, concurrency=2 * SERVE_SLOTS)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    single = dict(engine.served_tokens)
    del engine
    free_card()
    agreed = check_streams("serve_fleet_bf16", model, specs, served, NEAR_TIE_BF16, bf16)
    check_streams("serve_fleet_bf16 one engine", model, specs, single, NEAR_TIE_BF16, bf16)
    TIMES["serve_fleet" + BF16] = {"failover_s": failover_s[0], "fleet_tok_s": decoded / wall_s,
                                   "one_engine_tok_s": decoded / one_s, "tokens_equal_to_sequential": agreed,
                                   "equal_to_one_engine": sum(served[s.index] == single[s.index] for s in specs)}
    log("serve_fleet_bf16 against one engine: " + json.dumps({"card": card, **TIMES["serve_fleet" + BF16]}))
    del model
    free_card()
    return launches


def sim_bf16_phase(card: str, root: str) -> None:
    """The simulator (host work only): ``ServiceTimeModel.from_load_doc``
    fitted to load_bf16's closed-loop LOAD document, then ``run_sim`` with
    two tenants at serve_bf16's ``EngineConfig`` (``SIM_*``) and
    ``run_fleet_sim`` over two replicas at twice the rates: the books
    balance, every allocator audit is empty, and the SIM document is
    written under ``root`` and logged with the fit beside the card."""
    import os

    from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec, build_load_doc
    from perceiver_io_tpu_torch.serving import EngineConfig, FrontEndConfig, sim

    closed = TIMES["load_bf16"]["closed"]
    load_doc = build_load_doc(0, dict(closed, mode="closed"),
                              WorkloadSpec(seed=SEED, prompt_lens=LOAD_PROMPTS, max_new_tokens=LOAD_BUDGETS))
    fit = sim.ServiceTimeModel.from_load_doc(load_doc, source="load_bf16")
    log("sim_bf16 service-time fit: " + json.dumps({"card": card, **fit.to_dict()}))
    engine_config = EngineConfig(**SERVE_GEOMETRY)
    # a request's share of the engine at p50: its prefill alone (joins run
    # one at a time), its decode steps shared by the slots
    capacity = 1.0 / (fit.prefill_p50_s + LOAD_BUDGETS[0] * fit.tpot_p50_s / SERVE_SLOTS)

    def tenants(scale: float):
        return [sim.TenantSpec("chat", rate_rps=scale * SIM_RATE_SHARES[0] * capacity, n_requests=SIM_REQUESTS[0],
                               prompt_lens=LOAD_PROMPTS, max_new_tokens=LOAD_BUDGETS, seed=SEED + 1),
                sim.TenantSpec("docs", rate_rps=scale * SIM_RATE_SHARES[1] * capacity, n_requests=SIM_REQUESTS[1],
                               prompt_lens=LOAD_PROMPTS, max_new_tokens=LOAD_BUDGETS, seed=SEED + 2,
                               shared_prefix_len=SIM_SHARED_PREFIX)]

    config = FrontEndConfig(max_queue=512, admission_projection=False)
    t0 = time.perf_counter()
    run = sim.run_sim(tenants(1.0), service_model=fit, engine_config=engine_config, config=config, seed=SEED,
                      vocab_size=FLAGSHIP["vocab_size"])
    sim_s = time.perf_counter() - t0
    fe = run.frontend
    problems = fe.audit() + fe.sharing_audit()
    doc = sim.build_sim_doc(0, run.summary, tenants(1.0), fit, engine_config, extra={"card": card})
    path = f"{root}/SIM_bf16.json"
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    with open(path) as f:
        written = json.load(f)
    t0 = time.perf_counter()
    fleet = sim.run_fleet_sim(tenants(2.0), n_replicas=2, service_model=fit, engine_config=engine_config,
                              config=config, seed=SEED, vocab_size=FLAGSHIP["vocab_size"])
    fleet_s = time.perf_counter() - t0
    fleet_problems = fleet.router.audit() + [p for f in fleet.frontends for p in f.ca_alloc.audit() + f.sa_alloc.audit()]
    metrics = sim.sim_doc_metrics(written)
    keys = ("n_requests", "duration_s", "offered_rps", "achieved_rps", "fairness_jain", "max_starvation_age_s",
            "shed_rate", "evictions", "prefix_hits", "ttft_s", "tpot_s", "queue_wait_s", "books_balanced")
    report = {"card": card, "fit": fit.to_dict(), "capacity_rps": capacity, "host_s": sim_s, "metrics": metrics,
              "summary": {k: run.summary.get(k) for k in keys}, "doc_bytes": os.path.getsize(path),
              "fleet": {"host_s": fleet_s, **{k: fleet.summary.get(k) for k in keys + ("throughput_tok_s",)}}}
    log("sim_bf16: " + json.dumps(report))
    if (not run.summary["books_balanced"] or problems or fe.ca_alloc.pages_used or fe.sa_alloc.pages_used
            or not fleet.summary["books_balanced"] or fleet_problems or not metrics
            or written["summary"]["n_requests"] != sum(SIM_REQUESTS) or not sim.diff_sim(written, doc)["ok"]):
        raise SystemExit(f"sim_bf16: books, audits or the SIM document: {problems} {fleet_problems} {report}")


def a13_text_phases(card: str, by_phase: dict) -> None:
    """The text CLIs, the fleet router (ROADMAP A13, part 3): text_clm,
    text_mlm and text_classifier CLI fits and serve_fleet_bf16; each phase's
    launches into ``by_phase``; files under a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        by_phase["text_clm_cli_fit" + BF16] = text_clm_cli_fit_phase(card, root)
        text_mlm_classifier_phases(card, root, by_phase)
        by_phase["serve_fleet" + BF16] = serve_fleet_bf16_phase(card, root)
    free_card()


def dist_nccl_phase(card: str):
    """The card's process group: ``parallel.make_mesh`` starts NCCL at world
    size 1 (no launcher) and builds the 4-axis mesh; one all-reduce on the
    card. Returns the mesh. A group that cannot start fails the smoke."""
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    t0 = time.perf_counter()
    mesh = make_mesh(data=1, fsdp=1, device="cuda")
    x = torch.full((4,), 3.0, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    report = {"card": card, "backend": dist.get_backend(), "world_size": dist.get_world_size(),
              "mesh": mesh_shape(mesh), "mesh_device": mesh.device_type, "init_s": time.perf_counter() - t0,
              "all_reduce": x.tolist()}
    log("dist_nccl: " + json.dumps(report))
    if report["backend"] != "nccl" or report["world_size"] != 1 or x.tolist() != [3.0] * 4:
        raise SystemExit(f"dist_nccl: {report}")
    return mesh


def dist_model(dtype: torch.dtype):
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    config = CausalLanguageModelConfig(**dict(FLAGSHIP, cross_attention_dropout=0.0))
    return CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED), dtype=dtype)


def dist_batch() -> dict:
    n = FLAGSHIP["max_seq_len"]
    t = torch.from_numpy(np.random.default_rng(SEED).integers(0, FLAGSHIP["vocab_size"], size=(DIST_BATCH, n + 1)))
    return {"input_ids": t[:, :-1].cuda(), "labels": t[:, 1:].cuda(), "pad_mask": None}


def dist_steps(state, step, batch: dict, steps: int) -> dict:
    """``steps`` eager steps: losses, ms, peak memory and launches."""
    from perceiver_io_tpu_torch.ops import build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    build.reset_launches()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    return {"losses": losses, "step_ms": step_ms, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "memory_before_steps_gb": base_gb, "launches": nonzero_launches()}


def check_per_step(name: str, launches: dict, per_step: dict, steps: int) -> None:
    """Every launch of the run a bf16 build's, exactly ``per_step`` a step."""
    want = {k + BF16: n * steps for k, n in per_step.items()}
    got = {k: launches.get(k, 0) for k in want}
    extra = {k: n for k, n in launches.items() if k not in want}
    if got != want or extra:
        raise SystemExit(f"{name}: launches {got} (others {extra}), expected {want}")


def fsdp_clm_bf16_phase(card: str, mesh) -> dict:
    """The flagship bf16 train step under ``shard_train_state`` on the
    (data 1, fsdp 1) mesh against the same steps unsharded, from copies of
    the same weights (``dist_model``): DIST_STEPS eager steps each, AdamW
    1e-3 with bf16 moments and a clip at 1.0 (train_bf16's optimizer), batch
    2. Returns the sharded run's launches."""
    from perceiver_io_tpu_torch import training as tt

    batch, runs, params = dist_batch(), {}, {}
    for kind in ("unsharded", "sharded"):
        state = tt.TrainState.create(dist_model(torch.bfloat16), tt.make_optimizer(
            TRAIN_LR, gradient_clip=1.0, moment_dtype="bfloat16"))
        if kind == "sharded":
            state = tt.shard_train_state(state, mesh)
        step = tt.make_train_step(tt.clm_loss_fn(FLAGSHIP["max_latents"]), jit=False)
        runs[kind] = dist_steps(state, step, batch, DIST_STEPS)
        params[kind] = [(p.full_tensor() if kind == "sharded" else p).detach().clone()
                        for p in state.model.parameters()]
        del state, step
        free_card()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(runs["sharded"]["losses"], runs["unsharded"]["losses"])]
    param_err = max(max_err(a, b) for a, b in zip(params["sharded"], params["unsharded"]))
    report = {"card": card, "mesh": "data=1 fsdp=1 tensor=1 seq=1", "batch": DIST_BATCH, "steps": DIST_STEPS,
              "seq_len": FLAGSHIP["max_seq_len"], "latents": FLAGSHIP["max_latents"], "loss_rel_diff": loss_rel,
              "loss_rtol": DIST_LOSS_RTOL, "param_max_abs_diff": param_err, "param_atol": DIST_PARAM_ATOL, **runs}
    log("fsdp_clm_bf16: " + json.dumps(report))
    TIMES["fsdp_clm_bf16"] = {kind: {"median_step_ms": statistics.median(run["step_ms"]),
                                     "peak_memory_gb": run["peak_memory_gb"]} for kind, run in runs.items()}
    del params
    if not all(map(math.isfinite, runs["sharded"]["losses"])) or not all(within(e, DIST_LOSS_RTOL) for e in loss_rel) \
            or not within(param_err, DIST_PARAM_ATOL):
        raise SystemExit(f"fsdp_clm_bf16: the sharded steps differ from the unsharded: {report}")
    for kind, run in runs.items():
        check_per_step(f"fsdp_clm_bf16 {kind}", run["launches"], DIST_PER_STEP, DIST_STEPS)
    timed = fsdp_step_times(mesh, batch)
    log("fsdp_clm_bf16 timed: " + json.dumps({"card": card, "step_ms": timed}))
    for kind, ms in timed.items():
        TIMES["fsdp_clm_bf16"][kind].update(timed_median_step_ms=statistics.median(ms), timed_min_step_ms=min(ms),
                                            timed_max_step_ms=max(ms), timed_steps=len(ms))
    return runs["sharded"]["launches"]


def fsdp_step_times(mesh, batch: dict) -> dict:
    """``{kind: [ms]}``: DIST_TIMED_STEPS eager steps of the sharded and the
    unsharded state, interleaved (sharded, unsharded, ...) after one warm
    step each, so the card's clocks and the allocator weigh on both alike."""
    from perceiver_io_tpu_torch import training as tt

    states, steps, ms = {}, {}, {"sharded": [], "unsharded": []}
    for kind in ms:
        state = tt.TrainState.create(dist_model(torch.bfloat16), tt.make_optimizer(
            TRAIN_LR, gradient_clip=1.0, moment_dtype="bfloat16"))
        states[kind] = tt.shard_train_state(state, mesh) if kind == "sharded" else state
        steps[kind] = tt.make_train_step(tt.clm_loss_fn(FLAGSHIP["max_latents"]), jit=False)
        states[kind], _ = steps[kind](states[kind], batch)
    for _ in range(DIST_TIMED_STEPS):
        for kind in ms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[kind], metrics = steps[kind](states[kind], batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            ms[kind].append(1e3 * (time.perf_counter() - t0))
    del states, steps
    free_card()
    return ms


def ring_clm_bf16_phase(card: str) -> dict:
    """``make_ring_clm_loss`` on a (seq 1) mesh, deterministic, on
    fsdp_clm_bf16's model and batch: its loss and gradient against the dense
    ``clm_loss_fn``'s, both held to the f32 dense evaluation by RING_RULE;
    then RING_STEPS train steps through ``make_train_step`` on the state
    sharded over that mesh (their ms, peak and launches). Returns the
    steps' launches."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.parallel.long_context import make_ring_clm_loss
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, seq=1, device="cuda")
    batch, lat = dist_batch(), FLAGSHIP["max_latents"]
    dense = tt.clm_loss_fn(lat, deterministic=True)

    def loss_and_grad(model, loss_fn):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, batch, None, deterministic=True)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), torch.cat([p.grad.float().flatten() for p in model.parameters()])

    f32 = dist_model(torch.float32)
    l32, g32 = loss_and_grad(f32, dense)
    del f32
    free_card()
    model = dist_model(torch.bfloat16)
    l_dense, g_dense = loss_and_grad(model, dense)
    ring = make_ring_clm_loss(model, mesh, max_latents=lat)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    l_ring, g_ring = loss_and_grad(model, ring)
    ring_ms, ring_peak = 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated() / 1e9
    norm = float(g32.norm())
    dist_ = {"loss": {"dense_bf16": abs(l_dense - l32), "ring_bf16": abs(l_ring - l32)},
             "grad_rel_l2": {"dense_bf16": float((g_dense - g32).norm()) / norm,
                             "ring_bf16": float((g_ring - g32).norm()) / norm}}
    limits = {"loss": RING_RULE[0] * dist_["loss"]["dense_bf16"] + RING_RULE[1] * abs(l32),
              "grad_rel_l2": RING_RULE[0] * dist_["grad_rel_l2"]["dense_bf16"] + RING_RULE[1]}
    del g32, g_dense, g_ring
    model.zero_grad(set_to_none=True)
    state = tt.shard_train_state(tt.TrainState.create(model, tt.make_optimizer(
        TRAIN_LR, gradient_clip=1.0, moment_dtype="bfloat16")), mesh)
    ring = make_ring_clm_loss(state.model, mesh, max_latents=lat)
    step = tt.make_train_step(lambda m, b, g: ring(m, b, g, deterministic=True), jit=False)
    run = dist_steps(state, step, batch, RING_STEPS)
    report = {"card": card, "mesh": "data=1 fsdp=1 tensor=1 seq=1", "batch": DIST_BATCH,
              "ca_plain_scores": [DIST_BATCH, FLAGSHIP["num_heads"], lat, FLAGSHIP["max_seq_len"] - lat],
              "loss": {"f32": l32, "dense_bf16": l_dense, "ring_bf16": l_ring}, "distance_from_f32": dist_,
              "limits": limits, "rule": RING_RULE, "ring_forward_backward_ms": ring_ms,
              "ring_forward_backward_peak_gb": ring_peak, "step": run}
    log("ring_clm_bf16: " + json.dumps(report))
    TIMES["ring_clm_bf16"] = {"median_step_ms": statistics.median(run["step_ms"]), "step_ms": run["step_ms"],
                              "peak_memory_gb": run["peak_memory_gb"]}
    del state, step, model
    free_card()
    if not all(within(dist_[k]["ring_bf16"], limits[k]) for k in limits) or not all(map(math.isfinite,
                                                                                       run["losses"])):
        raise SystemExit(f"ring_clm_bf16: the ring's loss or gradient is off: {report}")
    check_per_step("ring_clm_bf16", run["launches"], RING_PER_STEP, RING_STEPS)
    return run["launches"]


def docs_corpus(root: str) -> str:
    """The repository's ``docs/*.md`` joined into one training file."""
    import glob

    train = f"{root}/docs.txt"
    if not os.path.exists(train):
        with open(train, "w") as out:
            for path in sorted(glob.glob("docs/*.md")):
                with open(path) as f:
                    out.write(f.read() + "\n\n")
    return train


def text_clm_cli_fsdp_bf16_phase(card: str, root: str, by_phase: dict) -> None:
    """``scripts/text/clm.py fit`` at the paper preset in bf16 with
    ``--trainer.strategy=fsdp`` for CLI_STEPS["text_clm_fsdp"] steps (a
    weights-only checkpoint at its validation), then the same run resumed
    from it on the same mesh (``--trainer.resume=auto``) for 2 steps more,
    then ``--trainer.strategy=ring`` for CLI_STEPS["text_clm_ring"]: each
    with finite losses, a validation and the kernels launched."""
    from perceiver_io_tpu_torch.parallel.mesh import mesh_shape
    from perceiver_io_tpu_torch.scripts.text import clm

    argv = ["--data.dataset=textfile", f"--data.train_file={docs_corpus(root)}", "--data.valid_file=README.md",
            f"--data.cache_dir={root}/text_cache", "--trainer.precision=bf16", f"--trainer.default_root_dir={root}"]
    steps = CLI_STEPS["text_clm_fsdp"]
    kernels = tuple(k + BF16 for k in TRAIN_KERNELS)

    def on_mesh(state, report):
        shape = None if state.mesh is None else mesh_shape(state.mesh)
        log(f"text_clm_cli mesh {json.dumps(shape)} ({report['argv'][-1]}) card={card}")
        if shape is None:
            raise SystemExit("text_clm_cli_fsdp_bf16: the fit ran without a mesh")

    fsdp = ["--trainer.strategy=fsdp", "--trainer.name=text_clm_fsdp"]
    by_phase["text_clm_cli_fsdp" + BF16] = cli_fit_phase(
        card, "text_clm_cli_fsdp" + BF16, clm.main, [*argv, f"--trainer.val_interval={steps}", *fsdp], steps,
        kernels, on_mesh)
    rows = cli_rows(f"{root}/text_clm_fsdp")
    cli_fit_phase(card, "text_clm_cli_fsdp_resume" + BF16, clm.main,
                  [*argv, f"--trainer.val_interval={steps + 2}", "--trainer.resume=auto", *fsdp], steps + 2,
                  kernels, on_mesh)
    resumed = cli_rows(f"{root}/text_clm_fsdp")
    if [r["train_loss"] for r in resumed if r.get("train_loss")][:steps] != \
            [r["train_loss"] for r in rows if r.get("train_loss")]:
        raise SystemExit("text_clm_cli_fsdp_bf16: the resumed run's log does not keep the first run's rows")
    ring_steps = CLI_STEPS["text_clm_ring"]
    by_phase["text_clm_cli_ring" + BF16] = cli_fit_phase(
        card, "text_clm_cli_ring" + BF16, clm.main,
        [*argv, f"--trainer.val_interval={ring_steps}", "--trainer.strategy=ring", "--trainer.name=text_clm_ring"],
        ring_steps, kernels, on_mesh)


def a12_phases(card: str, by_phase: dict) -> None:
    """Training across processes (ROADMAP A12, part 1) on the card's
    one-process NCCL group: dist_nccl, fsdp_clm_bf16, ring_clm_bf16 and
    text_clm_cli_fsdp_bf16; each phase's launches into ``by_phase``."""
    import tempfile

    t0 = time.perf_counter()
    mesh = dist_nccl_phase(card)
    by_phase["fsdp_clm" + BF16] = fsdp_clm_bf16_phase(card, mesh)
    by_phase["ring_clm" + BF16] = ring_clm_bf16_phase(card)
    with tempfile.TemporaryDirectory() as root:
        text_clm_cli_fsdp_bf16_phase(card, root, by_phase)
    free_card()
    log(f"a12_phases: {time.perf_counter() - t0:.1f} s card={card}")


def kernel_name(mangled: str) -> str:
    """A mangled kernel's name and template arguments, e.g.
    ``heads_fwd_kernel<264>``, ``flash_packed_kernel<F32,64>`` (a
    ``pio::mma`` policy and its head-dim bucket) or
    ``paged_walk_kernel<2,1>``; the mangled name itself when no
    ``*_kernel`` identifier is found."""
    import re

    pos = 0
    while (m := re.compile(r"\d+").search(mangled, pos)) is not None:
        end = m.end() + int(m.group())  # a length-prefixed identifier
        ident = mangled[m.end():end]
        if ident.endswith("_kernel"):
            t = re.match(r"I(?:N3pio3mma\d+([A-Z0-9]+)I)?((?:Li\d+E)+)", mangled[end:])
            if t is None:
                return ident
            args = ([t.group(1)] if t.group(1) else []) + re.findall(r"Li(\d+)E", t.group(2))
            return f"{ident}<{','.join(args)}>"
        pos = end
    return mangled


def ptxas_report(logs: dict) -> dict:
    """source -> [[kernel (instantiation), registers, spill stores, spill
    loads]] from the builds' ``-Xptxas=-v`` output."""
    import re

    report = {}
    for source, text in logs.items():
        rows, name, spills = [], None, (0, 0)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name is not None:
                rows.append([name, int(m.group(1)), *spills])
                name, spills = None, (0, 0)
        report[source] = rows
    return report


def sass_mma_report(paths: dict) -> dict:
    """source -> {kernel (instantiation): {tensor-core instruction (``HMMA``
    or the f64 ``DMMA``, with its shape and types): count}} from
    ``cuobjdump -sass`` of each built library."""
    import os
    import re

    from perceiver_io_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    report = {}
    for source, path in paths.items():
        text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
        counts, name = {}, None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = kernel_name(m.group(1))
                counts[name] = {}
            elif name is not None and (m := re.search(r"\b([HD]MMA\.[A-Za-z0-9.]+)", line)):
                counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
        report[source] = counts
    return report


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from perceiver_io_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0].split(',')[-1].strip()} limit)"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {card}")

    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"build: {sorted(build.CUDA_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(build.BUILD_LOGS)
    log("ptxas: " + json.dumps(ptxas))
    # a cached library's log is read back from beside it: every source has rows
    unreported = [name for name in build.CUDA_SOURCES if not ptxas.get(name)]
    if unreported:
        raise SystemExit(f"no ptxas report for {unreported}: the spill check would see nothing of them")
    log("ptxas K8 registers by head-dim bucket: " + json.dumps(
        {name: regs for name, regs, _, _ in ptxas["flash_heads"] if name.startswith("heads_fwd")}))
    log("ptxas K3 (registers, spill stores, spill loads; shared memory is dynamic, see the plan lines): " +
        json.dumps(ptxas["paged_decode"]))
    spills = [row for rows in ptxas.values() for row in rows if row[2] or row[3]]
    if spills:
        raise SystemExit(f"kernels spill registers: {spills}")
    # K2, K4a, K4b, K6, K7a, K7b, K8, K9a and K9b run their products on the
    # tensor cores in every head-dim bucket (three each for K2, K4, K6 and
    # K7: 32, 64, 128; five for K8 and K9: 64, 128, 256, 288, 512): TF32 in
    # every f32 build of K2, K6 and K8 and in K4a's and K7a's (their dV and
    # dK), f64 DMMA in K4a's, K4b's, K7a's and K7b's (their score products,
    # and K4b's and K7b's dQ) and in K9a's and K9b's (all their products),
    # bf16 in the bf16 builds of K2, K4a, K4b, K6, K7a, K7b, K8, K9a and K9b
    sass_sources = ("flash_packed", "flash_packed_bwd", "flash_2seg", "flash_2seg_bwd", "flash_heads",
                    "flash_heads_bwd")
    sass = sass_mma_report({name: paths[name] for name in sass_sources})
    log("sass tensor-core instructions per kernel: " + json.dumps(sass))
    for source, kernel, kind, builds in (("flash_packed", "flash_packed_kernel<F32", "TF32", 3),
                                         ("flash_packed", "flash_packed_kernel<BF16", "BF16", 3),
                                         ("flash_packed_bwd", "flash_bwd_dkv_kernel<", "TF32", 3),
                                         ("flash_packed_bwd", "flash_bwd_dkv_kernel<", "DMMA", 3),
                                         ("flash_packed_bwd", "flash_bwd_dq_kernel<", "DMMA", 3),
                                         ("flash_packed_bwd", "flash_bwd_dkv_bf16_kernel<", "BF16", 3),
                                         ("flash_packed_bwd", "flash_bwd_dq_bf16_kernel<", "BF16", 3),
                                         ("flash_2seg", "flash_2seg_fwd_kernel<F32", "TF32", 3),
                                         ("flash_2seg", "flash_2seg_fwd_kernel<BF16", "BF16", 3),
                                         ("flash_2seg_bwd", "flash_2seg_bwd_dkv_kernel<", "TF32", 3),
                                         ("flash_2seg_bwd", "flash_2seg_bwd_dkv_kernel<", "DMMA", 3),
                                         ("flash_2seg_bwd", "flash_2seg_bwd_dq_kernel<", "DMMA", 3),
                                         ("flash_2seg_bwd", "flash_2seg_bwd_dkv_bf16_kernel<", "BF16", 3),
                                         ("flash_2seg_bwd", "flash_2seg_bwd_dq_bf16_kernel<", "BF16", 3),
                                         ("flash_heads", "heads_fwd_kernel<", "TF32", 5),
                                         ("flash_heads_bwd", "heads_bwd_dkv_kernel<", "DMMA", 5),
                                         ("flash_heads_bwd", "heads_bwd_dq_kernel<", "DMMA", 5),
                                         ("flash_heads", "heads_fwd_bf16_kernel<", "BF16", 5),
                                         ("flash_heads_bwd", "heads_bwd_dkv_bf16_kernel<", "BF16", 5),
                                         ("flash_heads_bwd", "heads_bwd_dq_bf16_kernel<", "BF16", 5)):
        built = [n for n in sass[source] if n.startswith(kernel)]
        found = [n for n in built if any(kind in i for i in sass[source][n])]
        if len(built) != builds or found != built:
            raise SystemExit(f"{source}: {kind} tensor-core instructions in {found} of {built}, expected in all "
                             f"{builds} {kernel}>s")

    gen = torch.Generator().manual_seed(SEED)
    bwd_source = "perceiver_io_tpu_torch/ops/csrc/flash_packed_bwd.cu"
    ln_source = "perceiver_io_tpu_torch/ops/layernorm_triton.py"
    twoseg_source = "perceiver_io_tpu_torch/ops/csrc/flash_2seg"

    def by_dtype(res: dict, bf16: bool) -> dict:
        return {"cases": [c for c in res["cases"] if (c.get("dtype") == "bfloat16") == bf16]}

    dkv, dq, fwd_train = flash_bwd_phase(gen)
    fwd = flash_phase(gen)
    fwd["cases"] += fwd_train["cases"]
    twoseg = twoseg_phase(gen)
    heads = heads_phase(gen)
    heads_source = "perceiver_io_tpu_torch/ops/csrc/flash_heads"
    paged = paged_phase(gen)
    paged_bf16 = paged_phase(gen, torch.bfloat16)
    ln_fwd, ln_bwd = layernorm_phase(gen), layernorm_bwd_phase(gen)
    k2_source = "perceiver_io_tpu_torch/ops/csrc/flash_packed.cu"
    k3_source = "perceiver_io_tpu_torch/ops/csrc/paged_decode.cu"
    results = {
        "flash_packed_fwd": ("cuda", k2_source, "perceiver_io_tpu/ops/flash_attention.py:606", by_dtype(fwd, False)),
        "paged_decode": ("cuda", k3_source, "perceiver_io_tpu/ops/paged_attention.py:62", paged),
        "layer_norm_fwd": ("triton", ln_source, "perceiver_io_tpu/ops/layernorm.py:94", by_dtype(ln_fwd, False)),
        "flash_packed_bwd_dkv": ("cuda", bwd_source, "perceiver_io_tpu/ops/flash_attention.py:683",
                                 by_dtype(dkv, False)),
        "flash_packed_bwd_dq": ("cuda", bwd_source, "perceiver_io_tpu/ops/flash_attention.py:741",
                                by_dtype(dq, False)),
        "layer_norm_bwd": ("triton", ln_source, "perceiver_io_tpu/ops/layernorm.py:116", by_dtype(ln_bwd, False)),
        # the bf16 builds of the bf16 CLM's path
        "flash_packed_fwd" + BF16: ("cuda", k2_source, "perceiver_io_tpu/ops/flash_attention.py:606",
                                    by_dtype(fwd, True)),
        "paged_decode" + BF16: ("cuda", k3_source, "perceiver_io_tpu/ops/paged_attention.py:62", paged_bf16),
        "layer_norm_fwd" + BF16: ("triton", ln_source, "perceiver_io_tpu/ops/layernorm.py:94", by_dtype(ln_fwd, True)),
        "flash_packed_bwd_dkv" + BF16: ("cuda", bwd_source, "perceiver_io_tpu/ops/flash_attention.py:683",
                                        by_dtype(dkv, True)),
        "flash_packed_bwd_dq" + BF16: ("cuda", bwd_source, "perceiver_io_tpu/ops/flash_attention.py:741",
                                       by_dtype(dq, True)),
        "layer_norm_bwd" + BF16: ("triton", ln_source, "perceiver_io_tpu/ops/layernorm.py:116",
                                  by_dtype(ln_bwd, True)),
        "flash_2seg_fwd": ("cuda", f"{twoseg_source}.cu", "perceiver_io_tpu/ops/flash_attention.py:1107",
                           twoseg["flash_2seg_fwd"]),
        "flash_2seg_bwd_dkv": ("cuda", f"{twoseg_source}_bwd.cu", "perceiver_io_tpu/ops/flash_attention.py:1189",
                               twoseg["flash_2seg_bwd_dkv"]),
        "flash_2seg_bwd_dq": ("cuda", f"{twoseg_source}_bwd.cu", "perceiver_io_tpu/ops/flash_attention.py:1263",
                              twoseg["flash_2seg_bwd_dq"]),
        # the bf16 builds of the bf16 CLM's twoseg route
        "flash_2seg_fwd" + BF16: ("cuda", f"{twoseg_source}.cu", "perceiver_io_tpu/ops/flash_attention.py:1107",
                                  twoseg["flash_2seg_fwd" + BF16]),
        "flash_2seg_bwd_dkv" + BF16: ("cuda", f"{twoseg_source}_bwd.cu",
                                      "perceiver_io_tpu/ops/flash_attention.py:1189", twoseg["flash_2seg_bwd_dkv" + BF16]),
        "flash_2seg_bwd_dq" + BF16: ("cuda", f"{twoseg_source}_bwd.cu",
                                     "perceiver_io_tpu/ops/flash_attention.py:1263", twoseg["flash_2seg_bwd_dq" + BF16]),
        "flash_heads_fwd": ("cuda", f"{heads_source}.cu", "perceiver_io_tpu/ops/flash_attention.py:196",
                            heads["flash_heads_fwd"]),
        "flash_heads_bwd_dkv": ("cuda", f"{heads_source}_bwd.cu", "perceiver_io_tpu/ops/flash_attention.py:294",
                                heads["flash_heads_bwd_dkv"]),
        "flash_heads_bwd_dq": ("cuda", f"{heads_source}_bwd.cu", "perceiver_io_tpu/ops/flash_attention.py:348",
                               heads["flash_heads_bwd_dq"]),
        # the bf16 builds of the bf16 image classifier's path
        "flash_heads_fwd" + BF16: ("cuda", f"{heads_source}.cu", "perceiver_io_tpu/ops/flash_attention.py:196",
                                   heads["flash_heads_fwd" + BF16]),
        "flash_heads_bwd_dkv" + BF16: ("cuda", f"{heads_source}_bwd.cu",
                                       "perceiver_io_tpu/ops/flash_attention.py:294", heads["flash_heads_bwd_dkv" + BF16]),
        "flash_heads_bwd_dq" + BF16: ("cuda", f"{heads_source}_bwd.cu",
                                      "perceiver_io_tpu/ops/flash_attention.py:348", heads["flash_heads_bwd_dq" + BF16]),
    }
    by_phase = {"serve": serve_phase(card)}
    free_card()
    train = train_pair(card)
    train_twoseg = train_pair(card, "twoseg", concat=train)
    by_phase.update(train=train["graph"]["launches"], train_twoseg=train_twoseg["graph"]["launches"],
                    eval_twoseg=eval_twoseg_phase(card))
    free_card()
    # activation checkpointing in f32: train's step bit for bit, at a lower peak
    by_phase["train_remat"] = train_pair(card, variant="remat", plain=train)["graph"]["launches"]
    drop_params(train, train_twoseg)
    free_card()
    grad_check_phase(card)
    grad_check_phase(card, "twoseg")
    free_card()
    # the bf16 CLM: serve, train step (graph and eager), gradient check
    by_phase["serve_bf16"] = serve_bf16_phase(card)
    free_card()
    # int8 page pools and int8 weights (ROADMAP A10) beside serve_bf16
    by_phase["serve_int8_bf16"] = serve_int8_bf16_phase(card, TIMES["serve_bf16"])
    free_card()
    # the admission tier (ROADMAP A6) around serve_bf16's captured step
    by_phase["serve_admission_bf16"] = serve_admission_bf16_phase(card)
    free_card()
    # prefix sharing, eviction and journal recovery (ROADMAP A7 + A8)
    by_phase["serve_share_evict_bf16"] = serve_share_evict_bf16_phase(card)
    free_card()
    train_bf16 = train_pair(card, dtype=torch.bfloat16)
    by_phase["train_bf16"] = train_bf16["graph"]["launches"]
    log("train_bf16 against train (f32), this run: " + json.dumps({"card": card, **{
        f"{dt} {kind}": {"median_step_ms": run["median_step_ms"],
                         "train_tokens_per_s": TRAIN_BATCH * FLAGSHIP["max_seq_len"] / (run["median_step_ms"] / 1e3),
                         "busy_share": run["busy_share"], "losses": run["losses"]}
        for dt, pair in (("f32", train), ("bf16", train_bf16)) for kind, run in pair.items()}}))
    grad_check_bf16_phase(card)
    free_card()
    # the bf16 CLM's twoseg route: train step (graph and eager) against
    # train_bf16's, the full-window forward on both routes, the gradient
    train_twoseg_bf16 = train_pair(card, "twoseg", concat=train_bf16, dtype=torch.bfloat16)
    by_phase["train_twoseg_bf16"] = train_twoseg_bf16["graph"]["launches"]
    log("train_twoseg_bf16 against train_bf16 (concat), this run: " + json.dumps({"card": card, **{
        f"{route} {kind}": {"median_step_ms": run["median_step_ms"], "busy_share": run["busy_share"],
                            "train_tokens_per_s": TRAIN_BATCH * FLAGSHIP["max_seq_len"] / (run["median_step_ms"] / 1e3)}
        for route, pair in (("concat", train_bf16), ("twoseg", train_twoseg_bf16)) for kind, run in pair.items()}}))
    by_phase["eval_twoseg_bf16"] = eval_twoseg_phase(card, torch.bfloat16)
    free_card()
    grad_check_bf16_phase(card, "twoseg")
    free_card()
    # the training options (ROADMAP A4) at the flagship in bf16: checkpointing
    # and offloading (train_bf16's step bit for bit, at a lower peak), the
    # "mask" prefix-dropout mode on both routes (train_bf16's losses within
    # MASK_LOSS_TOL_BF16), attention and residual dropout (its own graph and
    # eager runs, then the replays at lr 0); then the optimizers
    variants = {"train_remat_bf16": dict(variant="remat", plain=train_bf16),
                "train_offload_bf16": dict(variant="offload", plain=train_bf16),
                "train_mask_bf16": dict(variant="mask", concat=train_bf16),
                "train_mask_twoseg_bf16": dict(route="twoseg", variant="mask", concat=train_bf16),
                "train_dropout_bf16": dict(variant="dropout")}
    a4 = {}
    for phase, kwargs in variants.items():
        a4[phase] = train_pair(card, dtype=torch.bfloat16, **kwargs)
        drop_params(a4[phase])
        by_phase[phase] = a4[phase]["graph"]["launches"]
        free_card()
    drop_params(train_bf16, train_twoseg_bf16)
    log("A4 training options against train_bf16, this run: " + json.dumps({"card": card, **{
        f"{phase} {kind}": {"median_step_ms": run["median_step_ms"], "peak_memory_gb": run["peak_memory_gb"],
                            "busy_share": run["busy_share"]}
        for phase, pair in (("train_bf16", train_bf16), *a4.items()) for kind, run in pair.items()}}))
    dropout_replays_phase(card)
    optim_phase(card)
    free_card()
    # the trainer (ROADMAP A5): Trainer.fit around train_bf16's captured step
    by_phase["fit_bf16"] = fit_phase(card)
    free_card()
    # numerics probes in train_bf16's captured step and the trainer (A11.3)
    by_phase["train_probes_bf16"] = train_probes_bf16_phase(card, train_bf16)
    # the contiguous decode pair (make_decode_fns, generate) as a CUDA graph
    by_phase["decode_pair"] = decode_pair_phase(card)
    free_card()
    # its decode health gauges, and the breaker's sentinel feed (A11.3)
    by_phase["decode_probes_bf16"] = decode_probes_bf16_phase(card)
    # generate on int8 caches and int8 weights at bench.py's geometries
    by_phase["decode_int8_bf16"] = decode_int8_bf16_phase(card)
    free_card()
    image_f32 = image_eval_phase(card)
    by_phase["image_eval"] = image_f32["launches"]
    free_card()
    image_train = model_train_pair(card, TASKS["image"])
    by_phase["image_train"] = image_train["launches"]
    model_grad_check_phase(card, TASKS["image"])
    model_trajectory_phase(card, TASKS["image"])
    free_card()
    # the bf16 image classifier: eval and train step (graph and eager), then
    # its gradient against the CPU's
    by_phase["image_eval_bf16"] = image_eval_phase(card, torch.bfloat16, image_f32["logits"])["launches"]
    del image_f32
    free_card()
    image_train_bf16 = model_train_pair(card, TASKS["image"], torch.bfloat16)
    by_phase["image_train_bf16"] = image_train_bf16["launches"]
    # activation checkpointing (bench.py --remat): the standard route
    by_phase["image_train_remat_bf16"] = model_train_pair(card, TASKS["image"], torch.bfloat16, remat=True,
                                                          plain=image_train_bf16)["launches"]
    log("image_train_bf16 against image_train (f32), this run: " + json.dumps({"card": card, **{
        f"{dt} {kind}": {"median_step_ms": TIMES[f"{name}_median_ms"][kind],
                         "images_per_s": IMAGE_BATCH / (TIMES[f"{name}_median_ms"][kind] / 1e3),
                         "busy_share": TIMES[f"{name}_busy_share"][kind], "losses": run["losses"][kind]}
        for dt, name, run in (("f32", "image_train", image_train), ("bf16", "image_train" + BF16, image_train_bf16))
        for kind in ("graph", "eager")}}))
    free_card()
    model_grad_check_phase(card, TASKS["image"], torch.bfloat16)
    free_card()
    # the Perceiver IO task models (ROADMAP A13, part 1): the masked LM's fill
    # and bf16 train step, the text classifier's bf16 train step, optical
    # flow at 368 x 496, the time series' train step
    mlm = mlm_fill_phase(card)
    by_phase["mlm_fill"] = mlm["launches"]
    free_card()
    by_phase["mlm_fill_bf16"] = mlm_fill_phase(card, torch.bfloat16, mlm["cpu_f32"])["launches"]
    del mlm
    free_card()
    for stem, dtype in (("mlm", torch.bfloat16), ("text_clf", torch.bfloat16), ("timeseries", torch.float32)):
        task = TASKS[stem]
        by_phase[f"{stem}_train" + (BF16 if dtype == torch.bfloat16 else "")] = model_train_pair(
            card, task, dtype)["launches"]
        model_grad_check_phase(card, task, dtype)
        model_trajectory_phase(card, task)
        free_card()
    flow = flow_phase(card)
    by_phase["flow"] = flow["launches"]
    by_phase["flow_bf16"] = flow_phase(card, torch.bfloat16, flow["plain"])["launches"]
    del flow
    free_card()
    # the symbolic audio model, the inference tier and the training CLI
    # (ROADMAP A13, part 2); their files under a temporary directory
    a13_phases(card, by_phase)
    # the text CLIs and the fleet router (ROADMAP A13, part 3)
    a13_text_phases(card, by_phase)
    # speculative decode (ROADMAP A9) and beam search (A10) on the bf16 CLM
    by_phase["serve_spec_bf16"] = serve_spec_bf16_phase(card)
    free_card()
    by_phase["beam_bf16"] = beam_bf16_phase(card)
    free_card()
    # the load runner, SLO reports, the flight recorder and the scrape server
    # over the serving engine (A11.2); the profiler rollup (A11.3)
    by_phase["load_bf16"] = load_bf16_phase(card)
    profile_rollup_phase(card)
    # the simulator, its service times fitted to load_bf16's (A13, part 3)
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        sim_bf16_phase(card, root)
    # training across processes (ROADMAP A12, part 1): the one-process NCCL
    # group, the sharded and sequence-parallel steps, the CLI's strategies
    a12_phases(card, by_phase)
    log("graph against eager, this run: " + json.dumps({"card": card, **TIMES}))

    kernels = []
    for name, (route, source, replaces, res) in results.items():
        # each kernel's launches from the path that runs it: the CLM training
        # path for the five it runs, its twoseg configuration for K6/K7a/K7b,
        # the serve for the paged decode, the image classifier's train step
        # for K8/K9a/K9b (each bf16 build from its phase in BF16_PHASE); its
        # error, times and bound from the first case at
        # that path's shapes
        phase = BF16_PHASE.get(name) or ("train" if name in TRAIN_KERNELS else "train_twoseg" if name in TWOSEG_KERNELS
                                         else "image_train" if name in HEADS_KERNELS else "serve")
        main_case = next(c for c in res["cases"] if c["path"] == phase)
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces, launches=by_phase[phase][name],
            launches_phase=phase, launches_by_phase={p: counts.get(name, 0) for p, counts in by_phase.items()},
            max_abs_err=max(c["max_abs_err"] for c in res["cases"] if c["tol"] == main_case["tol"]),
            tol=main_case["tol"], ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], dispatch_ms=main_case["dispatch_ms"], shape=main_case["case"],
            card=card, cases=res["cases"],
        ))
    print(json.dumps({"graph_nodes": GRAPH_NODES}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
