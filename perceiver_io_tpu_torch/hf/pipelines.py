"""Inference pipelines (counterpart of ``perceiver_io_tpu/hf/pipelines.py``),
the analog of the reference's HF pipeline registrations (reference:
perceiver/model/*/huggingface.py):

- ``fill-mask``            (reference: mlm/huggingface.py + MaskFiller)
- ``text-generation``      (reference: clm/huggingface.py:11-65)
- ``sentiment-analysis``   (reference: classifier/huggingface.py:23-121)
- ``image-classification`` (reference: vision/image_classifier/huggingface.py)
- ``optical-flow``         (reference: vision/optical_flow/huggingface.py:71-124)
- ``symbolic-audio-generation`` (reference: audio/symbolic/huggingface.py:63-190)

Each pipeline holds a model (which holds its weights) on ``device``
(``"cuda"`` by default; pass ``device="cpu"`` for a model on the CPU) plus
its host-side processor, and exposes ``__call__``.
``pipeline(task, model_dir)`` builds one from a ``save_pretrained`` directory
through the auto-model registry.

Sampled streams follow the port's generator law (``generation``'s
docstring): a call's ``seed`` seeds one CPU ``torch.Generator`` that draws
one uniform an emitted token, so the numbers differ from the JAX package's
key chain; greedy streams and beam search draw nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from perceiver_io_tpu_torch.device import DeviceLike, check_same_device, resolve_device
from perceiver_io_tpu_torch.generation import GenerationConfig, make_generate_fn
from perceiver_io_tpu_torch.hf.auto import from_pretrained
from perceiver_io_tpu_torch.hf.mask_filler import MaskFiller


def _on_device(model, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    check_same_device(dev, model.device, "the model")
    return dev


def _cached_generate_fn(
    cache: Dict[Any, Any],
    model,
    num_latents: int,
    gen_config: GenerationConfig,
    device: torch.device,
    cache_dtype=torch.float32,
    weight_dtype=None,
):
    """One generate fn per window and sampling settings: each keeps its
    captured decode steps (``make_generate_fn``), so a repeated call replays
    them. The storage dtypes ride in the key: they are plain mutable
    pipeline attributes, and a change after a first call must not serve a
    stale fn."""
    key = (
        num_latents,
        str(cache_dtype),
        None if weight_dtype is None else str(weight_dtype),
        *dataclasses.astuple(gen_config),
    )
    if key not in cache:
        cache[key] = make_generate_fn(model, num_latents, gen_config, cache_dtype=cache_dtype,
                                      weight_dtype=weight_dtype, device=device)
    return cache[key]


class FillMaskPipeline:
    """Top-k fill-ins for mask positions in text."""

    def __init__(self, model, tokenizer=None, device: DeviceLike = "cuda"):
        from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer

        self.tokenizer = tokenizer or ByteTokenizer()
        self.filler = MaskFiller(model, self.tokenizer, device=device)

    def __call__(self, text: Union[str, Sequence[str]], top_k: int = 5):
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        out = self.filler.fill(texts, num_predictions=top_k)
        return out[0] if single else out


class TextGenerationPipeline:
    """Prompted generation with the Perceiver AR sliding-window KV cache
    (reference: clm/huggingface.py text-generation registration +
    core/huggingface.py:187-230 generate(num_latents=...))."""

    def __init__(self, model, tokenizer=None, cache_dtype: torch.dtype = torch.float32, weight_dtype=None,
                 device: DeviceLike = "cuda"):
        """``cache_dtype=torch.int8`` quantizes KV-cache storage (batched
        serving), ``weight_dtype=torch.int8`` the decode step's weights
        (latency-bound small-batch serving): the knobs of ``generation``'s
        decode entry points."""
        from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer

        self.device = _on_device(model, device)
        self.model = model
        self.tokenizer = tokenizer or ByteTokenizer()
        self.cache_dtype = cache_dtype
        self.weight_dtype = weight_dtype
        self._gen_cache: Dict[Any, Any] = {}

    def _generate(self, ids, pad_mask, num_latents: int, gen_config: GenerationConfig, seed: int) -> np.ndarray:
        fn = _cached_generate_fn(self._gen_cache, self.model, num_latents, gen_config, self.device,
                                 cache_dtype=self.cache_dtype, weight_dtype=self.weight_dtype)
        out = fn(torch.as_tensor(ids), pad_mask=None if pad_mask is None else torch.as_tensor(pad_mask),
                 generator=torch.Generator().manual_seed(seed))
        return out.cpu().numpy()

    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        max_new_tokens: int = 64,
        num_latents: int = 1,
        do_sample: bool = True,
        temperature: float = 1.0,
        top_k: Optional[int] = 10,
        top_p: Optional[float] = None,
        num_beams: int = 1,
        seed: int = 0,
    ):
        single = isinstance(prompt, str)
        prompts = [prompt] if single else list(prompt)
        seqs = self.tokenizer.batch_encode(prompts)
        ids, pad_mask = self.tokenizer.pad_sequences(seqs, padding_side="left")
        ids, pad_mask, num_latents = _fit_prompt_window(self.model.config, ids, pad_mask, num_latents)

        if num_beams > 1:
            if do_sample:
                raise ValueError("num_beams > 1 requires do_sample=False (beam search is deterministic)")
            from perceiver_io_tpu_torch.generation import beam_search

            # beam search never slides the cross-attention window, so the
            # prompt must leave room for the new tokens
            limit = self.model.config.max_seq_len - max_new_tokens
            if limit < 1:
                raise ValueError("max_new_tokens leaves no room for a prompt within max_seq_len")
            if ids.shape[1] > limit:
                ids = ids[:, -limit:]
                if pad_mask is not None:
                    pad_mask = pad_mask[:, -limit:]
                ids, pad_mask, num_latents = _fit_prompt_window(self.model.config, ids, pad_mask, num_latents)
            num_latents = _clamp_latents_to_real_length(self.model.config, ids, pad_mask, num_latents)

            out, _ = beam_search(
                self.model,
                torch.as_tensor(ids),
                num_latents=num_latents,
                num_beams=num_beams,
                max_new_tokens=max_new_tokens,
                pad_mask=None if pad_mask is None or not pad_mask.any() else torch.as_tensor(pad_mask),
                cache_dtype=self.cache_dtype,
                weight_dtype=self.weight_dtype,
                device=self.device,
            )
            texts = self.tokenizer.batch_decode(out.cpu().numpy().tolist())
            return texts[0] if single else texts

        out = self._generate(
            ids,
            pad_mask,
            num_latents,
            GenerationConfig(
                max_new_tokens=max_new_tokens,
                do_sample=do_sample,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
            ),
            seed,
        )
        texts = self.tokenizer.batch_decode(out.tolist())
        return texts[0] if single else texts


def _topk_labels(logits: torch.Tensor, id2label: Optional[Dict[int, Any]], top_k: int) -> List[Any]:
    """Per row: top-k {label, score} entries (a single entry when top_k=1)."""
    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
    order = np.argsort(-probs, axis=-1)[:, :top_k]
    results = []
    for row in range(probs.shape[0]):
        entries = [
            {"label": id2label[int(i)] if id2label else int(i), "score": float(probs[row, i])}
            for i in order[row]
        ]
        results.append(entries[0] if top_k == 1 else entries)
    return results


def _fit_prompt_window(config, ids: np.ndarray, pad_mask: Optional[np.ndarray], num_latents: int):
    """Fit a prompt into the model window the way the reference's generation
    integration does (reference: core/huggingface.py:110-130): truncate to the
    last ``max_seq_len`` tokens and raise ``num_latents`` to the minimum that
    keeps the prefix within ``max_prefix_len``."""
    if ids.shape[1] > config.max_seq_len:
        ids = ids[:, -config.max_seq_len :]
        if pad_mask is not None:
            pad_mask = pad_mask[:, -config.max_seq_len :]
    max_prefix_len = config.max_seq_len - config.max_latents
    min_latents = ids.shape[1] - max_prefix_len
    num_latents = max(num_latents, min_latents)
    num_latents = min(num_latents, config.max_latents, ids.shape[1])
    return ids, pad_mask, num_latents


def _clamp_latents_to_real_length(config, ids: np.ndarray, pad_mask: Optional[np.ndarray], num_latents: int):
    """Keep left padding out of the latent region (generation contract:
    pads are masked in cross-attention only): num_latents may not exceed the
    shortest real prompt length. Raises when the window minimum (forced by
    max_prefix_len) already conflicts — i.e. the batch mixes prompts too
    disparate in length for one shared window."""
    if pad_mask is None or not pad_mask.any():
        return num_latents
    seq_len = ids.shape[1]
    shortest_real = seq_len - int(pad_mask.sum(axis=1).max())
    min_latents = max(1, seq_len - (config.max_seq_len - config.max_latents))
    if shortest_real < min_latents:
        raise ValueError(
            "prompt lengths differ too much to share one window: the shortest "
            f"prompt has {shortest_real} tokens but the window forces at least "
            f"{min_latents} latents; batch prompts of similar length"
        )
    return min(max(num_latents, min_latents), shortest_real)


class TextClassificationPipeline:
    """Sentiment analysis / sequence classification
    (reference: text/classifier/huggingface.py sentiment-analysis)."""

    def __init__(self, model, tokenizer=None, id2label: Optional[Dict[int, Any]] = None,
                 device: DeviceLike = "cuda"):
        from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer

        self.device = _on_device(model, device)
        self.model = model
        self.tokenizer = tokenizer or ByteTokenizer()
        self.id2label = id2label

    @torch.no_grad()
    def __call__(self, text: Union[str, Sequence[str]], top_k: int = 1):
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        seqs = self.tokenizer.batch_encode(texts)
        max_len = getattr(self.model.config.encoder, "max_seq_len", None)
        ids, pad_mask = self.tokenizer.pad_sequences(seqs, max_length=max_len, padding_side="right")

        dev = self.device
        logits = self.model(torch.as_tensor(ids, device=dev).long(), pad_mask=torch.as_tensor(pad_mask, device=dev))
        results = _topk_labels(logits, self.id2label, top_k)
        return results[0] if single else results


class ImageClassificationPipeline:
    """Image classification over channels-last images
    (reference: vision/image_classifier/huggingface.py:37-118 input processor
    with channels-last + normalization options)."""

    def __init__(
        self,
        model,
        id2label: Optional[Dict[int, Any]] = None,
        image_mean: float = 0.5,
        image_std: float = 0.5,
        preprocessor=None,
        device: DeviceLike = "cuda",
    ):
        from perceiver_io_tpu_torch.data.vision.preprocessor import ImagePreprocessor

        self.device = _on_device(model, device)
        self.model = model
        self.id2label = id2label
        # no resize/crop by default — images must already match the model's
        # grid; pass e.g. ImageNetPreprocessor() for the 256->224 val transform
        self.preprocessor = preprocessor or ImagePreprocessor(
            size=None, crop_size=None, image_mean=image_mean, image_std=image_std
        )

    @staticmethod
    def _as_image_list(images):
        """Split the input into per-image arrays; accepts a single image, a
        stacked batch, or a (possibly ragged) list of images."""
        if isinstance(images, (list, tuple)):
            return [np.asarray(im) for im in images], False
        x = np.asarray(images)
        if x.ndim == 4:
            return [x[i] for i in range(x.shape[0])], False
        return [x], True

    def preprocess(self, images) -> np.ndarray:
        batch, _ = self._as_image_list(images)
        x = self.preprocessor.preprocess_batch(batch)
        expected = tuple(self.model.config.encoder.image_shape)
        if x.shape[-1] != expected[-1] and expected[-1] == 1:
            x = x.mean(axis=-1, keepdims=True)  # grayscale option
        return x

    @torch.no_grad()
    def __call__(self, images, top_k: int = 1):
        _, single = self._as_image_list(images)
        x = self.preprocess(images)
        logits = self.model(torch.as_tensor(x, device=self.device).float())
        results = _topk_labels(logits, self.id2label, top_k)
        return results[0] if single else results


class OpticalFlowPipeline:
    """Frame pairs -> dense flow: patch-grid preprocess, micro-batched
    forward, weighted-blend postprocess, optional HSV rendering
    (reference: vision/optical_flow/huggingface.py:71-115)."""

    def __init__(self, model, processor=None, micro_batch_size: int = 1, device: DeviceLike = "cuda"):
        from perceiver_io_tpu_torch.data.vision.optical_flow import OpticalFlowProcessor

        self.device = _on_device(model, device)
        self.model = model
        self.processor = processor or OpticalFlowProcessor(patch_size=tuple(model.config.encoder.image_shape))
        self.micro_batch_size = micro_batch_size

    @torch.no_grad()
    def _model_fn(self, patches: np.ndarray) -> np.ndarray:
        n = patches.shape[0]
        if n < self.micro_batch_size:  # pad to the micro-batch size, as the JAX pipeline's compiled batch
            pad = self.micro_batch_size - n
            patches = np.concatenate([patches, np.zeros((pad,) + patches.shape[1:], patches.dtype)])
        flow = self.model(torch.as_tensor(patches, device=self.device).float())
        return flow.float().cpu().numpy()[:n]

    def __call__(self, image_pairs, render: bool = False):
        """:param image_pairs: one (frame1, frame2) pair or a list of pairs,
        frames (H, W, 3) uint8.
        :return: (H, W, 2) flow per pair (or RGB rendering with render=True)."""
        single = not isinstance(image_pairs[0], (list, tuple))
        pairs = [image_pairs] if single else list(image_pairs)
        flows = self.processor.process(self._model_fn, pairs, batch_size=self.micro_batch_size)
        if render:
            from perceiver_io_tpu_torch.data.vision.optical_flow import render_optical_flow

            out = [render_optical_flow(f) for f in flows]
        else:
            out = list(flows)
        return out[0] if single else out


@dataclass
class SymbolicAudioOutput:
    token_ids: np.ndarray
    notes: List[Any] = field(default_factory=list)
    midi_path: Optional[str] = None
    audio_path: Optional[str] = None


class SymbolicAudioGenerationPipeline:
    """MIDI continuation: prompt (token ids or .mid file) -> generate ->
    decoded notes / MIDI file / optional fluidsynth-rendered audio
    (reference: audio/symbolic/huggingface.py:63-190)."""

    def __init__(self, model, cache_dtype: torch.dtype = torch.float32, weight_dtype=None,
                 device: DeviceLike = "cuda"):
        """Same storage knobs as :class:`TextGenerationPipeline` (generation
        is the identical sliding-window decode loop)."""
        self.device = _on_device(model, device)
        self.model = model
        self.cache_dtype = cache_dtype
        self.weight_dtype = weight_dtype
        self._gen_cache: Dict[Any, Any] = {}

    def __call__(
        self,
        prompt,
        max_new_tokens: int = 512,
        num_latents: int = 1,
        temperature: float = 1.0,
        top_k: Optional[int] = 15,
        top_p: Optional[float] = None,
        seed: int = 0,
        output_midi_path: Optional[str] = None,
        render_audio: bool = False,
        output_audio_path: Optional[str] = None,
    ) -> SymbolicAudioOutput:
        from perceiver_io_tpu_torch.data.audio import midi

        if render_audio and output_midi_path is None:
            raise ValueError("render_audio requires output_midi_path")

        if isinstance(prompt, (str,)) or hasattr(prompt, "__fspath__"):
            prompt_ids = midi.encode_midi_file(prompt)
            if prompt_ids is None:
                raise ValueError(f"Could not encode MIDI prompt {prompt!r}")
        else:
            prompt_ids = np.asarray(prompt, dtype=np.int32)
        prompt_ids = prompt_ids.reshape(1, -1)
        prompt_ids, _, num_latents = _fit_prompt_window(self.model.config, prompt_ids, None, num_latents)

        gen_config = GenerationConfig(
            max_new_tokens=max_new_tokens,
            do_sample=True,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
        )
        fn = _cached_generate_fn(self._gen_cache, self.model, num_latents, gen_config, self.device,
                                 cache_dtype=self.cache_dtype, weight_dtype=self.weight_dtype)
        out = fn(torch.as_tensor(prompt_ids), generator=torch.Generator().manual_seed(seed))
        ids = out[0].cpu().numpy()
        ids = ids[ids != midi.PAD_ID]
        notes = midi.decode_events(ids.tolist())

        midi_path = None
        if output_midi_path is not None:
            midi.decode_to_midi_file(ids.tolist(), output_midi_path)
            midi_path = str(output_midi_path)

        audio_path = None
        if render_audio:
            audio_path = _render_fluidsynth(midi_path, output_audio_path)

        return SymbolicAudioOutput(token_ids=ids, notes=notes, midi_path=midi_path, audio_path=audio_path)


def _render_fluidsynth(midi_path: str, audio_path: Optional[str]) -> str:
    """Render a MIDI file to WAV through the fluidsynth CLI
    (reference: audio/symbolic/huggingface.py fluidsynth subprocess)."""
    import shutil
    import subprocess

    if shutil.which("fluidsynth") is None:
        raise RuntimeError("fluidsynth is not installed — cannot render audio")
    audio_path = audio_path or midi_path.rsplit(".", 1)[0] + ".wav"
    subprocess.run(["fluidsynth", "-ni", midi_path, "-F", str(audio_path)], check=True)
    return str(audio_path)


_PIPELINES = {
    "fill-mask": FillMaskPipeline,
    "text-generation": TextGenerationPipeline,
    "sentiment-analysis": TextClassificationPipeline,
    "text-classification": TextClassificationPipeline,
    "image-classification": ImageClassificationPipeline,
    "optical-flow": OpticalFlowPipeline,
    "symbolic-audio-generation": SymbolicAudioGenerationPipeline,
}


def pipeline(task: str, model_dir: Optional[str] = None, model=None, *, device: DeviceLike = "cuda",
             dtype: Optional[torch.dtype] = None, **kwargs):
    """Build a pipeline by task name, from a ``save_pretrained`` directory
    (loaded on ``device``, with compute ``dtype``) or from a model. The JAX
    function takes ``params`` beside ``model``; a port model holds its
    weights."""
    if task not in _PIPELINES:
        raise ValueError(f"Unknown task {task!r}; available: {sorted(_PIPELINES)}")
    if model_dir is not None:
        model = from_pretrained(model_dir, device=device, dtype=dtype)
    if model is None:
        raise ValueError("Provide either model_dir or model")
    return _PIPELINES[task](model, device=device, **kwargs)
