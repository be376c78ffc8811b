"""The port's inference tier (``hf.auto``, ``hf.pipelines``) against the JAX
package's, at micro widths, each port model loaded from a
``save_pretrained`` directory of the JAX model's converted weights.

Covered: ``text-generation`` greedy (a left-padded batch) and with
``num_beams=2``, ``fill-mask``, ``sentiment-analysis``,
``image-classification``, ``optical-flow`` and
``symbolic-audio-generation`` at ``top_k=1`` through ``pipeline(task,
model_dir=...)`` on the CPU, each against JAX's ``pipeline(task, model=,
params=)``; the errors of ``pipeline()``; ``from_pretrained`` on a
``config.json`` that names the JAX package's config class; the generate-fn
cache keyed on the storage dtypes; the sampled SAM stream's invariants
(equal for one seed, every id below ``PAD_ID``, the notes decoded).

Tolerances (f32): token streams, fill-mask strings and labels exact; class
scores atol 1e-5 (softmax of logits that agree within 1e-4, the level of
``tests/test_torch_image.py``); flow arrays atol 1e-4 (as
``tests/test_torch_optical_flow.py``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.data.text.tokenizer import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.data.vision.optical_flow import OpticalFlowProcessor as JaxOpticalFlowProcessor
from perceiver_io_tpu.hf import pipeline as jax_pipeline
from perceiver_io_tpu.models.audio import SymbolicAudioModel as JaxSAM
from perceiver_io_tpu.models.audio import SymbolicAudioModelConfig as JaxSAMConfig
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.models.text import MaskedLanguageModel as JaxMLM
from perceiver_io_tpu.models.text import MaskedLanguageModelConfig as JaxMLMConfig
from perceiver_io_tpu.models.text import TextClassifier as JaxTextClassifier
from perceiver_io_tpu.models.text import TextClassifierConfig as JaxTextClassifierConfig
from perceiver_io_tpu.models.text import TextDecoderConfig as JaxTextDecoderConfig
from perceiver_io_tpu.models.text import TextEncoderConfig as JaxTextEncoderConfig
from perceiver_io_tpu.models.vision import ImageClassifier as JaxImageClassifier
from perceiver_io_tpu.models.vision import ImageClassifierConfig as JaxImageClassifierConfig
from perceiver_io_tpu.models.vision import ImageEncoderConfig as JaxImageEncoderConfig
from perceiver_io_tpu.models.vision import OpticalFlow as JaxOpticalFlow
from perceiver_io_tpu.models.vision import OpticalFlowConfig as JaxOpticalFlowConfig
from perceiver_io_tpu.models.vision import OpticalFlowDecoderConfig as JaxOpticalFlowDecoderConfig
from perceiver_io_tpu.models.vision import OpticalFlowEncoderConfig as JaxOpticalFlowEncoderConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.training.checkpoint import config_to_dict as jax_config_to_dict
from perceiver_io_tpu_torch import convert, training as tt
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.data.audio import midi
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer
from perceiver_io_tpu_torch.data.vision import OpticalFlowProcessor
from perceiver_io_tpu_torch.hf import SymbolicAudioGenerationPipeline, auto_model_for_config, from_pretrained
from perceiver_io_tpu_torch.hf import pipeline
from perceiver_io_tpu_torch.models.audio import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig, MaskedLanguageModel
from perceiver_io_tpu_torch.models.text import MaskedLanguageModelConfig, TextClassifier, TextClassifierConfig
from perceiver_io_tpu_torch.models.text import TextDecoderConfig, TextEncoderConfig
from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig
from perceiver_io_tpu_torch.models.vision import OpticalFlow, OpticalFlowConfig, OpticalFlowDecoderConfig
from perceiver_io_tpu_torch.models.vision import OpticalFlowEncoderConfig

SCORE_ATOL, FLOW_ATOL = 1e-5, 1e-4
CLM = dict(vocab_size=262, max_seq_len=64, max_latents=16, num_channels=32, num_heads=2,
           num_self_attention_layers=2)
SAM = dict(max_seq_len=64, max_latents=16, num_channels=32, num_heads=2, num_self_attention_layers=2)
TEXT_ENCODER = dict(vocab_size=262, max_seq_len=48, num_input_channels=32, num_cross_attention_heads=2,
                    num_self_attention_heads=2, num_self_attention_layers_per_block=2)
MLM_DECODER = dict(vocab_size=262, max_seq_len=48, num_cross_attention_heads=2, num_cross_attention_qk_channels=16,
                   num_cross_attention_v_channels=32, cross_attention_residual=False)
CLF_DECODER = dict(num_classes=3, num_output_query_channels=32, num_cross_attention_heads=1)
TOP = dict(num_latents=16, num_latent_channels=32)
IMAGE = (16, 16, 3)
IMAGE_ENCODER = dict(image_shape=IMAGE, num_frequency_bands=4, num_cross_attention_heads=1,
                     num_self_attention_heads=2, num_self_attention_layers_per_block=1)
FLOW = (12, 16)
FLOW_ENCODER = dict(image_shape=FLOW, num_patch_hidden_channels=13, num_frequency_bands=4, num_cross_attention_heads=1,
                    num_self_attention_heads=2, num_self_attention_layers_per_block=2)
FLOW_DECODER = dict(image_shape=FLOW, num_cross_attention_heads=1, num_cross_attention_qk_channels=36,
                    num_cross_attention_v_channels=36, cross_attention_residual=False)


class _Jitted:
    """The JAX model with a jitted ``apply`` (what the JAX pipelines read:
    ``apply`` and ``config``): the same function, compiled once a shape
    instead of run op by op."""

    def __init__(self, model):
        self.config = model.config
        self.apply = jax.jit(model.apply, static_argnames=("prefix_len", "decode", "deterministic", "method",
                                                           "mutable"))


def _recording(tokenizer_cls):
    """A tokenizer that keeps the token ids of every ``batch_decode``, so the
    streams are compared as ids, not only as the texts they decode to."""

    class Recording(tokenizer_cls):
        def __init__(self):
            super().__init__()
            self.decoded = []

        def batch_decode(self, batch, skip_special_tokens: bool = True):
            self.decoded.append([list(map(int, row)) for row in batch])
            return super().batch_decode(batch, skip_special_tokens)

    return Recording()


def _saved(tmp_path_factory, name, jax_model, example, port_config, to_port, **init_kwargs):
    """(JAX model, its params, the directory of the port's model with the
    converted weights saved by ``save_pretrained``)."""
    params = jax.tree.map(np.asarray, jax.jit(jax_model.init, static_argnames=tuple(init_kwargs))(
        jax.random.PRNGKey(0), jnp.asarray(example), **init_kwargs))
    model = auto_model_for_config(port_config, device="cpu")
    model.load_state_dict(to_port(params), strict=True)
    directory = str(tmp_path_factory.mktemp(name))
    tt.save_pretrained(directory, model, port_config)
    return _Jitted(jax_model), params, directory


@pytest.fixture(scope="module")
def clm(tmp_path_factory):
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 32))
    return _saved(tmp_path_factory, "clm", JaxCLM(JaxCLMConfig(**CLM)), ids, CausalLanguageModelConfig(**CLM),
                  convert.state_dict_from_jax, prefix_len=16)


@pytest.fixture(scope="module")
def sam(tmp_path_factory):
    ids = np.random.default_rng(0).integers(0, 388, size=(1, 32))
    return _saved(tmp_path_factory, "sam", JaxSAM(JaxSAMConfig(**SAM)), ids, SymbolicAudioModelConfig(**SAM),
                  convert.symbolic_audio_state_dict_from_jax, prefix_len=16)


def test_text_generation_greedy_matches_jax(clm):
    jm, params, directory = clm
    prompts = ["Hello, Perceiver", "a much longer prompt, left-padded by none"]
    kwargs = dict(max_new_tokens=6, num_latents=4, do_sample=False)
    jtok, ttok = _recording(JaxByteTokenizer), _recording(ByteTokenizer)
    with default_flash(True):
        want = jax_pipeline("text-generation", model=jm, params=params, tokenizer=jtok)(prompts, **kwargs)
    gen = pipeline("text-generation", model_dir=directory, device="cpu", tokenizer=ttok)
    assert gen(prompts, **kwargs) == want
    assert ttok.decoded == jtok.decoded and len(ttok.decoded[0][1]) == len(prompts[1]) + 6
    assert gen(prompts[0], **kwargs) == want[0]


def test_text_generation_beam_search_matches_jax(clm):
    jm, params, directory = clm
    kwargs = dict(max_new_tokens=5, num_latents=3, do_sample=False, num_beams=2)
    jtok, ttok = _recording(JaxByteTokenizer), _recording(ByteTokenizer)
    with default_flash(True):
        want = jax_pipeline("text-generation", model=jm, params=params, tokenizer=jtok)("Beams of light", **kwargs)
    got = pipeline("text-generation", model_dir=directory, device="cpu", tokenizer=ttok)("Beams of light", **kwargs)
    assert got == want and ttok.decoded == jtok.decoded
    with pytest.raises(ValueError, match="num_beams > 1 requires do_sample=False"):
        pipeline("text-generation", model_dir=directory, device="cpu")("x", num_beams=2, do_sample=True)


def test_generate_fn_cache_is_keyed_on_the_storage_dtypes(clm):
    _, _, directory = clm
    gen = pipeline("text-generation", model_dir=directory, device="cpu")
    kwargs = dict(max_new_tokens=4, num_latents=2, do_sample=False)
    f32 = gen("cache keys", **kwargs)
    gen.cache_dtype = torch.bfloat16
    gen("cache keys", **kwargs)
    gen.weight_dtype = torch.int8
    gen("cache keys", **kwargs)
    gen.cache_dtype, gen.weight_dtype = torch.float32, None
    assert gen("cache keys", **kwargs) == f32
    keys = {k[1:3] for k in gen._gen_cache}
    assert keys == {("torch.bfloat16", "torch.int8"), ("torch.bfloat16", None), ("torch.float32", None)}
    assert len(gen._gen_cache) == 3


def test_symbolic_audio_generation_matches_jax(sam, tmp_path):
    jm, params, directory = sam
    notes = [midi.Note(80, 60 + i % 12, 0.25 * i, 0.25 * i + 0.4) for i in range(12)]
    prompt = midi.encode_notes(notes)[:40]
    kwargs = dict(max_new_tokens=12, top_k=1, num_latents=2)
    with default_flash(True):
        want = jax_pipeline("symbolic-audio-generation", model=jm, params=params)(prompt, **kwargs)
    got = pipeline("symbolic-audio-generation", model_dir=directory, device="cpu")(prompt, **kwargs)
    np.testing.assert_array_equal(got.token_ids, np.asarray(want.token_ids))
    assert [(n.pitch, n.start, n.end) for n in got.notes] == [(n.pitch, n.start, n.end) for n in want.notes]
    with pytest.raises(ValueError, match="render_audio requires output_midi_path"):
        pipeline("symbolic-audio-generation", model_dir=directory, device="cpu")(prompt, render_audio=True)


def test_sampled_symbolic_audio_stream(sam):
    """Sampled at the pipeline's defaults (``top_k`` 15): one seed gives one
    stream; the ids after the PAD strip lie below ``PAD_ID`` and decode."""
    _, _, directory = sam
    gen = pipeline("symbolic-audio-generation", model_dir=directory, device="cpu")
    prompt = midi.encode_notes([midi.Note(64, 60 + i, 0.3 * i, 0.3 * i + 0.2) for i in range(8)])
    a, b = gen(prompt, max_new_tokens=16, seed=3), gen(prompt, max_new_tokens=16, seed=3)
    np.testing.assert_array_equal(a.token_ids, b.token_ids)
    assert len(a.token_ids) == len(prompt) + 16 - int(np.sum(a.token_ids == midi.PAD_ID))
    assert (a.token_ids < midi.PAD_ID).all() and a.notes == midi.decode_events(a.token_ids.tolist())
    assert isinstance(gen, SymbolicAudioGenerationPipeline) and len(gen._gen_cache) == 1


def test_fill_mask_matches_jax(tmp_path_factory):
    jcfg = JaxMLMConfig(encoder=JaxTextEncoderConfig(**TEXT_ENCODER), decoder=JaxTextDecoderConfig(**MLM_DECODER),
                        **TOP)
    tcfg = MaskedLanguageModelConfig(encoder=TextEncoderConfig(**TEXT_ENCODER),
                                     decoder=TextDecoderConfig(**MLM_DECODER), **TOP)
    ids = np.random.default_rng(0).integers(0, 262, size=(2, 48))
    jm, params, directory = _saved(tmp_path_factory, "mlm", JaxMLM(jcfg), ids, tcfg,
                                   lambda p: convert.mlm_state_dict_from_jax(p, decoder_residual=False))
    samples = ["I have watched this [MASK] and it was awesome.", "[MASK][MASK] is here"]
    with default_flash(True):
        want = jax_pipeline("fill-mask", model=jm, params=params)(samples, top_k=3)
    fill = pipeline("fill-mask", model_dir=directory, device="cpu")
    assert fill(samples, top_k=3) == want
    assert fill(samples[0], top_k=2) == want[0][:2]


def test_sentiment_analysis_matches_jax(tmp_path_factory):
    jcfg = JaxTextClassifierConfig(encoder=JaxTextEncoderConfig(**TEXT_ENCODER), decoder=JaxDecoderConfig(**CLF_DECODER),
                                   **TOP)
    tcfg = TextClassifierConfig(encoder=TextEncoderConfig(**TEXT_ENCODER),
                                decoder=ClassificationDecoderConfig(**CLF_DECODER), **TOP)
    ids = np.random.default_rng(0).integers(0, 262, size=(2, 48))
    jm, params, directory = _saved(tmp_path_factory, "clf", JaxTextClassifier(jcfg), ids, tcfg,
                                   convert.text_classifier_state_dict_from_jax)
    texts = ["a fine film", "dull, overlong and loud", "x" * 60]
    id2label = {0: "neg", 1: "neutral", 2: "pos"}
    with default_flash(True):
        want = jax_pipeline("sentiment-analysis", model=jm, params=params, id2label=id2label)(texts, top_k=3)
    got = pipeline("sentiment-analysis", model_dir=directory, device="cpu", id2label=id2label)(texts, top_k=3)
    _assert_labels(got, want)
    one = pipeline("text-classification", model_dir=directory, device="cpu")(texts[0])
    assert one["label"] == int([i for i, l in id2label.items() if l == want[0][0]["label"]][0])


def _assert_labels(got, want):
    assert [[e["label"] for e in row] for row in got] == [[e["label"] for e in row] for row in want]
    np.testing.assert_allclose([[e["score"] for e in row] for row in got],
                               [[e["score"] for e in row] for row in want], atol=SCORE_ATOL, rtol=0)


def test_image_classification_matches_jax(tmp_path_factory):
    dec = dict(CLF_DECODER, num_classes=5)
    jcfg = JaxImageClassifierConfig(encoder=JaxImageEncoderConfig(**IMAGE_ENCODER), decoder=JaxDecoderConfig(**dec),
                                    **TOP)
    tcfg = ImageClassifierConfig(encoder=ImageEncoderConfig(**IMAGE_ENCODER),
                                 decoder=ClassificationDecoderConfig(**dec), **TOP)
    x = np.random.default_rng(0).normal(size=(2,) + IMAGE).astype(np.float32)
    jm, params, directory = _saved(tmp_path_factory, "img", JaxImageClassifier(jcfg), x, tcfg,
                                   convert.image_classifier_state_dict_from_jax)
    images = np.random.default_rng(1).integers(0, 256, size=(3,) + IMAGE).astype(np.uint8)
    with default_flash(True):
        want = jax_pipeline("image-classification", model=jm, params=params)(images, top_k=2)
    got = pipeline("image-classification", model_dir=directory, device="cpu")(images, top_k=2)
    _assert_labels(got, want)


def test_optical_flow_matches_jax(tmp_path_factory):
    top = dict(num_latents=16, num_latent_channels=32)
    jcfg = JaxOpticalFlowConfig(encoder=JaxOpticalFlowEncoderConfig(**FLOW_ENCODER),
                                decoder=JaxOpticalFlowDecoderConfig(**FLOW_DECODER), **top)
    tcfg = OpticalFlowConfig(encoder=OpticalFlowEncoderConfig(**FLOW_ENCODER),
                             decoder=OpticalFlowDecoderConfig(**FLOW_DECODER), **top)
    x = np.random.default_rng(0).normal(size=(1, 2) + FLOW + (27,)).astype(np.float32)
    jm, params, directory = _saved(tmp_path_factory, "flow", JaxOpticalFlow(jcfg), x, tcfg,
                                   lambda p: convert.optical_flow_state_dict_from_jax(p, decoder_residual=False))
    rng = np.random.default_rng(2)
    pair = [rng.integers(0, 256, size=FLOW + (3,)).astype(np.uint8) for _ in range(2)]
    with default_flash(True):
        want = jax_pipeline("optical-flow", model=jm, params=params,
                            processor=JaxOpticalFlowProcessor(patch_size=FLOW, patch_min_overlap=4))(pair)
    got = pipeline("optical-flow", model_dir=directory, device="cpu",
                   processor=OpticalFlowProcessor(patch_size=FLOW, patch_min_overlap=4))(pair)
    assert got.shape == want.shape == FLOW + (2,)
    np.testing.assert_allclose(got, want, atol=FLOW_ATOL, rtol=0)


def test_pipeline_errors_match_jax(clm):
    _, _, directory = clm
    for fn in (jax_pipeline, pipeline):
        with pytest.raises(ValueError, match="Unknown task 'translation'; available: "):
            fn("translation", model_dir=directory)
        with pytest.raises(ValueError, match="Provide either model_dir"):
            fn("text-generation")
    empty = directory + "_noconfig"
    os.makedirs(empty, exist_ok=True)
    torch.save({}, os.path.join(empty, "model.pt"))
    with pytest.raises(ValueError, match="no config.json"):
        from_pretrained(empty, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_the_card_is_the_default_and_nothing_falls_back(clm):
    """``pipeline()``, ``from_pretrained`` and a pipeline over a CPU model
    run on ``cuda`` unless the caller names the CPU: without a card they
    raise."""
    _, _, directory = clm
    model = from_pretrained(directory, device="cpu")
    for call in (lambda: pipeline("text-generation", model_dir=directory), lambda: from_pretrained(directory),
                 lambda: pipeline("text-generation", model=model)):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()


def test_from_pretrained_reads_a_jax_config_class(sam, tmp_path):
    """``config.json`` written by the JAX package (its class path) builds the
    port's class of the same path, the SAM's before the CLM's."""
    _, params, directory = sam
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(jax_config_to_dict(JaxSAMConfig(**SAM)), f)
    assert json.load(open(os.path.join(tmp_path, "config.json")))["__config_class__"].startswith("perceiver_io_tpu.")
    os.link(os.path.join(directory, "model.pt"), os.path.join(tmp_path, "model.pt"))
    model = from_pretrained(str(tmp_path), device="cpu")
    assert type(model) is SymbolicAudioModel and model.config == SymbolicAudioModelConfig(**SAM)
    want = convert.symbolic_audio_state_dict_from_jax(params)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    assert type(auto_model_for_config(CausalLanguageModelConfig(**CLM), device="meta")) is CausalLanguageModel
    assert type(auto_model_for_config(TextClassifierConfig(
        encoder=TextEncoderConfig(**TEXT_ENCODER), decoder=ClassificationDecoderConfig(**CLF_DECODER), **TOP),
        device="meta")) is TextClassifier
    assert type(auto_model_for_config(MaskedLanguageModelConfig(
        encoder=TextEncoderConfig(**TEXT_ENCODER), decoder=TextDecoderConfig(**MLM_DECODER), **TOP),
        device="meta")) is MaskedLanguageModel
    bf16 = from_pretrained(directory, device="cpu", dtype=torch.bfloat16)
    assert type(bf16) is SymbolicAudioModel and bf16.input_adapter.txt_embedding.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="No model registered"):
        auto_model_for_config(object())
    assert type(from_pretrained(directory, device="cpu")) is SymbolicAudioModel
    assert not isinstance(from_pretrained(directory, device="cpu"), (ImageClassifier, OpticalFlow))
