"""The port's host data path and telemetry against the JAX package's, on the
CPU: ``Batches`` (shuffle, ``drop_last``, epochs, process shards),
``ByteTokenizer``, the collators, ``TextDataModule`` (its on-disk cache),
``SyntheticTextDataModule`` and ``TextFileDataModule`` give arrays equal to
JAX's for the same seeds; ``PrefetchIterator``; the analytic FLOPs model
(``train_step_flops``, ``clm_train_telemetry``, the parameter count) equal
to JAX's at the flagship and micro configs; the card's peak; the event log,
spans, goodput and recapture tracking. Every comparison is exact (numpy on
the host; the FLOPs model is Python arithmetic)."""

import itertools
import json

import numpy as np
import pytest

from perceiver_io_tpu.data import loader as jloader
from perceiver_io_tpu.data.text import collators as jcollators
from perceiver_io_tpu.data.text import datamodule as jdatamodule
from perceiver_io_tpu.data.text.tokenizer import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs import events as jevents
from perceiver_io_tpu.obs import mfu as jmfu
from perceiver_io_tpu.utils import flops as jflops
from perceiver_io_tpu_torch.data import loader
from perceiver_io_tpu_torch.data.text import collators, datamodule
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer, encode_to_np
from perceiver_io_tpu_torch.models.text import CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs import events, mfu, recompile, trace
from perceiver_io_tpu_torch.utils import flops

CORPUS = [
    "The quick brown fox jumps over the lazy dog. " * 20,
    "Perceiver IO is a general-purpose architecture. " * 20,
    "TPUs multiply matrices very quickly indeed. " * 20,
]


def _equal(a, b):
    """Two batches (dicts of arrays or None), or lists of them, equal."""
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if sorted(a) != sorted(b):
        return False
    return all((a[k] is None and b[k] is None) or (a[k] is not None and b[k] is not None
                                                   and a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))
               for k in a)


class _Dataset:
    def __init__(self, n):
        self.data = [{"x": np.asarray([i]), "y": np.float32(i) / 2} for i in range(n)]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


@pytest.mark.parametrize("shuffle,drop_last,n,b", [(False, True, 10, 3), (True, True, 10, 3), (True, False, 11, 4),
                                                   (False, False, 7, 7)])
def test_batches_equal_jaxs_over_epochs(shuffle, drop_last, n, b):
    port = loader.Batches(_Dataset(n), batch_size=b, shuffle=shuffle, drop_last=drop_last, seed=5)
    ref = jloader.Batches(_Dataset(n), batch_size=b, shuffle=shuffle, drop_last=drop_last, seed=5)
    assert len(port) == len(ref)
    epochs = [list(port) for _ in range(3)]
    assert all(_equal(e, list(ref)) for e in epochs)
    if shuffle:
        assert not _equal(epochs[0], epochs[1])  # a new order each epoch


def test_process_shards_equal_jaxs():
    for pi, pc in ((0, 1), (1, 4), (3, 4)):
        assert np.array_equal(loader.shard_indices_for_process(10, pi, pc),
                              jloader.shard_indices_for_process(10, pi, pc))
    assert np.array_equal(loader.shard_indices_for_process(10), np.arange(10))  # rank 0 of 1


def test_byte_tokenizer_equals_jaxs():
    port, ref = ByteTokenizer(), JaxByteTokenizer()
    assert port.vocab_size == ref.vocab_size == 262
    for text in ["Hello, TPU! ünïcödé", "", "a\nb\tc", "x y  z"]:
        ids = port.encode(text, add_special_tokens=True)
        assert ids == ref.encode(text, add_special_tokens=True)
        assert port.decode(ids) == ref.decode(ids) and port.decode(ids, False) == ref.decode(ids, False)
        assert port.word_ids(ids) == ref.word_ids(ids)
        assert np.array_equal(encode_to_np(port, text), port.encode_np(text))
    for side in ("left", "right"):
        got = port.pad_sequences([[10, 11, 12], [20]], padding_side=side, max_length=2)
        want = ref.pad_sequences([[10, 11, 12], [20]], padding_side=side, max_length=2)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _examples(tok):
    ids = [tok.encode(t) for t in ("the quick brown fox jumps " * 6, "over the lazy dog " * 3)]
    return [{"input_ids": i, "word_ids": tok.word_ids(i), "labels": i[::-1], "label": k} for k, i in enumerate(ids)]


@pytest.mark.parametrize("name", ["DefaultCollator", "WordMaskingCollator", "TokenMaskingCollator",
                                  "RandomTruncateCollator"])
def test_collators_equal_jaxs(name):
    tok = ByteTokenizer()
    examples = _examples(tok)
    if name == "DefaultCollator":
        port, ref = collators.DefaultCollator(tok, max_seq_len=40), jcollators.DefaultCollator(tok, max_seq_len=40)
    elif name == "RandomTruncateCollator":
        port = collators.RandomTruncateCollator(collators.DefaultCollator(tok), 20, seed=3)
        ref = jcollators.RandomTruncateCollator(jcollators.DefaultCollator(tok), 20, seed=3)
    else:
        port = getattr(collators, name)(tok, mask_prob=0.3, seed=2)
        ref = getattr(jcollators, name)(tok, mask_prob=0.3, seed=2)
    for _ in range(3):  # the collators' generators advance alike
        assert _equal(port(examples), ref(examples))


@pytest.mark.parametrize("task", ["clm", "mlm", "clf"])
def test_text_datamodule_equals_jaxs(task, tmp_path):
    texts = [(t, i % 2) for i, t in enumerate(CORPUS)] if task == "clf" else CORPUS
    kw = dict(task=task, max_seq_len=48, batch_size=2, train_texts=texts, valid_texts=texts[:2], seed=4,
              random_min_seq_len=24 if task == "clm" else None)
    port = datamodule.TextDataModule(cache_dir=str(tmp_path / "port"), **kw)
    ref = jdatamodule.TextDataModule(cache_dir=str(tmp_path / "jax"), **kw)
    for split in ("train_batches", "valid_batches"):
        assert _equal(list(getattr(port, split)()), list(getattr(ref, split)()))
    assert port._cache_key() == ref._cache_key()
    cached = datamodule.TextDataModule(cache_dir=str(tmp_path / "port"), **kw)  # read back from its cache
    cached.prepare()
    assert sorted(cached._prepared) == sorted(port._prepared)
    assert _equal(list(cached.valid_batches()), list(port.valid_batches()))


def test_synthetic_and_text_file_datamodules_equal_jaxs(tmp_path):
    kw = dict(task="clm", max_seq_len=64, batch_size=2, num_train_docs=6, num_valid_docs=2, sentences_per_doc=4)
    port, ref = datamodule.SyntheticTextDataModule(**kw), jdatamodule.SyntheticTextDataModule(**kw)
    assert port.source_fingerprint() == ref.source_fingerprint()
    assert _equal(list(port.train_batches()), list(ref.train_batches()))
    assert _equal(list(port.valid_batches()), list(ref.valid_batches()))
    path = tmp_path / "corpus.txt"
    path.write_text("\n\n".join(CORPUS), encoding="utf-8")
    kw = dict(train_file=str(path), task="clm", max_seq_len=32, batch_size=2)
    port, ref = datamodule.TextFileDataModule(**kw), jdatamodule.TextFileDataModule(**kw)
    assert _equal(list(port.train_batches()), list(ref.train_batches()))
    assert _equal(list(port.valid_batches()), list(ref.valid_batches()))
    with pytest.raises(ValueError, match="clf"):
        datamodule.TextFileDataModule(train_file=str(path), task="clf").prepare()


def test_prefetch_iterator_order_exceptions_and_residuals():
    assert list(loader.PrefetchIterator(iter(range(7)), depth=3)) == list(range(7))

    def gen():
        yield 1
        raise RuntimeError("producer boom")

    it = loader.PrefetchIterator(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer boom"):
        next(it)
    assert next(it, "done") == "done"
    src = itertools.count()
    it = loader.PrefetchIterator(src, depth=2)
    assert next(it) == 0
    it.close()
    assert not it.alive()
    # the pulled-but-unconsumed items come back in order, and the source resumes after them
    assert it.residual == list(range(1, 1 + len(it.residual))) and len(it.residual) >= 2
    assert next(src) == 1 + len(it.residual)


FLAGSHIP = dict(vocab_size=262, max_seq_len=16384, max_latents=1024, num_channels=512, num_heads=8,
                num_self_attention_layers=8, cross_attention_dropout=0.5)
MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2)


@pytest.mark.parametrize("config", [FLAGSHIP, MICRO], ids=["flagship", "micro"])
def test_flops_model_equals_jaxs(config):
    port, ref = CausalLanguageModelConfig(**config), JaxCLMConfig(**config)
    for b, keep in ((1, 0.5), (4, 0.5), (3, 1.0)):
        assert flops.train_step_flops(port, b, keep) == jflops.train_step_flops(ref, b, keep)
    assert mfu.clm_train_telemetry(port) == jmfu.clm_train_telemetry(ref)
    assert mfu.clm_train_telemetry(object()) is None
    est = flops.ComputeEstimator(config["vocab_size"], config["max_seq_len"], config["max_latents"])
    ref_est = jflops.ComputeEstimator(config["vocab_size"], config["max_seq_len"], config["max_latents"])
    c, layers = config["num_channels"], config["num_self_attention_layers"] + 1
    assert est.self_attn(c, layers) == ref_est.self_attn(c, layers)
    assert est.cross_attn(c, 0.5) == ref_est.cross_attn(c, 0.5)
    assert flops.training_flops(flops.ModelInfo(c, layers, est), 10, 4) == jflops.training_flops(
        jflops.ModelInfo(c, layers, ref_est), 10, 4)


def test_parameter_count_equals_jaxs():
    args = (64, 3, 128, 384, 262)  # channels, layers, latents, prefix, vocab
    assert flops.num_model_params(*args) == jflops.num_model_params(*args)
    assert flops.num_self_attn_params(*args) == jflops.num_self_attn_params(*args)


def test_peak_flops_is_the_cards_own():
    assert mfu.PEAK_FLOPS == (("h100", 989.4e12),)
    assert mfu.device_peak_flops("cpu") is None


def test_goodput_tracker_buckets_overheads():
    now = [0.0]
    g = mfu.GoodputTracker(clock=lambda: now[0])
    with g.measure("compile"):
        now[0] += 2.0
    g.add("checkpoint", 1.0)
    g.add("eval", -5.0)  # negative durations clamp to 0
    now[0] = 10.0
    assert g.overhead() == 3.0
    assert g.summary() == {"total_s": 10.0, "productive_s": 7.0, "goodput": 0.7, "checkpoint_s": 1.0,
                           "compile_s": 2.0, "eval_s": 0.0}


def test_event_log_spans_and_merge(tmp_path):
    log = events.EventLog(str(tmp_path))
    tracer = trace.Tracer(log)
    with tracer.span("fit", ambient=True) as fit:
        log.emit("fit_start", start_step=0, loss=float("nan"))
        step = tracer.start("step")
        log.emit("fault.skip", step=1)
        tracer.end(step)
    tracer.flush()
    rows = events.merged_events(str(tmp_path))
    kinds = [r["event"] for r in rows]
    assert kinds == ["fit_start", "fault.skip", "span", "span"]
    assert rows[0]["span_id"] == fit.span_id and rows[0]["loss"] is None
    spans = {r["name"]: r for r in rows if r["event"] == "span"}
    assert rows[1]["span_id"] == spans["step"]["span_id"] and spans["step"]["parent_id"] == fit.span_id
    assert trace.current_span_id() is None
    # shards of a multi-process run merge into one stream, each in its own order
    for p in (0, 1):
        shard = events.EventLog(str(tmp_path / "multi"), process_index=p, process_count=2)
        shard.emit("log", step=p)
    assert [r["step"] for r in events.merged_events(str(tmp_path / "multi"))] == [0, 1]
    assert events.event_shards(str(tmp_path / "multi"))[0].endswith("events-p0.jsonl")
    assert [r["event"] for r in events.read_event_file(str(tmp_path / "events.jsonl"))] == kinds
    cfg = {"a": 1, "b": [1, 2]}
    assert events.config_hash(cfg, None) == jevents.config_hash(cfg, None)
    manifest = events.write_run_manifest(str(tmp_path), model_config=cfg)
    assert json.load(open(tmp_path / "run_manifest.json"))["config_hash"] == manifest["config_hash"]
    assert manifest["device_kind"] == "cpu" and manifest["process_count"] == 1


def test_recompile_tracker_books_each_capture():
    class Captured:  # stands for graphs.CapturedStep: its count and seconds
        def __init__(self):
            self.captures, self.capture_s = 0, []

    captured = Captured()

    def step(x):
        if x == "new shape":
            captured.captures += 1
            captured.capture_s.append(0.5)
        return x

    step.captured = captured
    rows = []

    class Sink:
        def emit(self, kind, **fields):
            rows.append((kind, fields))

    goodput = mfu.GoodputTracker()
    tracker = recompile.RecompileTracker(events=Sink(), goodput=goodput)
    tracked = tracker.wrap(step, "train_step")
    assert tracked.captured is captured
    for x in ("new shape", "same", "same", "new shape"):
        tracked(x)
    assert tracker.counts() == {"train_step": 2} and tracker.total_compile_s == 1.0
    assert [f["n_compiles"] for _, f in rows] == [1, 2] and goodput.summary()["compile_s"] == 1.0
    eager = tracker.wrap(lambda x: x, "eval_step")  # no capture (the CPU): nothing booked
    eager(1)
    assert tracker.counts() == {"train_step": 2, "eval_step": 0}
    sig = recompile.shape_signature(({"a": np.zeros((2, 3), np.int32), "b": None},))
    assert sig == {"leaves": 1, "shapes": {"int32[2, 3]": 1}}
