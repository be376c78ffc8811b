"""The port's text data over HF ``datasets``, streaming and C4, and its
inference preprocessor, held to the JAX package's bit for bit.

The published corpora are not in the repository, so the HF modules read an
in-memory ``datasets.DatasetDict`` through a patched
``datasets.load_dataset`` (the same patch serves both packages): every
dataset module's batches for ``clm``, ``mlm`` (dynamic whole-word masking,
token masking and static masking) and ``clf`` equal JAX's, IMDb's split
choice per task included. The streaming pipeline (shuffle window,
per-process shard, EOS-joined chunks of fixed or random length, the
shifted collator) equals JAX's on the same text stream, and so does C4,
through its ``text_iter_fn`` seam and through a patched streaming
``load_dataset``. Without ``datasets`` an HF module raises its
``ImportError``: it never reads another source."""

import itertools
import os
import sys

import datasets
import numpy as np
import pytest

from perceiver_io_tpu.data.text import c4 as jc4
from perceiver_io_tpu.data.text import datamodule as jdatamodule
from perceiver_io_tpu.data.text import preprocessor as jpreprocessor
from perceiver_io_tpu.data.text import streaming as jstreaming
from perceiver_io_tpu_torch.data.text import c4, datamodule, preprocessor, streaming

WORDS = ("the quick brown fox jumps over a lazy dog while perceiver latents attend to bytes of every "
         "document in the corpus").split()
MODULES = ("ImdbDataModule", "WikiTextDataModule", "WikipediaDataModule", "BookCorpusDataModule",
           "BookCorpusOpenDataModule", "Enwik8DataModule")


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(20, 120)))) + "." for _ in range(n)]


def _corpus():
    """Every split any dataset module reads, with IMDb's labels."""
    splits = {}
    for i, name in enumerate(("train", "test", "validation", "unsupervised")):
        texts = _texts(24, seed=i)
        splits[name] = datasets.Dataset.from_dict({"text": texts, "label": [j % 2 for j in range(len(texts))]})
    return datasets.DatasetDict(splits)


@pytest.fixture
def hf(monkeypatch):
    calls = []

    def load_dataset(name, config=None, split=None, streaming=False):
        calls.append((name, config, split, streaming))
        ds = _corpus()
        if streaming:
            return ({"text": t} for t in ds[split]["text"])
        return ds

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    return calls


def _equal(a, b):
    if sorted(a) != sorted(b):
        return False
    return all((a[k] is None and b[k] is None) or (a[k] is not None and b[k] is not None and a[k].dtype == b[k].dtype
                                                   and np.array_equal(a[k], b[k])) for k in a)


def _all_batches(module):
    out = []
    for split in (module.train_batches(), module.valid_batches(), module.train_batches()):
        out.extend(split)
    return out


CASES = {
    "clm": dict(task="clm", max_seq_len=64),
    "clm_random_len": dict(task="clm", max_seq_len=64, random_min_seq_len=32),
    "mlm_words": dict(task="mlm", max_seq_len=48),
    "mlm_tokens": dict(task="mlm", max_seq_len=48, word_masking=False),
    "mlm_static": dict(task="mlm", max_seq_len=48, static_masking=True),
    "clf": dict(task="clf", max_seq_len=40),
}


# clf needs a label column: IMDb's alone
@pytest.mark.parametrize("name, case", [(name, case) for name in MODULES for case in sorted(CASES)
                                        if case != "clf" or name == "ImdbDataModule"])
def test_hf_modules_batches_equal_jax(name, case, hf):
    kwargs = dict(CASES[case], batch_size=4, seed=3, cache_dir=None)
    ours, theirs = getattr(datamodule, name)(**kwargs), getattr(jdatamodule, name)(**kwargs)
    got, want = _all_batches(ours), _all_batches(theirs)
    assert len(got) == len(want) > 0
    assert all(_equal(a, b) for a, b in zip(got, want))
    assert (ours.train_split, ours.valid_split) == (theirs.train_split, theirs.valid_split)
    assert hf and {c[0] for c in hf} == {ours.dataset_name}
    if name == "ImdbDataModule":
        assert ours.train_split == ("train" if kwargs["task"] == "clf" else "unsupervised")


def test_hf_module_cache_round_trip_equals_jax(hf, tmp_path):
    kwargs = dict(task="mlm", max_seq_len=48, batch_size=4, seed=1, static_masking=True)
    ours = datamodule.WikiTextDataModule(cache_dir=str(tmp_path / "port"), **kwargs)
    theirs = jdatamodule.WikiTextDataModule(cache_dir=str(tmp_path / "jax"), **kwargs)
    first = _all_batches(ours)
    assert all(_equal(a, b) for a, b in zip(first, _all_batches(theirs)))
    calls = len(hf)
    again = _all_batches(datamodule.WikiTextDataModule(cache_dir=str(tmp_path / "port"), **kwargs))
    assert len(hf) == calls  # read back from the cache, not loaded again
    assert all(_equal(a, b) for a, b in zip(first, again))


def test_hf_module_cache_appears_only_whole(hf, tmp_path, monkeypatch):
    # the processes of a multi-process run prepare the same cache at once:
    # nothing may stand under the cache's name until it is written whole
    real = np.savez
    writes = []

    def spy(file, *args, **kwargs):
        writes.append(os.path.basename(str(getattr(file, "name", file))))
        return real(file, *args, **kwargs)

    monkeypatch.setattr(np, "savez", spy)
    module = datamodule.WikiTextDataModule(cache_dir=str(tmp_path / "port"), task="clm", max_seq_len=48,
                                           batch_size=4, seed=1)
    assert _all_batches(module)
    name = f"preproc-{module._cache_key()}.npz"
    assert len(writes) == 1 and writes[0] != name  # written aside, then renamed
    assert [p.name for p in (tmp_path / "port").iterdir()] == [name]


def test_hf_module_without_datasets_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    for name in MODULES:
        module = getattr(datamodule, name)(task="clm", max_seq_len=32, batch_size=2, cache_dir=None)
        with pytest.raises(ImportError):
            module.prepare()
    with pytest.raises(ImportError):
        next(c4.C4DataModule(max_seq_len=32, min_seq_len=None, batch_size=2).batches())


def _stream_kwargs(**kw):
    return dict(dict(max_seq_len=48, batch_size=3, shuffle_window_size=7, shuffle_window_seed=5), **kw)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("min_seq_len", [None, 20])
def test_streaming_equals_jax(train, min_seq_len):
    texts = _texts(60, seed=9)
    kw = _stream_kwargs(min_seq_len=min_seq_len)
    ours = streaming.StreamingTextDataModule(lambda: iter(texts), **kw)
    theirs = jstreaming.StreamingTextDataModule(lambda: iter(texts), **kw)
    got, want = list(ours.batches(train=train)), list(theirs.batches(train=train))
    assert len(got) == len(want) > 3 and all(_equal(a, b) for a, b in zip(got, want))
    assert ours.vocab_size == theirs.vocab_size


def test_shuffle_window_and_shard_stream_equal_jax():
    items = list(range(103))
    for window, seed in ((1, 0), (7, 3), (200, 1)):
        got = list(streaming.shuffle_window(iter(items), window, seed=seed))
        assert got == list(jstreaming.shuffle_window(iter(items), window, seed=seed))
        assert sorted(got) == items
    for index, count in ((0, 1), (1, 3), (2, 3)):
        got = list(streaming.shard_stream(iter(items), process_index=index, process_count=count))
        assert got == list(jstreaming.shard_stream(iter(items), process_index=index, process_count=count))
    # one process without a torch.distributed group: the whole stream
    assert list(streaming.shard_stream(iter(items))) == items
    with pytest.raises(ValueError, match="min_seq_len"):
        streaming.StreamingTextDataModule(lambda: iter(()), max_seq_len=8, min_seq_len=8)


def test_c4_equals_jax(hf):
    kw = dict(max_seq_len=64, min_seq_len=32, batch_size=2, shuffle_window_size=5)
    ours, theirs = c4.C4DataModule(**kw), jc4.C4DataModule(**kw)
    got, want = list(ours.batches()), list(theirs.batches())
    assert len(got) == len(want) > 3 and all(_equal(a, b) for a, b in zip(got, want))
    assert hf[0] == ("allenai/c4", "en", "train", True)
    texts = _texts(30, seed=4)
    ours.text_iter_fn = theirs.text_iter_fn = lambda: iter(texts)
    got = list(itertools.islice(ours.batches(train=False), 4))
    want = list(itertools.islice(theirs.batches(train=False), 4))
    assert len(got) == 4 and all(_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("side, max_len", [("right", None), ("left", 16), ("right", 8)])
def test_text_preprocessor_equals_jax(side, max_len):
    texts = ["a fine film", "", "loud and overlong " * 3, "héllo wörld"]
    for special in (False, True):
        ours = preprocessor.TextPreprocessor(max_seq_len=max_len, padding_side=side, add_special_tokens=special)
        theirs = jpreprocessor.TextPreprocessor(max_seq_len=max_len, padding_side=side, add_special_tokens=special)
        for got, want in ((ours.preprocess_batch(texts), theirs.preprocess_batch(texts)),
                          (ours.preprocess(texts[2]), theirs.preprocess(texts[2]))):
            assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))
