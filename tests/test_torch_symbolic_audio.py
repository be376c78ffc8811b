"""The port's symbolic audio model, MIDI codec and audio data modules against
the JAX package's.

The model at a micro width (the MIDI vocabulary of 389, 64 tokens, 16
latents, 32 channels in 2 heads, 2 self-attention layers), from the same
parameters: logits with and without left padding, the ``clm_loss_fn`` loss
and gradient tree under a fixed prefix keep set; the parameter count at the
GiantMIDI-Piano geometry (6144 tokens, 2048 latents, 768 channels, 12
layers) on the meta device. The codec (``encode_notes``, ``decode_events``,
the sustain pedal) on seeded notes, the numpy dataset's windows and the
collator's batches for one seed, the synthetic module's token files and
batches, the archive modules' splits and errors, and ``prepare_once``.

Tolerances (f32), at the levels of ``tests/test_torch_clm.py`` and
``tests/test_torch_train.py``: logits atol 1e-4; the loss within 4e-6;
gradients per parameter, max abs difference over the JAX gradient's max abs
value <= 4e-6. The codec and the data modules are exact."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.audio import midi as jmidi
from perceiver_io_tpu.data.audio import symbolic as jsym
from perceiver_io_tpu.models.audio import SymbolicAudioModel as JaxSAM
from perceiver_io_tpu.models.audio import SymbolicAudioModelConfig as JaxSAMConfig
from perceiver_io_tpu.parallel import dist as jdist
from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import jax_param_paths, state_dict_from_jax, symbolic_audio_state_dict_from_jax
from perceiver_io_tpu_torch.data.audio import midi as tmidi
from perceiver_io_tpu_torch.data.audio import symbolic as tsym
from perceiver_io_tpu_torch.models.audio import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_tpu_torch.parallel import dist as tdist

MICRO = dict(max_seq_len=64, max_latents=16, num_channels=32, num_heads=2, num_self_attention_layers=2)
LATENTS, SEQ, PREFIX = 16, 48, 32
LOGIT_ATOL, LOSS_ATOL, GRAD_RTOL = 1e-4, 4e-6, 4e-6
GIANTMIDI = dict(max_seq_len=6144, max_latents=2048, num_channels=768, num_self_attention_layers=12)
GIANTMIDI_PARAMS = 97_072_517


@pytest.fixture(scope="module")
def models():
    jm = JaxSAM(JaxSAMConfig(**MICRO))
    ids = np.random.default_rng(0).integers(0, 388, size=(1, SEQ))
    params = jax.tree.map(np.asarray, jax.jit(jm.init, static_argnames="prefix_len")(
        jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=PREFIX))
    tm = SymbolicAudioModel(SymbolicAudioModelConfig(**MICRO), device="cpu")
    tm.load_state_dict(symbolic_audio_state_dict_from_jax(params), strict=True)
    return jm, params, tm


def test_config_defaults_and_weight_bridge(models):
    """The config's MIDI defaults are JAX's; the SAM's converter is the causal
    sequence model's, and ``jax_param_paths`` names a leaf of the JAX tree
    for every port parameter."""
    _, params, tm = models
    assert (SymbolicAudioModelConfig().vocab_size, SymbolicAudioModelConfig().max_seq_len,
            SymbolicAudioModelConfig().max_latents) == (389, 6144, 2048)
    assert {k: getattr(SymbolicAudioModelConfig(), k) for k in vars(JaxSAMConfig())} == vars(JaxSAMConfig())
    a, b = symbolic_audio_state_dict_from_jax(params), state_dict_from_jax(params)
    assert sorted(a) == sorted(b) == sorted(tm.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    flat = {"/".join(["params", *(str(getattr(k, "key", k)) for k in path)])
            for path, _ in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    paths = jax_param_paths(tm)
    assert sorted(paths) == sorted(n for n, _ in tm.named_parameters())
    assert set(paths.values()) == flat


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
def test_logits_match_jax(models, padded):
    jm, params, tm = models
    ids = np.random.default_rng(1).integers(0, 388, size=(2, SEQ))
    pad = None
    if padded:
        pad = np.zeros((2, SEQ), bool)
        pad[1, :11] = True
    want = jax.jit(jm.apply, static_argnames="prefix_len")(
        params, jnp.asarray(ids), prefix_len=PREFIX, pad_mask=None if pad is None else jnp.asarray(pad)).logits
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), prefix_len=PREFIX, pad_mask=None if pad is None else torch.from_numpy(pad))
    assert got.logits.shape == (2, LATENTS, 389)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


def test_clm_loss_and_gradient_tree_match_jax(models):
    jm, params, tm = models
    rng = np.random.default_rng(2)
    t = rng.integers(0, 388, size=(2, SEQ + 1))
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": jpd.sample_prefix_keep_idx(rng, 2, PREFIX, 0.5)}
    jbatch = {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jax_clm_loss_fn(jm.apply, max_latents=LATENTS), has_aux=True))(
        params, jbatch, jax.random.PRNGKey(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    tm.zero_grad(set_to_none=True)
    loss, _ = tt.clm_loss_fn(LATENTS)(tm, batch, None)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, (name, err)
    tm.zero_grad(set_to_none=True)


def test_parameter_count_at_the_giantmidi_geometry():
    model = SymbolicAudioModel(SymbolicAudioModelConfig(**GIANTMIDI), device="meta")
    assert sum(p.numel() for p in model.parameters()) == GIANTMIDI_PARAMS
    assert all(p.is_meta for p in model.parameters())


# ------------------------------------------------------------------ the codec


def _notes(mod, n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        start = float(np.round(rng.uniform(0, 20), 3))
        out.append(mod.Note(int(rng.integers(1, 128)), int(rng.integers(30, 90)), start,
                            start + float(np.round(rng.uniform(0.02, 3.5), 3))))
    return out


def _sustains(mod, rng):
    times = np.sort(rng.uniform(0, 22, size=12))
    values = rng.choice([0, 30, 70, 127], size=12)
    return mod.sustains_from_control_changes(list(zip(times.tolist(), values.tolist())))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_and_decode_match_jax(seed):
    assert (tmidi.VOCAB_SIZE, tmidi.PAD_ID, tmidi.START_IDX) == (jmidi.VOCAB_SIZE, jmidi.PAD_ID, jmidi.START_IDX)
    rng_t, rng_j = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    st, sj = _sustains(tmidi, rng_t), _sustains(jmidi, rng_j)
    assert [(s.start, s.end) for s in st] == [(s.start, s.end) for s in sj]
    for sustains in ((None, None), (st, sj)):
        got = tmidi.encode_notes(_notes(tmidi, seed=seed), sustains[0])
        want = jmidi.encode_notes(_notes(jmidi, seed=seed), sustains[1])
        assert got == want
        assert all(0 <= i < tmidi.PAD_ID for i in got)
        decoded = [(n.velocity, n.pitch, n.start, n.end) for n in tmidi.decode_events(got + [tmidi.PAD_ID, -1])]
        assert decoded == [(n.velocity, n.pitch, n.start, n.end) for n in jmidi.decode_events(want)]
        assert decoded


def test_midi_file_io_needs_pretty_midi_in_both(tmp_path):
    for mod in (tmidi, jmidi):
        with pytest.raises(ImportError, match="pretty_midi"):
            mod.encode_midi_file(tmp_path / "a.mid")
        with pytest.raises(ImportError, match="pretty_midi"):
            mod.decode_to_midi_file([1, 2, 3])


# -------------------------------------------------------- the data modules


def test_dataset_windows_and_collator_match_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 388, size=600).astype(np.int16)
    data[rng.choice(600, size=9, replace=False)] = tsym.EXAMPLE_SEPARATOR
    for min_len, side in ((None, "left"), (10, "right")):
        td = tsym.SymbolicAudioNumpyDataset(data, max_seq_len=33, min_seq_len=min_len, seed=5)
        jd = jsym.SymbolicAudioNumpyDataset(data, max_seq_len=33, min_seq_len=min_len, seed=5)
        assert len(td) == len(jd)
        examples = [td[i] for i in range(6)]
        jexamples = [jd[i] for i in range(6)]
        for a, b in zip(examples, jexamples):
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        got = tsym.SymbolicAudioCollator(33, padding_side=side)(examples)
        want = jsym.SymbolicAudioCollator(33, padding_side=side)(jexamples)
        assert sorted(got) == sorted(want) == ["input_ids", "labels", "pad_mask"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="padding side"):
        tsym.SymbolicAudioCollator(8, padding_side="middle")


def test_synthetic_module_matches_jax(tmp_path):
    kwargs = dict(max_seq_len=96, batch_size=3, seed=4, num_train_pieces=6, num_valid_pieces=2)
    t = tsym.SyntheticSymbolicAudioDataModule(str(tmp_path / "port"), **kwargs)
    j = jsym.SyntheticSymbolicAudioDataModule(str(tmp_path / "jax"), **kwargs)
    t.prepare_data()
    j.prepare_data()
    t.prepare_data()  # prepared once: the second call finds the cache
    assert t.vocab_size == j.vocab_size == 389
    for name in ("train.bin", "valid.bin"):
        assert (t.preproc_dir / name).read_bytes() == (j.preproc_dir / name).read_bytes()
    for tb, jb in ((t.train_batches(), j.train_batches()), (t.valid_batches(), j.valid_batches())):
        for got, want in zip(list(tb)[:2], list(jb)[:2]):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="min_seq_len"):
        tsym.SyntheticSymbolicAudioDataModule(str(tmp_path), max_seq_len=8, min_seq_len=8)


def test_archive_modules_split_as_jax_and_read_local_archives_only(tmp_path):
    with pytest.raises(FileNotFoundError, match="midis_v1.2.zip"):
        tsym.GiantMidiPianoDataModule(str(tmp_path / "none"), max_seq_len=8).load_source_dataset()
    root = tmp_path / "maestro"
    extracted = root / "maestro-v3.0.0" / "2018"
    extracted.mkdir(parents=True)
    names = [f"piece{i}.midi" for i in range(7)]
    for n in names:
        (extracted / n).write_bytes(b"")
    meta = {"split": {str(i): s for i, s in enumerate(["train", "validation", "test", "train", "validation",
                                                         "train", "train"])},
            "midi_filename": {str(i): f"2018/{n}" for i, n in enumerate(names)}}
    (root / "maestro-v3.0.0" / "maestro-v3.0.0.json").write_text(json.dumps(meta))
    for cls_t, cls_j in ((tsym.MaestroV3DataModule, jsym.MaestroV3DataModule),
                         (tsym.GiantMidiPianoDataModule, jsym.GiantMidiPianoDataModule)):
        if cls_t is tsym.GiantMidiPianoDataModule:
            (root / "midis").mkdir()
            for n in names:
                (root / "midis" / n.replace(".midi", ".mid")).write_bytes(b"")
        got = cls_t(str(root), max_seq_len=8, seed=3)._split_files()
        want = cls_j(str(root), max_seq_len=8, seed=3)._split_files()
        assert got == want and got["train"] and got["valid"]
    dirs = tsym.MaestroV3DataModule(str(root), max_seq_len=8).load_source_dataset()
    assert sorted(p.name.split("-", 1)[1] for p in dirs["valid"].iterdir()) == ["piece1.midi", "piece4.midi"]


def test_prepare_once_builds_once_like_jax(tmp_path):
    calls = []

    def build(path):
        calls.append(path)
        path.write_text("x")

    for mod, name in ((tdist, "port"), (jdist, "jax")):
        mod.prepare_once(tmp_path / name / "cache.txt", build)
        mod.prepare_once(tmp_path / name / "cache.txt", build)
        assert (tmp_path / name / "cache.txt").read_text() == "x"
        assert os.listdir(tmp_path / name) == ["cache.txt"]
    assert len(calls) == 2
    assert tdist.STALE_TMP_AGE_SECONDS == jdist.STALE_TMP_AGE_SECONDS
