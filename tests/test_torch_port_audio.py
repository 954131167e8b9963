"""The port's MIDI event codec and symbolic-audio data modules against the
JAX package's, on the CPU.

Bars: exact equality. The codec on seeded random ``Note`` lists (sustain
pedals, same-pitch re-strikes, gaps past one second) gives the same events
and the same decoded notes; the datasets, the collator and the data modules
draw the same windows from the same numpy seeds, so every batch is equal,
array for array; the Maestro and GiantMIDI split logic gives the same
files; ``prepare_data``/``setup`` write and read the same memmaps (the
encoder stubbed in both packages: ``pretty_midi`` is not installed), and
the ``pretty_midi`` bridges raise ``ImportError`` without it.
"""
import importlib
import json

import numpy as np
import pytest

jax_midi = importlib.import_module("perceiver_io_tpu.data.audio.midi")
jax_sym = importlib.import_module("perceiver_io_tpu.data.audio.symbolic")
midi = importlib.import_module("perceiver_io_tpu_torch.data.audio.midi")
sym = importlib.import_module("perceiver_io_tpu_torch.data.audio.symbolic")

SEQ = 64


def _random_piece(seed: int, n: int = 60):
    """Notes with re-struck pitches, long gaps and sustain-pedal windows."""
    rng = np.random.default_rng(seed)
    notes, controls, t = [], [], 0.0
    for _ in range(n):
        t += float(rng.choice([0.0, rng.uniform(0.01, 0.4), rng.uniform(1.0, 3.5)], p=[0.2, 0.7, 0.1]))
        length = float(rng.uniform(0.02, 2.5))
        notes.append((int(rng.integers(21, 60)), int(rng.integers(1, 128)), round(t, 3), round(t + length, 3)))
    for _ in range(4):
        down = round(float(rng.uniform(0, t)), 3)
        controls.append((64, int(rng.integers(64, 128)), down))
        controls.append((64, int(rng.integers(0, 64)), round(down + float(rng.uniform(0.1, 2.0)), 3)))
    controls.append((7, 100, 0.5))  # not a sustain pedal: ignored
    return notes, controls


def _objs(mod, notes, controls):
    return [mod.Note(*n) for n in notes], [mod.ControlChange(*c) for c in controls]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_matches_jax(seed):
    notes, controls = _random_piece(seed)
    want = jax_midi.events_from_notes(*_objs(jax_midi, notes, controls))
    got = midi.events_from_notes(*_objs(midi, notes, controls))
    assert got == want and len(got) > 100
    shifts = [e for e in got if midi.TIME_SHIFT_OFFSET <= e < midi.VELOCITY_OFFSET]
    assert midi.TIME_SHIFT_OFFSET + 99 in shifts  # a gap past one second
    # the round trip, pads and separators included in the stream
    stream = got + [midi.PAD_TOKEN, midi.SEPARATOR] + got[:50]
    want_notes = [(n.pitch, n.velocity, n.start, n.end) for n in jax_midi.notes_from_events(stream)]
    got_notes = [(n.pitch, n.velocity, n.start, n.end) for n in midi.notes_from_events(stream)]
    assert got_notes == want_notes and got_notes
    for name in ("NUM_EVENTS", "PAD_TOKEN", "VOCAB_SIZE", "SEPARATOR", "NOTE_OFF_OFFSET",
                 "TIME_SHIFT_OFFSET", "VELOCITY_OFFSET", "TIME_STEP"):
        assert getattr(midi, name) == getattr(jax_midi, name)


def test_pretty_midi_bridges_raise_without_it(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pretty_midi(name, *args, **kwargs):
        if name == "pretty_midi":
            raise ImportError("No module named 'pretty_midi'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pretty_midi)
    for mod in (midi, jax_midi):
        with pytest.raises(ImportError, match="pretty_midi"):
            mod.encode_midi_file(tmp_path / "a.mid")
        with pytest.raises(ImportError, match="pretty_midi"):
            mod.decode_to_midi_file([60, 128 + 60])


def _streams(seed: int):
    rng = np.random.default_rng(seed)
    pieces = [rng.integers(0, 388, int(rng.integers(20, 200))).astype(np.int16) for _ in range(8)]
    return pieces, rng.integers(0, 388, 300).astype(np.int16)


def _assert_batches_equal(got, want, n=None):
    got, want = list(got)[:n], list(want)[:n]
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("min_seq_len", [None, 40])
def test_dataset_and_collator_match_jax(min_seq_len):
    pieces, _ = _streams(0)
    flat = sym.SymbolicAudioDataModule.flatten_pieces(pieces, shuffle_seed=5)
    np.testing.assert_array_equal(flat, jax_sym.SymbolicAudioDataModule.flatten_pieces(pieces, shuffle_seed=5))
    ours = sym.SymbolicAudioDataset(flat, SEQ, min_seq_len=min_seq_len, seed=3)
    theirs = jax_sym.SymbolicAudioDataset(flat, SEQ, min_seq_len=min_seq_len, seed=3)
    assert len(ours) == len(theirs)
    examples = [ours[i] for i in range(12)]
    for i, ex in enumerate(examples):
        np.testing.assert_array_equal(ex["input_ids"], theirs[i]["input_ids"])
        assert (ex["input_ids"] != midi.SEPARATOR).all()
    for side in ("left", "right"):
        got = sym.SymbolicAudioCollator(SEQ, side)(examples)
        want = jax_sym.SymbolicAudioCollator(SEQ, side)(examples)
        _assert_batches_equal([got], [want])
    with pytest.raises(ValueError, match="too short"):
        sym.SymbolicAudioDataset(flat[:SEQ], SEQ)


def test_datamodule_from_token_streams_matches_jax():
    pieces, valid = _streams(1)
    train = sym.SymbolicAudioDataModule.flatten_pieces(pieces)
    kw = dict(max_seq_len=SEQ, batch_size=4, min_seq_len=30, seed=7, shard_index=0, shard_count=1)
    ours = sym.SymbolicAudioDataModule.from_token_streams(train, valid, test=valid[::-1], **kw)
    theirs = jax_sym.SymbolicAudioDataModule.from_token_streams(train, valid, test=valid[::-1], **kw)
    for dm in (ours, theirs):
        dm.prepare_data()
        dm.setup()
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        _assert_batches_equal(getattr(ours, loader)(), getattr(theirs, loader)())
    batch = next(iter(ours.train_dataloader()))
    assert batch["input_ids"].shape == (4, SEQ) and batch["pad_mask"].dtype == bool
    assert (batch["labels"] != midi.PAD_TOKEN).all() and (batch["labels"] == sym.IGNORE_INDEX).any()


def test_synthetic_datamodule_matches_jax():
    kw = dict(num_train_pieces=4, num_valid_pieces=2, num_test_pieces=2, mean_piece_len=300,
              batch_size=4, min_seq_len=48, seed=11, shard_index=0, shard_count=1)
    ours = sym.SyntheticSymbolicAudioDataModule(SEQ, **kw)
    theirs = jax_sym.SyntheticSymbolicAudioDataModule(SEQ, **kw)
    for dm in (ours, theirs):
        dm.prepare_data()
        dm.setup()
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(ours._splits[split], theirs._splits[split])
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        _assert_batches_equal(getattr(ours, loader)(), getattr(theirs, loader)())


def _touch(root, names):
    for name in names:
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.touch()


def test_split_logic_matches_jax(tmp_path):
    # Maestro: the official manifest's columns
    names = [f"2018/piece_{i}.midi" for i in range(6)]
    splits = ["train", "validation", "test", "train", "validation", "train"]
    maestro = tmp_path / "m" / "maestro-v3.0.0"
    _touch(maestro, names)
    (maestro / "maestro-v3.0.0.json").write_text(json.dumps({
        "midi_filename": {str(i): n for i, n in enumerate(names)},
        "split": {str(i): s for i, s in enumerate(splits)}}))
    # GiantMIDI: a flat dir (hash buckets, with a test bucket) and a pre-split one
    _touch(tmp_path / "g" / "midis", [f"piece_{i:03d}.mid" for i in range(40)])
    _touch(tmp_path / "p" / "midis", ["train/a.mid", "valid/b.mid", "test/c.mid"])
    for cls, root, test_bucket in (("MaestroV3DataModule", "m", None), ("GiantMidiPianoDataModule", "g", None),
                                   ("GiantMidiPianoDataModule", "g", 3), ("GiantMidiPianoDataModule", "p", None)):
        ours = getattr(sym, cls)(str(tmp_path / root), max_seq_len=SEQ)
        theirs = getattr(jax_sym, cls)(str(tmp_path / root), max_seq_len=SEQ)
        if test_bucket is not None:
            ours.test_bucket = theirs.test_bucket = test_bucket
        got, want = ours.load_source_dataset(), theirs.load_source_dataset()
        assert got == want and got["train"] and got["valid"]
        assert ours.split_signature() == theirs.split_signature()
    with pytest.raises(FileNotFoundError):
        sym.GiantMidiPianoDataModule(str(tmp_path / "none"), max_seq_len=SEQ).load_source_dataset()


def test_prepare_data_and_setup_match_jax(tmp_path, monkeypatch):
    # the encoder needs pretty_midi: both packages get the same stub, one
    # seeded piece per file
    def encode(files, num_workers=1):
        return [np.random.default_rng(len(str(f.name)) * 31 + i).integers(0, 388, 150).astype(np.int16)
                for i, f in enumerate(files)]

    monkeypatch.setattr(sym, "encode_midi_files", encode)
    monkeypatch.setattr(jax_sym, "encode_midi_files", encode)
    dms = []
    for pkg, mod in (("ours", sym), ("theirs", jax_sym)):
        root = tmp_path / pkg
        _touch(root / "midis", [f"piece_{i:03d}.mid" for i in range(30)])
        dm = mod.GiantMidiPianoDataModule(str(root), max_seq_len=SEQ, batch_size=2, seed=4,
                                          shard_index=0, shard_count=1)
        dm.prepare_data()
        dm.setup()
        dms.append(dm)
    ours, theirs = dms
    assert sorted(ours._splits) == sorted(theirs._splits) == ["train", "valid"]
    for split in ours._splits:
        assert isinstance(ours._splits[split], np.memmap)
        np.testing.assert_array_equal(ours._splits[split], theirs._splits[split])
    manifest = json.loads((ours.preproc_dir / "split_manifest.json").read_text())
    assert manifest["_signature"] == "" and len(manifest["train"]) + len(manifest["valid"]) == 30
    _assert_batches_equal(ours.train_dataloader(), theirs.train_dataloader(), n=4)
    # a cache built under another split layout is refused
    again = sym.GiantMidiPianoDataModule(str(tmp_path / "ours"), max_seq_len=SEQ)
    again.test_bucket = 3
    with pytest.raises(ValueError, match="different split configuration"):
        again.prepare_data()
