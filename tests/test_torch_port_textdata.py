"""The port's text data layer against the JAX package's, on the CPU: the
same texts and seeds give the same batches, array for array.

- tokenizers: ``ByteTokenizer``, ``HFTokenizer`` over
  ``transformers.PerceiverTokenizer()`` (builds offline), ``load_tokenizer``;
- collators: padding, CLM labels, classification labels, static and dynamic
  word masking, token masking and random truncation, seed for seed;
- data modules: every task and view over ``ListDataModule`` (train, valid
  and test loaders), ``SyntheticTextDataModule``'s splits, the hub sources
  over an in-memory stand-in for ``datasets.load_dataset``, and the
  md5-keyed cache, read across packages;
- streaming: ``StreamingTextPipeline`` (chunks, shift, ``min_seq_len``,
  sharding, ``window_shuffle``), ``C4DataModule`` over an in-memory source,
  and ``resilient_source`` surviving an injected fault.
"""
import os

import numpy as np
import pytest

from perceiver_io_tpu.data.text import collators as jax_collators
from perceiver_io_tpu.data.text import datamodule as jax_datamodule
from perceiver_io_tpu.data.text import preprocessor as jax_preprocessor
from perceiver_io_tpu.data.text import sources as jax_sources
from perceiver_io_tpu.data.text import streaming as jax_streaming
from perceiver_io_tpu.data.text import tokenizers as jax_tokenizers
from perceiver_io_tpu.reliability import ChaosRegistry as JaxChaos
from perceiver_io_tpu.reliability import retry as jax_retry
from perceiver_io_tpu_torch.data.text import collators, datamodule, preprocessor, sources, streaming, tokenizers
from perceiver_io_tpu_torch.reliability import ChaosRegistry, InjectedFault
from perceiver_io_tpu_torch.reliability import retry

TEXTS = [
    "The quick brown fox jumps over the lazy dog. " * 3,
    "Perceiver IO scales linearly with input size,  not quadratically.\n" * 2,
    "Cross-attention onto latents keeps attention cost low. " * 4,
    "Latent bottlenecks: åß∂ and tabs\tbetween words. " * 2,
] * 4

PACKAGES = {
    "jax": (jax_tokenizers, jax_collators, jax_datamodule, jax_sources, jax_streaming),
    "port": (tokenizers, collators, datamodule, sources, streaming),
}


def _assert_batches_equal(port, ref):
    assert len(port) == len(ref) and len(ref) > 0
    for a, b in zip(port, ref):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key


# -- tokenizers ------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_byte_tokenizer_and_load_tokenizer_match_jax():
    for side in ("left", "right"):
        tok = tokenizers.load_tokenizer("byte", side)
        ref = jax_tokenizers.load_tokenizer("byte", side)
        assert type(tok) is tokenizers.ByteTokenizer and tok.padding_side == side
        for text in TEXTS[:4] + ["a <mask> b"]:
            assert tok.encode(text, add_special_tokens=True) == ref.encode(text, add_special_tokens=True)
            assert tok.word_ids(tok.encode(text)) == ref.word_ids(ref.encode(text))
        for got, want in zip(tok.encode_batch(TEXTS[:3], max_length=40, add_special_tokens=True),
                             ref.encode_batch(TEXTS[:3], max_length=40, add_special_tokens=True)):
            np.testing.assert_array_equal(got, want)
    assert tokenizers.load_tokenizer("deepmind/language-perceiver").vocab_size == 262


def test_hf_tokenizer_matches_jax():
    from transformers import PerceiverTokenizer

    tok = tokenizers.HFTokenizer(PerceiverTokenizer(), padding_side="left")
    ref = jax_tokenizers.HFTokenizer(PerceiverTokenizer(), padding_side="left")
    for attr in ("vocab_size", "pad_token_id", "mask_token_id", "mask_token", "eos_token_id", "padding_side"):
        assert getattr(tok, attr) == getattr(ref, attr), attr
    for text in TEXTS[:4]:
        ids = tok.encode(text)
        assert ids == ref.encode(text) == tokenizers.ByteTokenizer().encode(text)
        assert tok.decode(ids) == ref.decode(ids)
        assert tok.word_ids(ids) == ref.word_ids(ids)
    for got, want in zip(tok.encode_batch(TEXTS[:3], max_length=48), ref.encode_batch(TEXTS[:3], max_length=48)):
        np.testing.assert_array_equal(got, want)
    assert tok.batch_decode([[40, 41], [42]]) == ref.batch_decode([[40, 41], [42]])


def test_text_preprocessor_matches_jax():
    for special in (False, True):
        got = preprocessor.TextPreprocessor("byte", 24, add_special_tokens=special)
        want = jax_preprocessor.TextPreprocessor("byte", 24, add_special_tokens=special)
        for a, b in zip(got.preprocess_batch(TEXTS[:3], pad_to_max=True),
                        want.preprocess_batch(TEXTS[:3], pad_to_max=True)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got.preprocess("hello"), want.preprocess("hello")):
            np.testing.assert_array_equal(a, b)


# -- collators -------------------------------------------------------------
def _examples(tok, n=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = tok.encode(TEXTS[i], add_special_tokens=bool(i % 2))[: int(rng.integers(10, 60))]
        wids = [collators.NO_WORD if w is None else w for w in tok.word_ids(ids)]
        out.append({"input_ids": np.asarray(ids, np.int32), "word_ids": np.asarray(wids),
                    "label_ids": np.asarray(ids[1:] + [0], np.int32), "label": i % 3})
    return out


def _collator(pkg, kind, side, seed):
    tok_mod, col = PACKAGES[pkg][0], PACKAGES[pkg][1]
    tok = tok_mod.ByteTokenizer(padding_side=side)
    if kind == "default":
        return col.DefaultCollator(tok, max_seq_len=64)
    if kind == "word":
        return col.WordMaskingCollator(tok, mask_prob=0.3, seed=seed)
    if kind == "token":
        return col.TokenMaskingCollator(tok, mask_prob=0.3, seed=seed)
    return col.RandomTruncateCollator(col.DefaultCollator(tok, max_seq_len=64), min_seq_len=8, seed=seed)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("keys", ["clm", "clf", "ids"])
@pytest.mark.parametrize("kind", ["default", "word", "token", "truncate"])
def test_collators_match_jax(kind, keys, side):
    assert collators.IGNORE_INDEX == jax_collators.IGNORE_INDEX == -100
    assert collators.NO_WORD == jax_collators.NO_WORD == -1
    drop = {"clm": ("label",), "clf": ("label_ids",), "ids": ("label", "label_ids")}[keys]
    got_c, want_c = _collator("port", kind, side, seed=3), _collator("jax", kind, side, seed=3)
    for draw in range(3):  # the generators advance alike from call to call
        ex = [{k: v for k, v in e.items() if k not in drop} for e in _examples(tokenizers.ByteTokenizer(), seed=draw)]
        _assert_batches_equal([got_c([dict(e) for e in ex])], [want_c([dict(e) for e in ex])])


def test_word_masking_example_matches_jax():
    tok = tokenizers.ByteTokenizer()
    got = collators.WordMaskingCollator(tok, mask_prob=0.5, seed=11)
    want = jax_collators.WordMaskingCollator(jax_tokenizers.ByteTokenizer(), mask_prob=0.5, seed=11)
    for e in _examples(tok, n=4):
        for a, b in zip(got.mask_example(e["input_ids"], e["word_ids"]),
                        want.mask_example(e["input_ids"], e["word_ids"])):
            np.testing.assert_array_equal(a, b)


# -- data modules ------------------------------------------------------------
DM_CASES = {
    "clm": dict(task="clm"),
    "clm-shift": dict(task="clm", random_train_shift=True, random_valid_shift=True),
    "clm-truncate": dict(task="clm", random_train_truncation=True, random_valid_truncation=True,
                         random_min_seq_len=8, padding_side="left"),
    "clm-eos-special": dict(task="clm", add_eos_token=True, add_special_tokens=True),
    "mlm-words": dict(task="mlm", mask_prob=0.2),
    "mlm-tokens": dict(task="mlm", mask_words=False, mask_prob=0.2),
    "mlm-static": dict(task="mlm", static_masking=True, mask_prob=0.25, random_train_shift=True),
    "clf": dict(task="clf", padding_side="left"),
}


def _list_dm(pkg, root, case, seed=5):
    kw = dict(DM_CASES[case])
    labels = dict(train_labels=[i % 2 for i in range(len(TEXTS))], valid_labels=[0, 1, 1, 0],
                  test_labels=[1, 0], num_classes=2) if kw["task"] == "clf" else {}
    dm = PACKAGES[pkg][3].ListDataModule(
        train_texts=TEXTS, valid_texts=TEXTS[:4], test_texts=TEXTS[4:6], dataset_dir=str(root),
        tokenizer="byte", max_seq_len=32, batch_size=4, valid_batch_size=2, seed=seed, **labels, **kw)
    dm.prepare_data()
    dm.setup()
    return dm


def _all_batches(dm, epochs=2):
    out = []
    loaders = (dm.train_dataloader, dm.val_dataloader) + ((dm.test_dataloader,) if dm.ds_test is not None else ())
    for loader in loaders:
        it = loader()
        for _ in range(epochs):
            out.extend(it)
    return out


@pytest.mark.parametrize("case", sorted(DM_CASES))
def test_list_datamodule_batches_match_jax(case, tmp_path):
    got = _list_dm("port", tmp_path / "port", case)
    want = _list_dm("jax", tmp_path / "jax", case)
    assert os.path.basename(got.preproc_dir) == os.path.basename(want.preproc_dir)
    assert got.preproc_dir_hash_input() == want.preproc_dir_hash_input()
    assert (got.vocab_size, got.num_classes, got.task.name) == (want.vocab_size, want.num_classes, want.task.name)
    assert len(got.ds_train) == len(want.ds_train) and len(got.ds_valid) == len(want.ds_valid)
    _assert_batches_equal(_all_batches(got), _all_batches(want))


def test_cache_is_read_across_packages(tmp_path):
    """A cache written by either package is the other's: the same directory
    name, the same ``.npy`` arrays and ``meta.json``, and no rebuild."""
    jax_root, port_root = tmp_path / "by_jax", tmp_path / "by_port"
    want = _list_dm("jax", jax_root, "mlm-static")
    got = _list_dm("port", port_root, "mlm-static")
    names = sorted(os.listdir(want.preproc_dir))
    assert sorted(os.listdir(got.preproc_dir)) == names and "meta.json" in names
    assert open(os.path.join(got.preproc_dir, "meta.json")).read() == \
        open(os.path.join(want.preproc_dir, "meta.json")).read()
    for name in names:
        if name.endswith(".npy"):
            a = np.load(os.path.join(got.preproc_dir, name))
            b = np.load(os.path.join(want.preproc_dir, name))
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, name
    for reader, writer_root in (("port", jax_root), ("jax", port_root)):
        before = {n: os.stat(os.path.join(want.preproc_dir if writer_root == jax_root else got.preproc_dir,
                                          n)).st_mtime_ns for n in names}
        dm = _list_dm(reader, writer_root, "mlm-static")
        after = {n: os.stat(os.path.join(dm.preproc_dir, n)).st_mtime_ns for n in names}
        assert after == before  # read, not rebuilt
    _assert_batches_equal(_all_batches(_list_dm("port", jax_root, "mlm-static")), _all_batches(want))


def test_missing_test_split_raises_like_jax(tmp_path):
    got = sources.ListDataModule(train_texts=TEXTS, valid_texts=TEXTS[:4], dataset_dir=str(tmp_path),
                                 max_seq_len=32, task="clm", batch_size=4)
    got.prepare_data()
    got.setup()
    with pytest.raises(ValueError, match="materialized no test split"):
        got.test_dataloader()
    with pytest.raises(ValueError, match="static_masking=true is only supported"):
        sources.ListDataModule(train_texts=TEXTS, valid_texts=TEXTS, dataset_dir=str(tmp_path),
                               static_masking=True, mask_words=False)


@pytest.mark.parametrize("task", ["clm", "mlm", "clf"])
def test_synthetic_splits_match_jax(task, tmp_path):
    kw = dict(num_train_docs=4, num_valid_docs=2, num_test_docs=2, doc_chars=256, max_seq_len=32,
              task=task, batch_size=2, corpus_seed=3)
    got = sources.SyntheticTextDataModule(dataset_dir=str(tmp_path / "port"), **kw)
    want = jax_sources.SyntheticTextDataModule(dataset_dir=str(tmp_path / "jax"), **kw)
    assert got.load_source_dataset() == want.load_source_dataset()
    assert got.num_classes == want.num_classes
    for dm in (got, want):
        dm.prepare_data()
        dm.setup()
    assert got.preproc_dir_hash_input() == want.preproc_dir_hash_input()
    _assert_batches_equal(_all_batches(got, epochs=1), _all_batches(want, epochs=1))
    np.testing.assert_array_equal(sources.markov_transition(np.random.default_rng(4)),
                                  jax_sources.markov_transition(np.random.default_rng(4)))


class _FakeSplit(dict):
    """A ``datasets`` split: column access by name."""


def _fake_hub(path, name=None, **kwargs):
    docs = [f"{path} document {i}: " + TEXTS[i % 4] for i in range(40)]
    split = _FakeSplit(text=docs, label=[i % 2 for i in range(40)])
    if kwargs.get("split") == "train":
        return split
    return {"train": split, "validation": _FakeSplit(text=docs[:6]), "test": _FakeSplit(text=docs[6:12], label=[1] * 6),
            "unsupervised": _FakeSplit(text=docs[12:])}


HUB = {"wikitext": ("WikiTextDataModule", {}), "imdb": ("ImdbDataModule", {}),
       "imdb-clf": ("ImdbDataModule", dict(task="clf")),
       "enwik8": ("Enwik8DataModule", dict(source_valid_size=0.1, source_test_size=0.1)),
       "bookcorpus": ("BookCorpusDataModule", {}), "bookcorpusopen": ("BookCorpusOpenDataModule", {}),
       "wikipedia": ("WikipediaDataModule", dict(source_valid_size=0.2))}


@pytest.mark.parametrize("name", sorted(HUB))
def test_hub_sources_match_jax(name, tmp_path, monkeypatch):
    """The hub modules' split logic over an in-memory ``load_dataset``."""
    cls_name, kw = HUB[name]
    dms = []
    for pkg, mod in (("port", sources), ("jax", jax_sources)):
        monkeypatch.setattr(mod._HubDataModule, "_load", lambda self, path, name=None, **k: _fake_hub(path, name, **k))
        dm = getattr(mod, cls_name)(dataset_dir=str(tmp_path / pkg), max_seq_len=32, batch_size=2,
                                    task=kw.get("task", "clm"), **{k: v for k, v in kw.items() if k != "task"})
        dm.prepare_data()
        dm.setup()
        dms.append(dm)
    got, want = dms
    assert got.num_classes == want.num_classes
    assert got.preproc_dir_hash_input() == want.preproc_dir_hash_input()
    _assert_batches_equal(_all_batches(got, epochs=1), _all_batches(want, epochs=1))


def test_carved_test_split_matches_jax():
    for mod in (sources, jax_sources):
        class Carver(mod._CarvedTestSplit):
            source_valid_size = 0.25
            source_test_size = 0.1
        texts = [f"doc{i}" for i in range(100)]
        assert Carver()._carved_splits(texts, 25) == {"train": texts[:65], "valid": texts[75:],
                                                      "test": texts[65:75]}
        Carver.source_test_size = 0.8
        with pytest.raises(ValueError, match="no training data"):
            Carver()._carved_splits(texts, 25)


# -- streaming ---------------------------------------------------------------
STREAM_CASES = {
    "plain": dict(max_seq_len=32, batch_size=2),
    "min_seq_len": dict(max_seq_len=32, min_seq_len=8, batch_size=4, seed=2),
    "shard": dict(max_seq_len=16, batch_size=1, shard_index=1, shard_count=3),
    "shuffle": dict(max_seq_len=16, batch_size=3, shuffle_window_size=5, seed=7),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streaming_pipeline_matches_jax(case):
    kw = {"shard_index": 0, "shard_count": 1, **STREAM_CASES[case]}
    docs = [f"doc {i}: " + TEXTS[i % 4] for i in range(24)]
    got = list(streaming.StreamingTextPipeline(lambda: iter(docs), "byte", **kw))
    want = list(jax_streaming.StreamingTextPipeline(lambda: iter(docs), "byte", **kw))
    _assert_batches_equal(got, want)
    np.testing.assert_array_equal(got[0]["input_ids"][:, 1:][~got[0]["pad_mask"][:, 1:]],
                                  got[0]["labels"][:, :-1][~got[0]["pad_mask"][:, 1:]])


def test_shard_and_window_shuffle_match_jax():
    assert list(streaming.shard_iterable(range(20), 1, 3)) == list(jax_streaming.shard_iterable(range(20), 1, 3))
    for seed in (0, 5):
        out = list(streaming.window_shuffle(range(100), window_size=10, seed=seed))
        assert out == list(jax_streaming.window_shuffle(range(100), window_size=10, seed=seed))
        assert sorted(out) == list(range(100)) and out != list(range(100))


def test_c4_datamodule_matches_jax(monkeypatch):
    docs = [f"c4 record {i} " + TEXTS[i % 4] for i in range(30)]
    out = []
    for mod in (streaming, jax_streaming):
        monkeypatch.setattr(mod.C4DataModule, "_hub_texts", lambda self, split: lambda: iter(docs))
        dm = mod.C4DataModule(tokenizer="byte", max_seq_len=24, min_seq_len=12, batch_size=2,
                              shuffle_window_size=4, shard_index=0, shard_count=1)
        assert dm.vocab_size == 262 and dm.retry_policy.max_retries == 3
        out.append([list(dm.train_dataloader()), list(dm.val_dataloader())])
    for got, want in zip(*out):
        _assert_batches_equal(got, want)


def test_streaming_pipeline_survives_a_source_fault():
    texts = [f"record number {i} padding it out a bit" for i in range(12)]
    kw = dict(tokenizer=tokenizers.ByteTokenizer(), max_seq_len=16, batch_size=2, shard_index=0, shard_count=1)
    plain = list(streaming.StreamingTextPipeline(lambda: iter(texts), **kw))
    chaos = ChaosRegistry()
    chaos.loader_error_on_record(5)
    sleeps = []
    faulted = list(streaming.StreamingTextPipeline(
        chaos.wrap_source(lambda: iter(texts)), retry_policy=retry.RetryPolicy(max_retries=2),
        retry_sleep=sleeps.append, **kw))
    assert chaos.fired_count() == 1 and sleeps == [0.5]
    _assert_batches_equal(faulted, plain)
    ref = list(jax_streaming.StreamingTextPipeline(lambda: iter(texts), **{**kw, "tokenizer": "byte"}))
    _assert_batches_equal(faulted, ref)


@pytest.mark.parametrize("fault", ["transient", "persistent"])
def test_resilient_source_matches_jax(fault):
    """``resilient_source`` with the same injected faults as JAX's chaos
    tests: the same records out, the same backoff schedule, the same raise."""
    count = 1 if fault == "transient" else 50
    results = []
    for chaos_cls, mod in ((ChaosRegistry, retry), (JaxChaos, jax_retry)):
        chaos = chaos_cls()
        chaos.loader_error_on_record(4, count=count)
        sleeps = []
        policy = mod.RetryPolicy(max_retries=2, backoff_base_s=0.5, backoff_factor=3.0)
        stream = mod.resilient_source(chaos.wrap_source(lambda: iter("abcdefgh")), policy, sleep=sleeps.append)
        try:
            got = list(stream)
        except Exception as e:  # the injected fault, past the retry budget
            got = type(e).__name__
        results.append((got, sleeps, chaos.fired_count("data.record")))
    assert results[0] == results[1]
    if fault == "transient":
        assert results[0] == (list("abcdefgh"), [0.5], 1)
    else:
        assert results[0][:2] == (InjectedFault.__name__, [0.5, 1.5])
