"""The port's Hugging Face dataset path (qtpu_torch.data.pipeline) against
qtpu's on in-memory `datasets.Dataset`s and the whitespace tokenizer of
tests/test_data.py: the calibration preprocessing, the named-dataset
branches of get_calibration_dataset / get_test_dataset (each package's
`load_dataset` replaced by monkeypatch) and the block packer against
qtpu's native one, with its shared library and with its numpy fallback.
Token ids are integers: every comparison is exact."""

import sys

import numpy as np
import pytest

import qtpu.native
from qtpu.data import pipeline as jpipe
from qtpu_torch.data import pipeline as tpipe
from test_torch_native import _qtpu_native_so, qtpu_library  # noqa: F401  (fixtures)

datasets = pytest.importorskip("datasets")


class WordTokenizer:
    """Whitespace tokenizer: token id = word length (deterministic)."""

    def encode(self, text):
        return [min(len(w), 99) for w in text.split()]

    def __call__(self, text, return_tensors=None):
        class R:
            pass

        r = R()
        r.input_ids = np.asarray([self.encode(text)], np.int64)
        return r


def _ds(rows):
    return datasets.Dataset.from_dict({"text": rows})


def _rows(seed, n=60):
    """Rows of 0-24 random words of 1-12 letters, some blank or padded."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        words = ["x" * int(k) for k in rng.integers(1, 13, rng.integers(0, 25))]
        rows.append(("  " if rng.random() < 0.2 else "") + " ".join(words)
                    + ("\n" if rng.random() < 0.2 else ""))
    return rows


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and b.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


CALIB_CASES = [  # (rows seed, n_samples, block_size, shuffle seed)
    (0, 100, 16, 42), (1, 4, 4, 42), (2, 20, 8, 7), (3, 5, 30, 42), (4, 1000, 5, 0),
]


@pytest.mark.parametrize("seed,n,block,shuffle", CALIB_CASES)
def test_prepare_calibration_samples_equals_qtpu(seed, n, block, shuffle):
    ds, tok = _ds(_rows(seed)), WordTokenizer()
    got = tpipe.prepare_calibration_samples(ds, tok, n, block, seed=shuffle)
    _equal(got, jpipe.prepare_calibration_samples(ds, tok, n, block, seed=shuffle))
    assert got and all(b.shape == (1, block) for b in got)


def test_prepare_calibration_samples_refuses_an_empty_dataset():
    for mod in (tpipe, jpipe):
        with pytest.raises(ValueError, match="No valid samples"):
            mod.prepare_calibration_samples(_ds(["", "  "]), WordTokenizer(), 10, 16)


@pytest.mark.parametrize("native", [True, False])
def test_block_pack_equals_qtpu(monkeypatch, native, request):
    if native:  # qtpu's library, built for this process alone
        request.getfixturevalue("qtpu_library")
    else:
        monkeypatch.setattr(qtpu.native, "_load", lambda: None)
    rng = np.random.default_rng(5)
    for block in (1, 3, 16, 64):
        samples = [rng.integers(0, 32000, int(k), dtype=np.int32)
                   for k in rng.integers(1, 40, 17)]
        _equal(tpipe.block_pack(samples, block), qtpu.native.block_pack(samples, block))
    assert tpipe.block_pack([np.arange(3, dtype=np.int32)], 4) == []


@pytest.fixture
def hub(monkeypatch):
    """`datasets.load_dataset`, which both packages import on their
    named-dataset branch, replaced by an in-memory hub; returns its log of
    (name, config, split) calls."""
    data = {("wikitext", "wikitext-2-raw-v1", "validation"): _ds(_rows(10, 80)),
            ("wikitext", "wikitext-2-raw-v1", "test"): _ds(_rows(11, 40)),
            ("c4-like", None, "train"): _ds(_rows(12, 80))}
    log = []

    def load_dataset(name, *config, split=None):
        key = (name, config[0] if config else None, split)
        log.append(key)
        return data[key]

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    return log


@pytest.mark.parametrize("name,config,split", [("wikitext", "wikitext-2-raw-v1", "validation"),
                                               ("c4-like", None, "train")])
def test_named_calibration_dataset_equals_qtpu(hub, name, config, split):
    tok = WordTokenizer()
    got = tpipe.get_calibration_dataset(tok, name, config, split, n_samples=30, block_size=16)
    want = jpipe.get_calibration_dataset(tok, name, config, split, n_samples=30, block_size=16)
    _equal(got, want)
    assert hub == [(name, config, split)] * 2


@pytest.mark.parametrize("name,config,split", [("wikitext", "wikitext-2-raw-v1", "test"),
                                               ("c4-like", None, "train")])
def test_named_test_dataset_equals_qtpu(hub, name, config, split):
    tok = WordTokenizer()
    got = tpipe.get_test_dataset(tok, name, config, split)
    want = jpipe.get_test_dataset(tok, name, config, split)
    assert got.dtype == np.int32 and got.shape[0] == 1 and got.shape[1] > 100
    np.testing.assert_array_equal(got, want)
    assert hub == [(name, config, split)] * 2


def test_datasets_is_imported_on_the_named_branch_only(monkeypatch):
    """With no `datasets` package (as on the card), the synthetic branch
    (also any dataset without a tokenizer) runs, and a named dataset with a
    tokenizer fails on the import."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    blocks = tpipe.get_calibration_dataset(None, "wikitext", None, "train", n_samples=2,
                                           block_size=8, vocab_size=50)
    assert len(blocks) == 2 and blocks[0].shape == (1, 8)
    stream = tpipe.get_test_dataset(WordTokenizer(), "synthetic", None, "test", n_samples=2,
                                    block_size=8, vocab_size=50)
    assert stream.shape == (1, 16)
    with pytest.raises(ImportError):
        tpipe.get_test_dataset(WordTokenizer(), "wikitext", None, "test")
