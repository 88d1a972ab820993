"""Port data path (hetu_galvatron_tpu_torch.data.indexed_dataset and the
indexed branch of runtime.dataloader) against the JAX package.

Everything here is integer bookkeeping, so the comparison is exact: the
sample mapping of the JAX C++ helper, the split ranges, the epoch-seeded
order, the blend's picks, the files each writer produces (byte for byte)
and every batch of the loaders, packed-document fields and eod loss mask
included.
"""

import json
import os

import numpy as np
import pytest

from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu.data import indexed_dataset as JI
from hetu_galvatron_tpu.runtime import dataloader as JD
from hetu_galvatron_tpu_torch.core import arguments as TA
from hetu_galvatron_tpu_torch.data import indexed_dataset as TI
from hetu_galvatron_tpu_torch.data import synthetic as TS
from hetu_galvatron_tpu_torch.runtime import dataloader as TD

EOD = 3
VOCAB = 200


def _docs(n, seed=0, lo=1, hi=40):
    rng = np.random.default_rng(seed)
    return [np.append(rng.integers(4, VOCAB, rng.integers(lo, hi)), EOD)
            for _ in range(n)]


def _corpus(tmp_path, name="corpus", n=60, seed=0, meta=True):
    prefix = str(tmp_path / name)
    TI.write_indexed_dataset(prefix, _docs(n, seed))
    if meta:
        with open(prefix + ".meta.json", "w") as f:
            json.dump({"vocab_size": VOCAB, "eod_id": EOD}, f)
    return prefix


def _same_batches(jit, tit, n):
    for _ in range(n):
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)


@pytest.mark.parametrize("seq_len", [1, 3, 8, 33])
def test_torch_build_sample_idx_matches_jax(seq_len):
    """Random document lengths, zero-length documents (first one too)
    included, against the JAX helper (its C++ two-pointer walk)."""
    rng = np.random.default_rng(seq_len)
    for trial in range(60):
        lens = rng.integers(0, 3 * seq_len + 2, rng.integers(1, 25))
        if trial % 4 == 0:
            lens[0] = 0
        for num in (0, 2, 1000):
            np.testing.assert_array_equal(
                TI.build_sample_idx(lens, seq_len, num),
                JI.build_sample_idx(lens, seq_len, num))


def test_torch_split_doc_ranges_match_jax():
    for n in (0, 1, 7, 100, 601):
        for split in ("969,30,1", "98,1,1", "1,1,1", "1,0,0", "0,5,5",
                      "2.5,1,0.5"):
            assert TI.split_doc_ranges(n, split) == \
                JI.split_doc_ranges(n, split)
    for bad in ("1,1", "-1,1,1", "0,0,0"):
        with pytest.raises(ValueError, match="data.split"):
            TI.split_doc_ranges(10, bad)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
def test_torch_corpus_files_match_jax_byte_for_byte(tmp_path, dtype):
    docs = _docs(20, seed=1)
    assert TI.write_indexed_dataset(str(tmp_path / "t"), docs, dtype) == \
        JI.write_indexed_dataset(str(tmp_path / "j"), docs, dtype)
    for ext in (".bin", ".idx"):
        with open(tmp_path / ("t" + ext), "rb") as f1, \
                open(tmp_path / ("j" + ext), "rb") as f2:
            assert f1.read() == f2.read()
    # each package reads the other's files
    for reader, prefix in ((TI.IndexedDataset, "j"), (JI.IndexedDataset, "t")):
        ds = reader(str(tmp_path / prefix))
        assert len(ds) == 20 and ds.dtype == np.dtype(dtype)
        for i in (0, 7, 19):
            np.testing.assert_array_equal(ds.get_doc(i), docs[i])


def test_torch_gpt_dataset_order_across_epochs_matches_jax(tmp_path):
    prefix = _corpus(tmp_path, n=30)
    for shuffle in (True, False):
        for rng in (None, (3, 25)):
            tds = TI.GPTDataset(TI.IndexedDataset(prefix), 16, seed=5,
                                shuffle=shuffle, doc_range=rng)
            jds = JI.GPTDataset(JI.IndexedDataset(prefix), 16, seed=5,
                                shuffle=shuffle, doc_range=rng)
            assert len(tds) == len(jds) > 4
            np.testing.assert_array_equal(tds.sample_idx, jds.sample_idx)
            # three epochs, each reshuffled
            for i in range(3 * len(tds)):
                np.testing.assert_array_equal(tds[i], jds[i])


def test_torch_blended_dataset_picks_match_jax(tmp_path):
    prefixes = [_corpus(tmp_path, f"c{i}", n=20 + 10 * i, seed=i)
                for i in range(3)]
    for weights in (None, [0.2, 0.5, 0.3]):
        tb = TI.BlendedDataset([TI.GPTDataset(TI.IndexedDataset(p), 8, seed=2)
                                for p in prefixes], weights, seed=9)
        jb = JI.BlendedDataset([JI.GPTDataset(JI.IndexedDataset(p), 8, seed=2)
                                for p in prefixes], weights, seed=9)
        np.testing.assert_array_equal(tb._picks, jb._picks)
        np.testing.assert_array_equal(tb._within, jb._within)
        assert len(tb) == len(jb)
        for i in list(range(200)) + [65535, 65536, 70000]:
            np.testing.assert_array_equal(tb[i], jb[i])


@pytest.mark.parametrize("split_index", [0, 1, 2])
def test_torch_indexed_batches_match_jax(tmp_path, split_index):
    prefixes = [_corpus(tmp_path, f"c{i}", n=80, seed=i) for i in range(2)]
    for paths in (prefixes[0], prefixes):
        kw = dict(seed=4, split="8,1,1", split_index=split_index,
                  shuffle=split_index == 0)
        _same_batches(JI.indexed_batches(paths, 16, 3, **kw),
                      TI.indexed_batches(paths, 16, 3, **kw), 6)


def _args(tmp_path, extra=()):
    prefix = _corpus(tmp_path, n=120)
    over = ["model.vocab_size=200", "model.seq_length=24",
            "model.max_position_embeddings=32", "data.dataset=indexed",
            f"data.data_path=[{prefix}]", "data.split=90,5,5",
            "parallel.global_train_batch_size=3", "train.eval_interval=2",
            "train.eval_iters=1", *extra]
    return JA.load_config(None, over), TA.load_config(None, over)


@pytest.mark.parametrize("flags", [
    (),
    ("data.eod_mask_loss=true",),
    ("data.reset_position_ids=true", "data.reset_attention_mask=true",
     "data.eod_mask_loss=true"),
    ("data.reset_attention_mask=true",),
])
def test_torch_data_iterators_packed_and_eod_masked_match_jax(tmp_path,
                                                              flags):
    jargs, targs = _args(tmp_path, flags)
    jits = JD.get_train_valid_test_data_iterators(jargs)
    tits = TD.get_train_valid_test_data_iterators(targs)
    for split, (ji, ti) in zip(("train", "valid", "test"), zip(jits, tits)):
        assert ji is not None and ti is not None, split
        _same_batches(ji, ti, 4)
    b = next(tits[0])
    if "data.eod_mask_loss=true" in flags:
        assert (b["loss_mask"][b["tokens"] == EOD] == 0).all()
    if "data.reset_attention_mask=true" in flags:
        assert b["segment_ids"].max() > 0


def test_torch_empty_eval_split_degrades_with_a_warning(tmp_path, capsys):
    # 120 documents at 90/5/5 leave 6 documents (~130 tokens) per eval
    # split: at seq 256 neither holds one sample
    jargs, targs = _args(tmp_path, ["model.seq_length=256",
                                    "model.max_position_embeddings=256"])
    train, valid, test = TD.get_train_valid_test_data_iterators(targs)
    err = capsys.readouterr().err
    assert valid is None and test is None
    assert "warning: valid eval disabled" in err
    assert "warning: test eval disabled" in err
    assert next(train)["tokens"].shape == (3, 256)
    jits = JD.get_train_valid_test_data_iterators(jargs)
    assert jits[1] is None and jits[2] is None
    # an empty training split is an error, raised before the first batch
    with pytest.raises(ValueError, match="train split smaller"):
        TD.get_data_iterator(TA.load_config(None, [
            "model.seq_length=4096", "model.max_position_embeddings=4096",
            "data.dataset=indexed",
            f"data.data_path=[{tmp_path / 'corpus'}]"]))


def test_torch_indexed_loader_refusals(tmp_path):
    prefix = _corpus(tmp_path, n=40)
    bare = _corpus(tmp_path, "bare", n=40, meta=False)
    base = ["data.dataset=indexed", "model.seq_length=16"]
    with pytest.raises(NotImplementedError, match="s3://"):
        TD.get_data_iterator(TA.load_config(None, base + [
            "data.data_path=[s3://bucket/corpus]"]))
    with pytest.raises(ValueError, match="exceeds model padded vocab"):
        TD.get_data_iterator(TA.load_config(None, base + [
            f"data.data_path=[{prefix}]", "model.vocab_size=100",
            "model.make_vocab_size_divisible_by=1"]))
    # packing needs the eod id of the sidecar
    with pytest.raises(ValueError, match="document boundaries"):
        TD.get_data_iterator(TA.load_config(None, base + [
            f"data.data_path=[{bare}]", "data.reset_position_ids=true"]))
    # without a sidecar there is no eod id, so eod masking is a no-op (as
    # in JAX)
    b = next(TD.get_data_iterator(TA.load_config(None, base + [
        f"data.data_path=[{bare}]", "data.eod_mask_loss=true"])))
    assert b["loss_mask"].all()
    with open(os.path.join(tmp_path, "other.meta.json"), "w") as f:
        json.dump({"vocab_size": VOCAB, "eod_id": EOD + 1}, f)
    TI.write_indexed_dataset(str(tmp_path / "other"), _docs(5))
    with pytest.raises(ValueError, match="different tokenizers"):
        TD.corpus_meta([prefix, str(tmp_path / "other")])


def test_torch_random_corpus_is_seeded_and_reads_the_same_in_jax(tmp_path):
    """The seeded corpus of the smoke run and the step breakdown: documents
    end in eod and hold no other eod, lengths stay in [16, 16384], a seed
    gives the same files, and its overrides give the same packed, eod-masked
    batches in both packages."""
    kw = dict(docs=40, mean_len=30, vocab=VOCAB, eod=EOD,
              tokenizer_vocab=VOCAB, seed=3)
    stats = TS.write_random_corpus(str(tmp_path / "a"), **kw)
    assert TS.write_random_corpus(str(tmp_path / "b"), **kw) == stats
    for ext in (".bin", ".idx", ".meta.json"):
        with open(tmp_path / ("a" + ext), "rb") as f1, \
                open(tmp_path / ("b" + ext), "rb") as f2:
            assert f1.read() == f2.read()
    ds = JI.IndexedDataset(str(tmp_path / "a"))
    assert len(ds) == stats["documents"] == 40
    assert ds.total_tokens == stats["tokens"]
    for i in range(len(ds)):
        doc = ds.get_doc(i)
        assert 16 <= doc.size <= 16384 and doc[-1] == EOD
        assert (doc[:-1] < EOD).all() and (doc[:-1] >= 0).all()
    over = ["model.vocab_size=200", "model.seq_length=24",
            "model.max_position_embeddings=32",
            "parallel.global_train_batch_size=3",
            *TS.packed_corpus_overrides(str(tmp_path / "a"))]
    _same_batches(JD.get_data_iterator(JA.load_config(None, over)),
                  TD.get_data_iterator(TA.load_config(None, over)), 4)


def test_torch_random_corpus_takes_the_ids_of_the_configs_tokenizer(
        tmp_path):
    """Mistral's eod id is 2, at the bottom of its vocabulary: its corpus
    draws ordinary ids from [3, 32000); Qwen's keeps [0, eod) (the same
    files as before the range became a parameter)."""
    assert TS.corpus_tokenizer("mixtral-8x7b") == TS.TOKENIZERS["mistral"]
    qwen = TS.corpus_tokenizer("qwen2.5-7b")
    assert qwen["ids"] == (0, qwen["eod"])
    with pytest.raises(ValueError, match="no tokenizer"):
        TS.corpus_tokenizer("gpt2-small")
    kw = dict(docs=30, mean_len=40, seed=2)
    TS.write_random_corpus(str(tmp_path / "m"), **kw,
                           **TS.corpus_tokenizer("mixtral-8x7b"))
    ds = JI.IndexedDataset(str(tmp_path / "m"))
    for i in range(len(ds)):
        doc = ds.get_doc(i)
        assert doc[-1] == 2 and doc[:-1].min() >= 3 and doc.max() < 32000
    small = dict(vocab=VOCAB, eod=EOD, tokenizer_vocab=VOCAB, seed=3,
                 docs=10, mean_len=30)
    TS.write_random_corpus(str(tmp_path / "d"), **small)
    TS.write_random_corpus(str(tmp_path / "e"), **small, ids=(0, EOD))
    with open(tmp_path / "d.bin", "rb") as f1, \
            open(tmp_path / "e.bin", "rb") as f2:
        assert f1.read() == f2.read()
    with pytest.raises(ValueError, match="eod"):
        TS.write_random_corpus(str(tmp_path / "x"), **small, ids=(0, VOCAB))
