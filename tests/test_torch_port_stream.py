"""PyTorch port, the token-stream corpus (``data/stream.py``) against the JAX package's.

Both loaders read the committed ``tests/fixtures/corpus_tiny`` (seq 64, four shards of 48,
48, 48 and 5 sequences, an eval split of 38) and a copy with a shard edited. The module is
numpy only in both packages, so everything is held bitwise: epoch plans, batches, epoch
token arrays, stream digests, cursors, the cursor checks and their errors.
"""

import json
import os
import shutil

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.data import stream as jax_stream
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import stream

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "corpus_tiny")


def _pair(batch, seed, **kw):
    return (stream.StreamLoader(FIXTURE, batch, seed=seed, **kw),
            jax_stream.StreamLoader(FIXTURE, batch, seed=seed, **kw))


@pytest.mark.parametrize("batch,seed", [(16, 0), (7, 3), (149, 1)])
def test_plans_batches_tokens_and_digests_are_bitwise(batch, seed):
    ours, theirs = _pair(batch, seed)
    assert (ours.vocab, ours.seq_len, ours.num_sequences, ours.batches_per_epoch) == (
        theirs.vocab, theirs.seq_len, theirs.num_sequences, theirs.batches_per_epoch)
    for epoch in range(3):
        a, b = ours.epoch_plan(epoch), theirs.epoch_plan(epoch)
        np.testing.assert_array_equal(a["order"], b["order"])
        assert a["crc"] == b["crc"] and a["perms"].keys() == b["perms"].keys()
        for s in a["perms"]:
            np.testing.assert_array_equal(a["perms"][s], b["perms"][s])
        got, want = ours.epoch_tokens(epoch), theirs.epoch_tokens(epoch)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert got.shape == (ours.batches_per_epoch * batch, 64)
        for start in (0, 1, ours.batches_per_epoch - 1):
            assert ours.stream_digest(epoch, start_batch=start) == theirs.stream_digest(
                epoch, start_batch=start)
            np.testing.assert_array_equal(ours.epoch_tokens(epoch, start_batch=start),
                                          theirs.epoch_tokens(epoch, start_batch=start))
    assert ours.epoch_plan(0)["crc"] != ours.epoch_plan(1)["crc"]


@pytest.mark.parametrize("batch", [16, 7])
def test_cursors_and_their_checks_are_bitwise(batch):
    ours, theirs = _pair(batch, 2)
    for epoch in (0, 4):
        for b in range(ours.batches_per_epoch + 1):
            cur = ours.cursor(epoch, b)
            assert cur == theirs.cursor(epoch, b)
            assert ours.verify_cursor(cur) == theirs.verify_cursor(cur) == (epoch, b)
    with pytest.raises(ValueError, match="outside epoch"):
        ours.cursor(0, ours.batches_per_epoch + 1)
    good = ours.cursor(1, 2)
    for key, value, match in (("kind", "epoch", "not a stream cursor"),
                              ("version", 9, "unknown cursor version"),
                              ("seed", 5, "resuming would reshuffle"),
                              ("offset", good["offset"] + 1, "offset mismatch"),
                              ("plan_crc", 1, "plan_crc mismatch")):
        bad = {**good, key: value}
        for loader, error in ((ours, stream.CorpusError), (theirs, jax_stream.CorpusError)):
            with pytest.raises(error, match=match):
                loader.verify_cursor(bad)


def test_meta_eval_split_shard_checks_and_wait_accounting(tmp_path):
    np.testing.assert_array_equal(stream.eval_tokens(FIXTURE), jax_stream.eval_tokens(FIXTURE))
    assert stream.eval_tokens(FIXTURE).dtype == np.int32
    assert stream.load_meta(FIXTURE) == jax_stream.load_meta(FIXTURE)
    # an edited shard fails its sha256 in both; unverified it loads
    corpus = tmp_path / "corpus"
    shutil.copytree(FIXTURE, corpus)
    data = np.load(corpus / "shard_0001.npy")
    data[0, 0] ^= 1
    np.save(corpus / "shard_0001.npy", data)
    for mod in (stream, jax_stream):
        with pytest.raises(mod.CorpusError, match="sha256 mismatch"):
            mod.StreamLoader(str(corpus), 16, seed=0).epoch_tokens(0)
        assert mod.StreamLoader(str(corpus), 16, seed=0, verify=False).epoch_tokens(
            0).shape == (9 * 16, 64)
    # a torn meta, a meta without shards, a batch larger than the corpus
    (corpus / "corpus.json").write_text("{")
    with pytest.raises(stream.CorpusError, match="unreadable corpus meta"):
        stream.load_meta(str(corpus))
    meta = json.loads(open(os.path.join(FIXTURE, "corpus.json")).read())
    (corpus / "corpus.json").write_text(json.dumps({**meta, "shards": []}))
    with pytest.raises(stream.CorpusError, match="zero shards"):
        stream.load_meta(str(corpus))
    with pytest.raises(stream.CorpusError, match="fewer than one batch"):
        stream.StreamLoader(FIXTURE, 150)
    with pytest.raises(ValueError, match="batch_size"):
        stream.StreamLoader(FIXTURE, 0)
    # the throttle's sleep lands in the wait seconds, and pop_wait_s resets them
    loader = stream.StreamLoader(FIXTURE, 64, seed=0, throttle_s=0.01)
    assert loader.batches_per_epoch == 2
    loader.epoch_tokens(0)
    assert loader.pop_wait_s() >= 0.02
    assert loader.pop_wait_s() == 0.0
