"""The port's copy of the synthetic corpus (``data/pipeline.py``) against
the reference's: batches are a pure function of (seed, step, shard) and
equal bit for bit."""
import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (256, 32, 8, 0), (8192, 256, 8, 0), (151_936, 64, 4, 3),
    (512, 17, 6, 11)])
def test_batches_equal_reference(vocab, seq, batch, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref, got = JP.SyntheticCorpus(JP.DataConfig(**kw)), \
        TP.SyntheticCorpus(TP.DataConfig(**kw))
    assert (got.mult, got.add) == (ref.mult, ref.add)
    np.testing.assert_array_equal(got.unigram, ref.unigram)
    for step in (0, 1, 7, 1000):
        a, b = ref.global_batch_arrays(step), got.global_batch_arrays(step)
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].dtype == a[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_shards_equal_reference(num_shards):
    kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=5)
    ref, got = JP.SyntheticCorpus(JP.DataConfig(**kw)), \
        TP.SyntheticCorpus(TP.DataConfig(**kw))
    for shard in range(num_shards):
        for a, b in zip(ref.batch(3, shard=shard, num_shards=num_shards),
                        got.batch(3, shard=shard, num_shards=num_shards)):
            assert b.shape == (8 // num_shards, 24)
            np.testing.assert_array_equal(b, a)


def test_batches_are_stateless_and_shifted():
    """Any step can be regenerated in any order (resume needs no data
    state), and labels are the tokens shifted by one."""
    c = TP.SyntheticCorpus(TP.DataConfig(vocab_size=100, seq_len=16,
                                         global_batch=4, seed=2))
    late = c.global_batch_arrays(9)
    first = c.global_batch_arrays(0)
    np.testing.assert_array_equal(c.global_batch_arrays(9)["tokens"],
                                  late["tokens"])
    np.testing.assert_array_equal(first["tokens"][:, 1:],
                                  first["labels"][:, :-1])
    assert not np.array_equal(first["tokens"], late["tokens"])
    assert first["tokens"].min() >= 0 and first["tokens"].max() < 100
