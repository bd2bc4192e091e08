"""The port's token shards against the reference's, bit for bit, and
``prefetch`` (on the CPU here; pinned copies to the card on a card)."""
import numpy as np
import pytest
import torch

from repro.data.synthetic import TokenShards as JTokenShards
from repro_torch.data.synthetic import TokenShards, prefetch


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 16, 2, 0),
                                                  (49152, 64, 3, 7)])
def test_token_shards_bitwise(vocab, seq, batch, seed):
    a = TokenShards(vocab=vocab, seq_len=seq, batch=batch, n_shards=4,
                    seed=seed)
    b = JTokenShards(vocab=vocab, seq_len=seq, batch=batch, n_shards=4,
                     seed=seed)
    for shard, idx in ((0, 0), (3, 5), (1, 2)):
        got, want = a.batch_at(shard, idx), b.batch_at(shard, idx)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
    it, jit = a.iterate(shard=2, start=4), b.iterate(shard=2, start=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], next(jit)["tokens"])


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_in_order(size):
    shards = TokenShards(vocab=128, seq_len=8, batch=2)
    batches = [shards.batch_at(0, i) for i in range(4)]
    got = list(prefetch(iter(batches), size=size, device="cpu"))
    assert len(got) == 4
    for g, want in zip(got, batches):
        for k in want:
            assert isinstance(g[k], torch.Tensor) and g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), want[k])


def test_prefetch_refuses_sharding_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="not ported"):
        next(prefetch(iter([]), sharding=object(), device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        next(prefetch(iter([{"tokens": np.zeros(2, np.int32)}])))
