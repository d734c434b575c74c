"""The generator: the same seed gives the same inputs, and every seed the
same work in another order."""
import numpy as np
import torch

from perfbench.harness import traffic

MIX = {"block": 32,
       "prompt": {"median": 2500, "sigma": 0.35, "min": 1024, "max": 3968},
       "max_new": {"median": 16, "sigma": 0.7, "min": 8, "max": 64}}
BIG = 2 ** 31 + 12345


def _draw(seed, n=96):
    r = traffic.Requests(MIX, seed, 32064)
    return [r.next() for _ in range(n)]


def test_requests_deterministic_by_seed():
    a, b = _draw(BIG), _draw(BIG)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    c = _draw(BIG + 1)
    assert any(len(x[0]) != len(y[0]) for x, y in zip(a, c))


def test_every_block_holds_the_same_sizes():
    for seed in (0, 7, BIG):
        d = _draw(seed)
        for k in range(0, 96, 32):
            blk = d[k:k + 32]
            assert sorted(len(p) for p, _ in blk) == sorted(
                traffic.quantiles(MIX["prompt"], 32))
            assert sorted(n for _, n in blk) == sorted(
                traffic.quantiles(MIX["max_new"], 32))
    q = traffic.quantiles(MIX["prompt"], 32)
    assert min(q) >= 1024 and max(q) <= 3968
    assert q[15] <= 2500 <= q[16]


def test_batches_deterministic_and_distinct():
    a = traffic.batch_tokens(BIG, 3, 4, 64, 32001, torch.device("cpu"))
    b = traffic.batch_tokens(BIG, 3, 4, 64, 32001, torch.device("cpu"))
    c = traffic.batch_tokens(BIG, 4, 4, 64, 32001, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len({tuple(r) for r in torch.cat([a, c]).tolist()}) == 8
    assert int(a.max()) < 32001
