"""The one general generator of traffic: it reads a mix's parameters
(``perfbench/traffic/<name>.json``) and a seed.

Training: batches of token ids drawn uniformly on the device, a fresh
batch for every step, so no two rows repeat.

Serving: a sequence of requests taken in turn by a closed loop of
clients.  Lengths come in blocks: any ``block`` consecutive requests hold
the same set of prompt lengths and of ``max_new``, the quantiles of the
mix's clipped lognormals, spread evenly (a long prompt between short
ones: the bit-reversed order of the quantiles; ``max_new`` in a stride
that pairs them evenly).  The seed draws the token ids and the phase at
which the sequence starts.  So every seed sends the same work, long and
short requests as evenly mixed, in another order, and the spread between
seeds is the system's, not the dice's: with a shuffled order, runs of
one seed agreed within 1% and the 95th percentile of the first token's
time moved 13% from seed to seed (PERF.md).
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def batch_tokens(seed, step, batch, seq, vocab, device):
    """Token ids [batch, seq] of training step ``step`` (0-based)."""
    g = torch.Generator(device=device).manual_seed(
        ((int(seed) << 20) + int(step)) & _MASK63)
    return torch.randint(0, vocab, (batch, seq), generator=g, device=device)


def quantiles(spec, n):
    """The ``n`` mid-quantiles of a clipped lognormal spec
    ``{"median", "sigma", "min", "max"}``, as whole numbers."""
    nd = NormalDist()
    mu = math.log(spec["median"])
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = round(math.exp(mu + spec["sigma"] * z))
        out.append(int(min(max(v, spec["min"]), spec["max"])))
    return out


def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2)


class Requests:
    """The serving mix's request sequence: ``next()`` -> (prompt ids as an
    int32 array, max_new).  ``block`` is a power of two."""

    STRIDE = 13          # odd: a permutation of the block's positions

    def __init__(self, mix, seed, vocab):
        self.block = n = mix["block"]
        bits = n.bit_length() - 1
        if n != 1 << bits:
            raise ValueError(f"block {n} is not a power of two")
        p, m = quantiles(mix["prompt"], n), quantiles(mix["max_new"], n)
        self.order = [(p[_bitrev(k, bits)], m[(k * self.STRIDE) % n])
                      for k in range(n)]
        self.vocab = vocab
        self.rng = np.random.default_rng(int(seed))
        self.k = int(self.rng.integers(n))          # the seed's phase

    def next(self):
        plen, new = self.order[self.k % self.block]
        self.k += 1
        ids = self.rng.integers(0, self.vocab, plen, dtype=np.int32)
        return ids, new
