"""Deterministic, restart-safe, elastically-sharded data pipeline.  A copy
of ``repro.data.pipeline`` (numpy only), kept in the port so the port
imports nothing of the JAX package: the same Philox streams give the same
batches, bit for bit.

Every batch is a pure function of (seed, step) — no iterator state to
checkpoint, so restart/resume is exact (tests assert bit-equality) and
elastic rescaling only changes which *slice* of the global batch each
data-parallel rank materializes.  A byte-level tokenizer + packed text
corpus path feeds the runnable examples; the synthetic stream feeds
benchmarks and large-scale runs.  Batches are numpy arrays; the training
loop moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def synthetic_batch(cfg, B: int, S: int, seed: int, step: int,
                    rank: int = 0, world: int = 1):
    """Global-batch slice for this rank: rows [rank*B/world, ...)."""
    assert B % world == 0
    b_local = B // world
    out = {}
    rows = []
    for r in range(rank * b_local, (rank + 1) * b_local):
        rng = np.random.Generator(np.random.Philox(key=seed,
                                                   counter=[0, 0, step, r]))
        rows.append(rng)
    if cfg.frontend == "audio":
        out["features"] = np.stack([r.standard_normal(
            (S, cfg.frontend_dim), dtype=np.float32) for r in rows])
        out["labels"] = np.stack([r.integers(0, cfg.vocab, S).astype(np.int32)
                                  for r in rows])
        out["mask"] = np.stack([(r.random(S) < 0.3).astype(np.float32)
                                for r in rows])
    elif cfg.frontend == "vision":
        nv = cfg.n_vision_tokens
        out["tokens"] = np.stack([r.integers(0, cfg.vocab, S - nv)
                                  .astype(np.int32) for r in rows])
        out["vision"] = np.stack([r.standard_normal(
            (nv, cfg.d_model), dtype=np.float32) for r in rows])
    else:
        # markovian-ish synthetic tokens (learnable structure, not uniform)
        toks = []
        for r in rows:
            base = r.integers(0, cfg.vocab, S // 8 + 1).astype(np.int32)
            t = np.repeat(base, 8)[:S]                 # local repetition
            noise = r.integers(0, cfg.vocab, S).astype(np.int32)
            m = r.random(S) < 0.15
            toks.append(np.where(m, noise, t))
        out["tokens"] = np.stack(toks)
    return out


class ByteTokenizer:
    vocab_size = 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", "replace")


@dataclasses.dataclass
class DataPipeline:
    """step -> batch; stateless beyond (seed, corpus)."""

    cfg: object
    batch: int
    seq: int
    seed: int = 0
    rank: int = 0
    world: int = 1
    corpus: np.ndarray | None = None       # packed token stream (optional)

    @staticmethod
    def from_text(cfg, text: str, batch: int, seq: int, **kw):
        toks = ByteTokenizer().encode(text) % cfg.vocab
        return DataPipeline(cfg, batch, seq, corpus=toks, **kw)

    def __call__(self, step: int) -> dict:
        if self.corpus is None:
            return synthetic_batch(self.cfg, self.batch, self.seq, self.seed,
                                   step, self.rank, self.world)
        # packed contiguous windows, deterministic stride per step+row
        n = len(self.corpus) - self.seq - 1
        b_local = self.batch // self.world
        rows = []
        for r in range(self.rank * b_local, (self.rank + 1) * b_local):
            off = (step * self.batch + r) * 977 % max(n, 1)
            rows.append(self.corpus[off:off + self.seq])
        return {"tokens": np.stack(rows).astype(np.int32)}
