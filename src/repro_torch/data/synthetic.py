"""Deterministic synthetic LM data pipeline (numpy only).

The reference's ``data/synthetic.py``, kept verbatim in its arithmetic:
`batch_at` and `Stream` give the reference's batches bit for bit.

A hash-based token stream (splitmix-style) with a learnable structure:
token t+1 depends on token t through a fixed random permutation mixed
with noise, so a real model shows decreasing loss — useful for the
end-to-end training example, where "loss goes down" is the check.

Properties needed at scale and provided here:

* **deterministic + seekable** — batch `i` is a pure function of
  (seed, i), so a restart resumes the stream exactly at the checkpoint
  step with no data replay or skew;
* **host-sharded** — each host materializes only its slice of the
  global batch (`host_slice`); the slices concatenate to the global
  batch;
* **packed** — documents are length-`seq+1` windows; `tokens`/`labels`
  are the usual shift-by-one views.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    structure: float = 0.8     # P(next token = perm[cur]) vs uniform


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _perm(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 7)
    return rng.permutation(cfg.vocab)


def batch_at(cfg: DataConfig, index: int,
             host_slice: slice | None = None) -> dict:
    """The `index`-th global batch (or one host's slice of it)."""
    sl = host_slice or slice(0, cfg.global_batch)
    rows = np.arange(sl.start, sl.stop, dtype=np.uint64)
    perm = _perm(cfg)
    n = cfg.seq_len + 1
    base = (np.uint64(index) * np.uint64(cfg.global_batch * 131)
            + rows * np.uint64(1313) + np.uint64(cfg.seed) << np.uint64(20))
    toks = np.empty((len(rows), n), np.int64)
    toks[:, 0] = (_splitmix(base) % np.uint64(cfg.vocab)).astype(np.int64)
    for t in range(1, n):
        h = _splitmix(base + np.uint64(t))
        coin = (h & np.uint64(0xFFFF)).astype(np.float64) / 65535.0
        rnd = ((h >> np.uint64(16)) % np.uint64(cfg.vocab)).astype(np.int64)
        follow = perm[toks[:, t - 1]]
        toks[:, t] = np.where(coin < cfg.structure, follow, rnd)
    return dict(tokens=toks[:, :-1].astype(np.int32),
                labels=toks[:, 1:].astype(np.int32))


class Stream:
    """Seekable iterator over batches (resume with `seek`)."""

    def __init__(self, cfg: DataConfig, host_slice: slice | None = None,
                 start: int = 0):
        self.cfg = cfg
        self.host_slice = host_slice
        self.index = start

    def seek(self, index: int):
        self.index = index

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = batch_at(self.cfg, self.index, self.host_slice)
        self.index += 1
        return b
