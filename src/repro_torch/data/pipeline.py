"""Tokenized data pipeline: deterministic, shardable, restartable.

A copy of the reference's ``repro.data.pipeline`` (numpy only), so that
the port reads no module of the reference: the same (seed, step, host)
gives bitwise the same batch in both packages.

Two sources behind one interface:
  * ``SyntheticLM``   — seeded synthetic token stream (zipfian unigram with
    a short markov flavor) for examples/benchmarks: infinite, reproducible.
  * ``PackedFile``    — memory-mapped flat token file (np.uint16/32) packed
    into fixed-length rows.

Determinism/fault-tolerance contract (what large-scale training needs):
  * batch(step, host) is a pure function — restart at step k replays the
    exact stream without reading the first k batches (skip-to-step);
  * host sharding by row index: host h of H reads rows r with r % H == h;
  * per-batch PRNG derived from (seed, step) only.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataCfg:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Seeded synthetic LM stream with non-trivial statistics.

    Tokens follow a zipfian unigram mixed with a position-local structure
    (repeated motifs) so that a model can actually reduce loss on it —
    useful for the train-for-a-few-hundred-steps example.
    """

    def __init__(self, cfg: DataCfg):
        self.cfg = cfg
        # fixed zipf table
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        # detlint: ok[DET001] host-side numpy f64 dataset init, never on the
        # device (reference data/pipeline.py:52)
        self._p = (p / p.sum()).astype(np.float64)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s = cfg.host_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(b, s), p=self._p)
        # motif structure: copy a shifted window with prob 1/4 per row
        copy_rows = rng.random(b) < 0.25
        if s >= 64:
            src = toks[:, : s // 2]
            toks[copy_rows, s // 2: s // 2 + src.shape[1]] = src[copy_rows]
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class PackedFile:
    """Flat token file -> fixed-length rows, host-sharded, step-addressed."""

    def __init__(self, path: str, cfg: DataCfg, dtype=np.uint16):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=dtype, mode="r")
        self.rows = len(self._data) // cfg.seq_len

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        # deterministic row addressing: global row ids for this (step, host)
        base = step * cfg.global_batch + cfg.host_id * b
        idx = (base + np.arange(b)) % self.rows
        rows = np.stack([self._data[i * s:(i + 1) * s] for i in idx])
        return {"tokens": rows.astype(np.int32)}


def make_source(cfg: DataCfg, path: Optional[str] = None):
    if path:
        return PackedFile(path, cfg)
    return SyntheticLM(cfg)
