"""Deterministic, host-sharded, seekable token pipeline (the port's own
copy of ``repro.data.pipeline``, numpy only).

Production shape: a corpus is a set of binary shards of int32 tokens; each
host reads only its shard slice (``host_id``/``num_hosts``), batches are
cut deterministically from a counter so that (a) every host produces the
same global batch layout without communication, and (b) restart-from-step-k
is exact — the pipeline is a pure function of (config, step), the property
fault tolerance needs (no data-order drift after preemption).

Without a corpus on disk, a seeded synthetic stream provides the same
interface (and the same seekability) for smoke tests and CPU examples.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    corpus_dir: Optional[str] = None     # None => synthetic stream
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def write_synthetic_corpus(path: str, *, vocab_size: int, n_tokens: int,
                           n_shards: int = 4, seed: int = 7) -> None:
    """Materialize a reproducible binary corpus (one .bin per shard)."""
    d = pathlib.Path(path)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = n_tokens // n_shards
    # a Markov-ish stream so models have something learnable
    trans = rng.integers(0, vocab_size, (vocab_size,), dtype=np.int32)
    for s in range(n_shards):
        toks = np.empty((per,), np.int32)
        t = rng.integers(0, vocab_size)
        for i in range(per):
            t = trans[t] if rng.random() < 0.7 else rng.integers(0, vocab_size)
            toks[i] = t
        (d / f"shard_{s:05d}.bin").write_bytes(toks.tobytes())


class ShardedTokenPipeline:
    """Deterministic batches: ``batch_at(step)`` is pure in (config, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._tokens: Optional[np.ndarray] = None
        if cfg.corpus_dir is not None:
            shards = sorted(pathlib.Path(cfg.corpus_dir).glob("shard_*.bin"))
            if not shards:
                raise FileNotFoundError(f"no shards under {cfg.corpus_dir}")
            mine = shards[cfg.host_id::cfg.num_hosts]
            self._tokens = np.concatenate([
                np.frombuffer(p.read_bytes(), np.int32) for p in mine])

    # ------------------------------------------------------------ access
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The host's slice of global batch ``step`` (tokens + labels)."""
        cfg = self.cfg
        B, S = cfg.host_batch, cfg.seq_len
        if self._tokens is None:
            rng = np.random.default_rng(
                (cfg.seed, step, cfg.host_id))
            toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        else:
            n = len(self._tokens) - (S + 1)
            rng = np.random.default_rng((cfg.seed, step))
            starts = rng.integers(0, n, (cfg.global_batch,))
            mine = starts[cfg.host_id * B:(cfg.host_id + 1) * B]
            toks = np.stack([self._tokens[s:s + S + 1] for s in mine])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
