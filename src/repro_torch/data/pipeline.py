"""Host-side data pipeline: sharded, deterministic, prefetching.

The port of `repro/data/pipeline.py`. The paper's streaming model means
the pipeline is stateless given (seed, step): every machine/process draws
its own shard of the global minibatch by folding (step, shard_index) into
the key (the port's threefry keys, `prng.py`, so the keys are JAX's) —
restarts and elastic re-sharding need no pipeline state.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

from repro_torch import prng


class ShardedBatcher:
    """Deterministic per-step global batches, optionally restricted to this
    process's shard (for multi-host data loading)."""

    def __init__(self, sample_fn: Callable, global_batch: int,
                 n_shards: int = 1, shard_index: int = 0, seed: int = 0):
        assert global_batch % n_shards == 0
        self.sample_fn = sample_fn          # (key, n) -> tree of tensors
        self.global_batch = global_batch
        self.n_shards = n_shards
        self.shard_index = shard_index
        self.seed = seed

    def batch_at(self, step: int):
        """The shard of the global batch for `step` (pure function)."""
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(self.seed), step),
                           self.shard_index)
        return self.sample_fn(key, self.global_batch // self.n_shards)

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Overlaps host batch construction with device compute (depth-bounded
    background thread)."""

    def __init__(self, iterator, depth: int = 2):
        self._it = iter(iterator)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class _Sentinel:
    pass


_SENTINEL = _Sentinel()
