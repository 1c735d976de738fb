"""Deterministic, shardable synthetic token pipeline (the port's own copy
of ``repro.data.pipeline``, numpy only; the port imports nothing of
``repro``).

Design requirements at scale:
  * step-keyed determinism — batch(step) is a pure function of (seed, step),
    so restart-after-failure replays identical data with no state to
    checkpoint beyond the step counter;
  * host-sharded loading — each data-parallel host materializes only its
    slice (``dp_rank``/``dp_size``), never the global batch;
  * background prefetch — a depth-2 thread queue overlaps host generation
    with device compute.

The token distribution is a Zipf mixture with Markov bigram structure so the
CE loss is learnable (the crash-resume tests check bit-exact resume on it,
and ``examples/train_lm.py`` shows the loss going down). Batches are
bitwise the reference's for the same arguments.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    batch: int                 # GLOBAL batch
    seq: int
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1
    zipf_a: float = 1.3

    @property
    def local_batch(self) -> int:
        assert self.batch % self.dp_size == 0
        return self.batch // self.dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, dp_rank): the local batch shard."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.dp_rank]))
        B, S, V = self.local_batch, self.seq, self.vocab
        # zipf-ish marginal
        base = rng.zipf(self.zipf_a, size=(B, S)).astype(np.int64)
        base = (base - 1) % max(V - 2, 1)
        # inject learnable bigram structure: even positions predict t+1
        tokens = base.copy()
        tokens[:, 1::2] = (tokens[:, 0::2][:, : tokens[:, 1::2].shape[1]]
                           * 31 + 7) % max(V - 2, 1)
        return {"tokens": tokens.astype(np.int32), "step": step}


def make_batch_iterator(pipe: TokenPipeline, start_step: int = 0,
                        prefetch: int = 2,
                        stop_step: Optional[int] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Background-prefetched iterator starting at ``start_step`` (resume)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    sentinel = object()

    def producer():
        step = start_step
        while stop_step is None or step < stop_step:
            q.put(pipe.batch_at(step))
            step += 1
        q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
