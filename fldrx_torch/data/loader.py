"""Host-side training batches and test items with background prefetch
(counterpart of fldrx/data/loader.py): a thread pool decodes PNGs (the
native decoder and PIL release the GIL while decoding) while the card
computes.
"""

from __future__ import annotations

import queue
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np


class PrefetchLoader:
    """Wrap an index-based `fetch(i)` into a prefetching iterator that
    yields results in index order."""

    def __init__(self, fetch: Callable[[int], object], n_items: int,
                 num_threads: int = 8, prefetch: int = 3,
                 indices: Optional[list] = None):
        self.fetch = fetch
        self.indices = (list(indices) if indices is not None
                        else list(range(n_items)))
        self.num_threads = num_threads
        self.prefetch = prefetch

    def __len__(self):
        return len(self.indices)

    def __iter__(self) -> Iterator:
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        try:
            futures = queue.Queue()
            it = iter(self.indices)

            def submit_next():
                try:
                    i = next(it)
                except StopIteration:
                    return False
                futures.put(pool.submit(self.fetch, i))
                return True

            inflight = 0
            for _ in range(self.num_threads * self.prefetch):
                if submit_next():
                    inflight += 1
            while inflight:
                f = futures.get()
                inflight -= 1
                if submit_next():
                    inflight += 1
                yield f.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def _batch(frames, ts):
    fr = np.stack(frames, 0)                   # [B,3,H,W,C] (I0, I1, It)
    return {"frames": fr[:, :2], "target": fr[:, 2],
            "t": np.asarray(ts, np.float32).reshape(-1, 1)}


def train_batches(dataset, batch_size: int, seed: int, epoch: int,
                  num_threads: int = 8, drop_last: bool = True):
    """Shuffled, augmented training batches: yields dicts {frames
    [B,2,H,W,C], target [B,H,W,C], t [B,1]}. The order and each sample's
    augmentation depend only on (seed, epoch, index)."""
    order = list(range(len(dataset)))
    rng = random.Random(seed * 10007 + epoch)
    rng.shuffle(order)

    def fetch(i):
        r = random.Random(hash((seed, epoch, i)) & 0x7FFFFFFF)
        return dataset.sample(i, r)

    loader = PrefetchLoader(fetch, len(order), num_threads=num_threads,
                            indices=order)
    buf_frames, buf_t = [], []
    for frames, t in loader:
        buf_frames.append(frames)
        buf_t.append(t)
        if len(buf_frames) == batch_size:
            yield _batch(buf_frames, buf_t)
            buf_frames, buf_t = [], []
    if buf_frames and not drop_last:
        yield _batch(buf_frames, buf_t)


def test_samples(dataset, patch: int = -1, num_threads: int = 8,
                 raw: bool = False):
    """Prefetched test items in order: yields (frames [3,H,W,C], t, scene);
    raw=True yields uint8 frames, which the device normalises."""
    loader = PrefetchLoader(lambda i: dataset.load(i, patch, raw=raw),
                            len(dataset), num_threads=num_threads)
    return iter(loader)
