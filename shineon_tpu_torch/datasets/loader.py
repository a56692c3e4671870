"""Host data loader: a shuffled, per-process-strided, prefetching iterator
of collated numpy batches (counterpart of shineon_tpu/datasets/loader.py;
reference models/base_model.py:111-146).

The index order is the JAX package's: a ``RandomState(seed + epoch)``
shuffle, padded by wrapping to a multiple of ``process_count``, strided by
``process_index``, cut into batches (the ragged last one dropped with
``drop_last``) and capped by ``limit_batches`` (a float <= 1 is a fraction
of the batches, anything else a count). With ``workers`` > 0 a thread pool
decodes the samples (PIL releases the interpreter lock while it decodes)
and a queue of ``prefetch`` batches runs ahead of the consumer. Batches
stay numpy; the trainer moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np


def collate(samples: List[Dict]) -> Dict:
    """Stack numpy leaves on a leading batch axis; anything else is listed."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, str):
            out[key] = vals
        elif isinstance(first, np.ndarray) and first.dtype.kind in "USO":
            out[key] = [list(v) for v in vals] if first.ndim else vals
        elif isinstance(first, (np.ndarray, np.floating, np.integer, float, int)):
            out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Map-style dataset -> iterator of collated numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 420,
                 workers: int = 0, drop_last: bool = True, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 2,
                 limit_batches: Optional[float] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.workers = workers
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.limit_batches = limit_batches
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for ``epoch`` (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        # pad so that every process sees as many samples, then stride
        total = -(-n // self.process_count) * self.process_count
        if total > n:
            order = np.concatenate([order, order[: total - n]])
        return order[self.process_index::self.process_count]

    def _num_batches(self, samples: int) -> int:
        return samples // self.batch_size if self.drop_last else -(-samples // self.batch_size)

    def __len__(self) -> int:
        nb = self._num_batches(-(-len(self.dataset) // self.process_count))
        if self.limit_batches is not None:
            if isinstance(self.limit_batches, float) and self.limit_batches <= 1.0:
                nb = max(1, int(nb * self.limit_batches))
            else:
                nb = min(nb, int(self.limit_batches))
        return nb

    def batch_indices(self) -> List[np.ndarray]:
        """The dataset indices of each batch of this epoch, in order."""
        idx = self._indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self._num_batches(len(idx)))]
        return batches[: len(self)]

    def __iter__(self) -> Iterator[Dict]:
        batches = self.batch_indices()
        if self.workers <= 0:
            for batch_idx in batches:
                yield collate([self.dataset[int(i)] for i in batch_idx])
            return
        yield from self._threaded(batches)

    def _threaded(self, batches: List[np.ndarray]) -> Iterator[Dict]:
        """Decode in a pool of ``workers`` threads; a producer thread keeps
        up to ``prefetch`` batches queued. A decode error reaches the
        consumer and raises there; a consumer that stops early stops the
        producer."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    for batch_idx in batches:
                        samples = list(pool.map(self.dataset.__getitem__, map(int, batch_idx)))
                        if not put(collate(samples)):
                            return
            except BaseException as exc:  # handed to the consumer, which raises it
                put(exc)
                return
            put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)
