"""Batching data loader with background prefetch (counterpart of
``qaig_tpu/data/loader.py``).

A worker thread puts numpy batches into a small queue (``prefetch``
batches ahead) so the card never waits on file reads; the caller moves
each batch to its device.  A dataset with a ``load_batch(indices,
num_threads)`` method (``ImageDataset`` and ``FeatureMapDataset``: the
data plane's native batch loaders) gives each batch in one call, over
``num_workers`` threads; where it returns ``None``, or the dataset has
none, the items fan out over ``num_workers`` threads (``np.load`` and the
native decoder release the GIL) and are stacked.

The order is the JAX package's: with ``shuffle``, one
``np.random.default_rng(seed)`` permutation per epoch; with
``drop_remainder`` (the default) the last partial batch is dropped, else
it is the last batch.  The same seed gives the same batches.  Items that
are tuples, such as ``(image, path)``, batch column by column: arrays are
stacked, anything else is listed.

``batch_size`` is the global batch.  Under data parallelism every rank
draws the same order and yields only its contiguous ``batch_size /
process_count`` slice of each batch: ``process_index`` is the rank's data
coordinate, so the ranks that share it (tensor- or pipeline-parallel
peers) load the same rows.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _stack(samples):
    if isinstance(samples[0], (tuple, list)):
        return tuple(np.stack(c) if isinstance(c[0], np.ndarray) else list(c)
                     for c in zip(*samples))
    return np.stack(samples)


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_remainder=True, prefetch=2, process_index=0,
                 process_count=1, num_workers=4):
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch            # batches read ahead
        self.num_workers = num_workers      # threads a batch's reads use
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        if self.drop_remainder:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        limit = (len(self) * self.batch_size if self.drop_remainder
                 else len(order))
        per_proc = self.batch_size // self.process_count
        for start in range(0, limit, self.batch_size):
            batch = order[start:start + self.batch_size]
            if self.process_count > 1:
                lo = self.process_index * per_proc
                batch = batch[lo:lo + per_proc]
            yield batch

    def __iter__(self):
        """Iterate over batches (numpy arrays, or tuples of columns), read
        ahead by a worker thread; an abandoned iterator releases the
        worker."""
        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        load_batch = getattr(self.dataset, "load_batch", None)

        def fetch(idx_batch):
            indices = [int(i) for i in idx_batch]
            if load_batch is not None:
                batch = load_batch(indices, num_threads=self.num_workers)
                if batch is not None:
                    return batch
            return _stack(list(pool.map(self.dataset.__getitem__, indices)))

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idx_batch in self._batch_indices():
                    if stop.is_set() or not put(fetch(idx_batch)):
                        return
            except BaseException as e:  # raised on the consumer side
                error.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)
