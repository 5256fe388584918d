"""Threaded data loader: the host pipeline -> padded numpy batches.

Port of `pillarnet_lts_tpu/datasets/loader/build_loader.py`. A pool of
threads runs the numpy pipeline and collates (`collate_batch`), up to
`prefetch` batches ahead of the consumer; a failed sample raises in the
consumer rather than stalling it. Two changes: batches come out in their
order, whatever thread finished first (the JAX package yields them as
they finish), and before each pass the loader gives a dataset with
`set_seed` its seed plus the epoch, from which each sample's own draws
are made (`PointCloudDataset.sample_rng`). The order of a pass: indices
shuffled by `np.random.RandomState(seed + epoch)` when `shuffle`, split
`num_shards` ways (one process by default; striped, as the JAX loader
stripes its hosts), then cut into batches, the last short one dropped
when `drop_last`. With `block=(i, n)` the indices are cut into batches of
`n * batch_size` and the loader yields block i of each, `batch_size`
rows: one of n ranks that share a batch (a node's ranks, which split its
batch contiguously as the JAX mesh splits a host's).
"""

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..collate import collate_batch


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, num_workers=2,
                 max_points=None, seed=0, drop_last=True, num_shards=1,
                 shard_index=0, block=(0, 1), prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.max_points = max_points
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.block = block
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.num_shards > 1:
            # equal shards: wrap around to pad, then stripe
            per = -(-len(idx) // self.num_shards)
            idx = np.concatenate([idx, idx[:per * self.num_shards - len(idx)]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __len__(self):
        n, size = len(self._indices()), self.batch_size * self.block[1]
        return n // size if self.drop_last else -(-n // size)

    def batches(self):
        """The pass's batches as dataset indices."""
        idx = self._indices()
        i, n = self.block
        size = self.batch_size * n
        return [idx[b * size:(b + 1) * size][
            i * self.batch_size:(i + 1) * self.batch_size]
            for b in range(len(self))]

    def _batch(self, sel):
        return collate_batch([self.dataset[int(i)] for i in sel],
                             self.max_points)

    def __iter__(self):
        set_seed = getattr(self.dataset, "set_seed", None)
        if set_seed is not None:
            set_seed(self.seed + self.epoch)
        batches = self.batches()
        pool = ThreadPoolExecutor(self.num_workers)
        pending = deque()
        try:
            for sel in batches:
                pending.append(pool.submit(self._batch, sel))
                if len(pending) > self.prefetch:
                    yield _result(pending.popleft())
            while pending:
                yield _result(pending.popleft())
        finally:
            # an abandoned pass (a consumer that breaks out early) leaves
            # no thread behind
            for f in pending:
                f.cancel()
            pool.shutdown(wait=True)


def _result(future):
    try:
        return future.result()
    except Exception as e:
        raise RuntimeError("data loader worker failed") from e

