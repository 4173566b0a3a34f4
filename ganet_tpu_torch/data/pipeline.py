"""Batching and prefetching: `BatchIterator`, a copy of the one in
`ganet_tpu/data/pipeline.py` that yields the same batches, with one
repair: its prefetch thread waits to put the end-of-epoch marker, where
the JAX package's drops it on a full queue and leaves a consumer slower
than the reads waiting forever.

A host-side numpy pipeline that (a) shards the sample index space by
process, so that each process reads only its slice of the global batch,
and (b) prefetches batches on a background thread, so that reading
overlaps the device's work.  It does not use `DataLoader` worker processes:
a training `StereoDataset` draws its random crops from one stateful
generator, in the order the samples are read, and crops made in workers
would differ from the JAX package's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch.distributed as dist


def process_coordinates() -> Tuple[int, int]:
    """(rank, world size) of `torch.distributed` when it is initialised,
    else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BatchIterator:
    """Iterates dict-of-array batches over a map-style dataset.

    Args:
      dataset: object with __len__ / __getitem__ -> dict[str, np.ndarray].
      batch_size: GLOBAL batch size; each process yields batch_size //
        process_count samples (the reference's --batchSize is global).
      shuffle: reshuffle each epoch (seeded, identical across processes).
      drop_remainder: drop the last partial batch; otherwise wrap-pad it
        from the epoch's first indices and zero the padding's valid masks.
      process_index/process_count: this process's coordinates (default:
        `process_coordinates()`).
      prefetch: number of batches to stage on a background thread (0: none).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        prefetch: int = 2,
    ):
        rank, world = process_coordinates()
        process_index = rank if process_index is None else process_index
        process_count = world if process_count is None else process_count
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by {process_count} hosts"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // process_count
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_remainder and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1000003 + epoch)
            rng.shuffle(idx)
        return idx

    def _assemble(self, indices) -> Dict[str, np.ndarray]:
        samples = [self.dataset[int(i)] for i in indices]
        return {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}

    def _batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices(epoch)
        for b in range(len(self)):
            global_slice = idx[b * self.batch_size : (b + 1) * self.batch_size]
            pad = 0
            if len(global_slice) < self.batch_size:
                if self.drop_remainder:
                    return
                # Wrap-pad the final partial batch.
                pad = self.batch_size - len(global_slice)
                global_slice = np.concatenate([global_slice, idx[:pad]])
            sl = slice(
                self.process_index * self.local_batch,
                (self.process_index + 1) * self.local_batch,
            )
            batch = self._assemble(global_slice[sl])
            if pad:
                # Zero the valid masks of the wrap-padded duplicates, so that
                # pixel-weighted evaluation does not count them twice.
                pad_flags = np.zeros(self.batch_size, bool)
                pad_flags[-pad:] = True
                local_flags = pad_flags[sl]
                for k in ("valid", "valid_right"):
                    if k in batch and local_flags.any():
                        batch[k] = batch[k] * (~local_flags[:, None, None]).astype(batch[k].dtype)
            yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # Advance the shuffle epoch up front, so that a consumer that breaks
        # out early (Trainer.fit at steps_per_epoch) still gets a fresh
        # permutation on the next pass.
        epoch = self.epoch
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._batches(epoch)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            # A bounded put that re-checks the stop flag, so that an
            # abandoned iterator cannot leave a thread blocked on a full
            # queue; False once the consumer has gone.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches(epoch):
                    if not put(batch):
                        return
            except BaseException as e:  # handed to the consumer, which raises it
                err.append(e)
            finally:
                put(sentinel)  # waits for room, unlike a `put_nowait`

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if err:
                raise err[0]
        finally:
            # Runs on completion and on GeneratorExit (the consumer broke out
            # or dropped the iterator): unblock and reap the producer.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
