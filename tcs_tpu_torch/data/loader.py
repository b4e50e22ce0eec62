"""Batched, prefetching sequence loader with data-parallel sharding (the
port's copy of ``tcs_tpu/data/loader.py``; reference ``stereo_datasets.py:
722-736``, a torch DataLoader with a DistributedSampler).

Per epoch a permutation from ``default_rng((seed, epoch))``, padded so that
every shard has the same length, split ``shard_id::num_shards``; batches of
``batch_size`` with the last partial batch dropped. Each sample is augmented
with its own ``default_rng((seed, epoch, index))``, so a run gives the same
batches in the same order for any ``num_workers`` and however the workers
are scheduled, and a resumed run continues with the batches an
uninterrupted one would have had: :meth:`SequenceLoader.stream` starts at
any batch of any epoch. Iterating the loader gives one epoch, the one
:meth:`SequenceLoader.set_epoch` names (``tcs_tpu``'s interface).

Decoding and augmenting run in ``num_workers`` worker processes, started
with ``spawn`` (a process that has started CUDA or threads must not fork)
and kept for the loader's life; ``num_workers=0`` loads in a thread of this
process instead. A worker hands a sample over in a block of shared memory
and only the block's name goes through the pipe, so this process does not
unpickle the arrays; a thread of it stacks each batch straight from the
blocks. A sliding window keeps ``prefetch`` batches' samples in flight and
the batches come out strictly in order; :meth:`SequenceLoader.stream` keeps
the window full across the ends of epochs. A worker's error reaches the
consumer as the exception it raised. Processes rather than threads: the
training step is bound by the one Python thread that launches its kernels,
and numpy's Python-level glue around the host core takes the GIL from it
(PERF.md, Findings, PR 6).

This module imports numpy only, since each worker imports it; the batches
are numpy dicts with the fields of ``train.SequenceBatch`` plus ``"index"``,
the global sample indices. With ``pin_memory`` the thread stacks the fields
into torch tensors in page-locked memory instead, so that the thread which
launches the step only queues their copy to the card
(``SequenceBatch.from_loader``).
"""

from __future__ import annotations

import itertools
import multiprocessing
import queue
import signal
import threading
from collections import deque
from concurrent.futures import Future, ProcessPoolExecutor
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_worker_dataset = None  # a worker process's copy of the dataset


def _init_worker(dataset) -> None:
    global _worker_dataset
    _worker_dataset = dataset
    # A signal to the whole process group (a job scheduler's preemption,
    # Ctrl-C) must not kill the workers under the consumer before it has
    # checkpointed: the consumer shuts them down itself.
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)


def load_one(dataset, seed: int, epoch: int, index: int) -> Dict[str, np.ndarray]:
    """Sample ``index`` of ``epoch``, augmented with its own draws."""
    rng = np.random.default_rng((seed, epoch, int(index)))
    return dataset.load_sample(int(index), rng)


def _load_in_worker(seed: int, epoch: int, index: int):
    """A sample in a new block of shared memory: (block name, layout). Only
    these few bytes go back through the pipe; the consumer copies the arrays
    straight into its batch and unlinks the block."""
    sample = {k: np.asarray(v) for k, v in load_one(_worker_dataset, seed, epoch, index).items()}
    block = shared_memory.SharedMemory(create=True,
                                       size=max(1, sum(a.nbytes for a in sample.values())))
    # The consumer unlinks the block, so this process's tracker must not.
    resource_tracker.unregister(block._name, "shared_memory")
    layout, offset = [], 0
    for k, a in sample.items():
        dst = np.ndarray(a.shape, a.dtype, buffer=block.buf, offset=offset)
        dst[...] = a
        del dst
        layout.append((k, a.shape, a.dtype.str, offset))
        offset += a.nbytes
    block.close()
    return block.name, layout


def _stack(arrays, pin: bool):
    if not pin:
        return np.stack(arrays)
    import torch  # in the consumer's process, which has it; workers never collate

    out = torch.empty((len(arrays), *arrays[0].shape),
                      dtype=torch.from_numpy(np.empty(0, arrays[0].dtype)).dtype,
                      pin_memory=True)
    np.stack(arrays, out=out.numpy())
    return out


def _collate(results, pin: bool = False) -> Dict[str, np.ndarray]:
    """Stack the samples (dicts, or shared-memory blocks from the workers)
    into one batch, in pinned tensors if ``pin``, and free the blocks."""
    blocks = []
    try:
        samples = []
        for r in results:
            if isinstance(r, dict):
                samples.append(r)
                continue
            name, layout = r
            blocks.append(shared_memory.SharedMemory(name=name))
            samples.append({k: np.ndarray(shape, dtype, buffer=blocks[-1].buf, offset=off)
                            for k, shape, dtype, off in layout})
        batch = {k: _stack([s[k] for s in samples], pin) for k in samples[0]}
        del samples
        return batch
    finally:
        _free(blocks)


def _free(blocks) -> None:
    for block in blocks:
        block.unlink()
        try:
            block.close()
        except BufferError:  # a view outlived an error; the mapping goes with it
            pass


def _discard(futures) -> None:
    """Cancel what has not started; free the blocks of what has."""
    for f in futures:
        if f.cancel():
            continue
        try:
            r = f.result()
        except Exception:  # the error of a batch nobody will read
            continue
        if not isinstance(r, dict):
            _free([shared_memory.SharedMemory(name=r[0])])


class SequenceLoader:
    def __init__(self, dataset, batch_size: int, seed: int = 1234, shard_id: int = 0,
                 num_shards: int = 1, num_workers: int = 2, prefetch: int = 4,
                 pin_memory: bool = False):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0
        self._pool: Optional[ProcessPoolExecutor] = None

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for ``epoch`` (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(n)
        # pad so every shard sees the same number of samples
        per_shard = -(-n // self.num_shards)
        padded = np.concatenate([perm, perm[: per_shard * self.num_shards - n]])
        return padded[self.shard_id:: self.num_shards]

    def __len__(self):
        return -(-len(self.dataset) // self.num_shards) // self.batch_size

    def batch_indices(self, epoch: Optional[int] = None):
        """The global sample indices of each batch of ``epoch`` (the current
        one by default)."""
        indices = self._epoch_indices(self.epoch if epoch is None else epoch)
        return [indices[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _plan(self, epoch: int, start_batch: int):
        """(epoch, batch, indices) from batch ``start_batch`` of ``epoch`` on,
        epoch after epoch."""
        while True:
            batches = self.batch_indices(epoch)
            for k in range(start_batch, len(batches)):
                yield epoch, k, batches[k]
            epoch, start_batch = epoch + 1, 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of the current epoch."""
        batches = self.stream(self.epoch)
        try:
            for _ in range(len(self)):
                yield next(batches)[2]
        finally:
            batches.close()

    def stream(self, epoch: int, start_batch: int = 0
               ) -> Iterator[Tuple[int, int, Dict[str, np.ndarray]]]:
        """(epoch, batch number, batch) from batch ``start_batch`` of
        ``epoch`` on, through the epochs after it, with the prefetch window
        kept full across their ends (an epoch of a few batches would
        otherwise wait for the whole window at each). A ``start_batch`` of
        ``len(self)`` starts at the next epoch."""
        if len(self) == 0:
            raise ValueError(f"{len(self.dataset)} samples make no batch of {self.batch_size}")
        if not 0 <= start_batch <= len(self):
            raise ValueError(f"batch {start_batch} of an epoch of {len(self)}")
        return self._run(self._plan(epoch, start_batch))

    def _submit(self, epoch: int, index) -> Future:
        if self.num_workers == 0:
            fut: Future = Future()
            try:
                fut.set_result(load_one(self.dataset, self.seed, epoch, index))
            except Exception as e:  # raised to the consumer in order, as a worker's
                fut.set_exception(e)
            return fut
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
        return self._pool.submit(_load_in_worker, self.seed, epoch, int(index))

    def _run(self, plan):
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            window: deque = deque()
            try:
                todo = iter(plan)
                while not stop.is_set():
                    for epoch, k, idx in itertools.islice(todo, self.prefetch + 1 - len(window)):
                        window.append((epoch, k, idx, [self._submit(epoch, i) for i in idx]))
                    if not window:
                        break
                    epoch, k, idx, futures = window[0]
                    results = [f.result() for f in futures]  # on an error, finally frees them
                    window.popleft()
                    batch = _collate(results, self.pin_memory)
                    batch["index"] = np.asarray(idx, np.int64)
                    if not put((epoch, k, batch)):
                        return
            except Exception as e:  # a worker's error, raised by the consumer
                put(e)
            finally:
                for *_, futures in window:
                    _discard(futures)
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()

    def close(self) -> None:
        """Stop the worker processes."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "SequenceLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
