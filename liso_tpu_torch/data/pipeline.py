"""Host input pipeline: prefetch of collated batches, and their move to the
card (port of liso_tpu/data/pipeline.py).

Worker FORK-processes (default once samples are large, GIL-free like the
reference's DataLoader workers) or a thread pool assemble HostSamples; a
background thread collates them (numpy only) and keeps a small queue of
batches; shuffling and epoch handling live here. Fork workers start after
CUDA may be initialised, so they run the dataset's numpy code only: they
never touch `torch.cuda` or create a tensor.

With `device` given, every array of a batch becomes a tensor: the producer
thread copies it into pinned host memory, and the consuming thread (the one
iterating) enqueues the copy to the card with `non_blocking=True` on its
own current stream, so the kernels it launches next are ordered after the
copy. Without `device` the batches stay numpy, as the JAX pipeline gives
them without `device_put`.

Spans and counters (`utils/trace.py`): the consumer's `data.wait` around
each take from the queue, `data.batches` for each batch taken and
`data.queue_empty` for each found missing when asked for (0 or 1 a batch);
the producer's `data.produce` around each batch's assembly (worker map,
collate, pin).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from functools import partial
from typing import Iterator, Optional

import numpy as np
import torch

from liso_tpu_torch.data.dataset import LidarDataset, collate
from liso_tpu_torch.utils import trace

_WORKER_DS: Optional[LidarDataset] = None


def _init_worker(ds):
    global _WORKER_DS
    _WORKER_DS = ds
    # no PID reseeding: per-sample randomness is a pure function of (seed,
    # epoch, idx) via LidarDataset.index_rng, so every worker builds
    # identical samples regardless of assignment


def _worker_get(idx: int, epoch: int = 0):
    _WORKER_DS.epoch = epoch
    return _WORKER_DS[int(idx)]


def _map_arrays(tree, fn):
    """`fn` applied to every array leaf of a collated batch (nested dicts;
    lists such as sample_id are kept as they are)."""
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


class _Failure:
    """An exception raised in the producer thread, re-raised by the
    consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    def __init__(
        self,
        dataset: LidarDataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        device=None,
        drop_last: bool = True,
        use_processes: Optional[bool] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        if use_processes is None:
            # fork workers pay off once sample assembly dominates; tiny
            # test datasets stay on threads
            use_processes = num_workers > 1 and getattr(
                dataset.cfg, "n_max", 0
            ) >= 16384
        self.use_processes = use_processes
        if use_processes:
            self.pool = ProcessPoolExecutor(
                max_workers=max(num_workers, 1),
                mp_context=mp.get_context("fork"),
                initializer=_init_worker,
                initargs=(dataset,),
            )
        else:
            self.pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        self.prefetch = prefetch
        self.device = torch.device(device) if device is not None else None
        self.drop_last = drop_last
        self._epoch = 0  # bumped per __iter__: varies augmentations

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _host_batch(self, batch):
        """The producer's side: numpy batch -> host tensors, pinned when
        they are bound for the card."""
        if self.device is None:
            return batch
        pin = self.device.type == "cuda"
        return _map_arrays(batch, lambda a: torch.from_numpy(a).pin_memory()
                           if pin else torch.from_numpy(a))

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        epoch = self._epoch
        self._epoch += 1

        def produce():
            try:
                idx = self._epoch_indices()
                bs = self.batch_size
                n_full = (len(idx) // bs if self.drop_last
                          else -(-len(idx) // bs))
                self.dataset.epoch = epoch  # thread pools share the dataset
                for b in range(n_full):
                    if stop.is_set():
                        return
                    chunk = idx[b * bs: (b + 1) * bs]
                    with trace.span("data.produce"):
                        if self.use_processes:
                            samples = list(self.pool.map(
                                partial(_worker_get, epoch=epoch), chunk))
                        else:
                            samples = list(
                                self.pool.map(self.dataset.__getitem__, chunk))
                        batch = self._host_batch(collate(samples))
                    q.put(batch)
                q.put(None)
            except BaseException as e:  # handed to the consumer
                q.put(_Failure(e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                empty = q.empty()
                with trace.span("data.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                # counted at every batch, 0 or 1, so the two counters'
                # rings hold the same recent batches
                trace.count("data.batches")
                trace.count("data.queue_empty", empty)
                if self.device is not None:
                    item = _map_arrays(item, lambda x: x.to(
                        self.device, non_blocking=True))
                yield item
        finally:
            # unblock a producer waiting on the full queue, and wait for it
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()

    def close(self):
        """Stop the worker pool (its processes or threads)."""
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
