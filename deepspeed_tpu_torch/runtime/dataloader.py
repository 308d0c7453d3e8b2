"""Data loading: the batching loader, its repeat wrapper and the staged
prefetcher of the async step pipeline.

Port of ``deepspeed_tpu/runtime/dataloader.py`` (reference
``deepspeed/runtime/dataloader.py:17,41``). The JAX loader hands each
process its share of every global batch (``process_index`` /
``process_count``); the port's engine takes the global batch on every rank
and keeps its own rows (``DeepSpeedTPUEngine._local_rows``), so
``initialize`` builds the loader with one process: every rank loads the
same global batch in the same seeded order (ROADMAP Queue 3, divergence
51).

``PrefetchLoader`` runs one worker thread over the source, so the order
of what it yields is the source's. The engine's ``stage_fn`` puts the
rank's rows on the card from pinned memory on a side stream and returns a
``StagedBatch`` whose ``event`` the compute stream waits on before use.
"""

import queue
import threading
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.telemetry.tracer import get_tracer


class StagedBatch(NamedTuple):
    """A batch already on the engine's device, this rank's rows, stacked
    [gas, micro, ...]. ``event`` is the side stream's copy event (None on
    the CPU): ``train_batch`` makes the compute stream wait on it before
    the batch is read."""
    arrays: Dict[str, Any]
    event: Any = None


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of equally shaped nests of dicts, lists and
    tuples (a sample's structure)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


class PrefetchLoader:
    """Background-thread prefetch with a bounded ready-buffer (``depth=2`` is
    the classic double buffer).

    A single worker thread pulls items from ``source`` in order, optionally
    transforms them via ``stage_fn``, and parks up to ``depth`` ready
    items. Because exactly one worker consumes ``source`` sequentially,
    the yielded order is identical to iterating ``source`` directly. A
    ``stage_fn`` or ``source`` exception is re-raised at the consuming
    ``__next__``.
    """

    _DONE = object()

    def __init__(self, source, stage_fn: Optional[Callable] = None,
                 depth: int = 2):
        self._source = iter(source)
        self._stage_fn = stage_fn
        self._tracer = get_tracer()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._closed = threading.Event()   # set by close(), read by worker
        self._done = False
        self._thread = threading.Thread(
            target=self._worker, name="dstpu-prefetch", daemon=True)
        self._thread.start()

    def _worker(self):
        def _put(item) -> bool:
            # bounded-wait put so close() can always terminate the worker
            while not self._closed.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        tr = self._tracer
        try:
            while not self._closed.is_set():
                try:
                    with tr.span("prefetch/next", cat="data"):
                        item = next(self._source)
                except StopIteration:
                    break
                if self._stage_fn is not None:
                    with tr.span("prefetch/stage", cat="data"):
                        item = self._stage_fn(item)
                if not _put(item):   # blocks while `depth` batches are ready
                    return
            _put(self._DONE)
        except BaseException as e:   # surfaced at the consumer's __next__
            _put(e)
            # terminate the stream: a consumer that swallows the error and
            # keeps pulling gets StopIteration, never a permanent hang
            _put(self._DONE)

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if self._done:          # exhaustion is sticky: a drained stream
            raise StopIteration  # keeps raising instead of blocking forever
        item = self._q.get()
        if item is self._DONE:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        """Stop the worker and drop buffered batches (used when the engine
        switches data iterators or is reconfigured)."""
        self._closed.set()
        self._done = True
        while True:                  # unblock a producer stuck on put()
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


class RepeatingLoader:
    """reference: runtime/dataloader.py:17 — wrap an iterator to restart on
    StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedTPUDataLoader:
    """Minimal batching loader over an indexable dataset of samples (dicts,
    lists or tuples of arrays). The default collate stacks each leaf with
    numpy. Every rank loads the whole global batch (module docstring)."""

    def __init__(self, dataset: Sequence, batch_size: int,
                 collate_fn: Optional[Callable] = None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or self._default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    @staticmethod
    def _default_collate(samples):
        return tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *samples)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Any]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        n_full = len(order) // self.batch_size
        for b in range(n_full):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
        if len(order) % self.batch_size and not self.drop_last:
            # the final partial batch (a batch of another shape)
            tail = order[n_full * self.batch_size:]
            yield self.collate_fn([self.dataset[int(i)] for i in tail])
