"""Host-side batch loader, the card-resident corpus, and prefetch to the card.

Counterpart of `hybrid_diffusion_tpu/data/pipeline.py` (:25-282):

  - `BatchLoader`: worker threads decode and resize on the host while the
    card computes; batches are uint8 NHWC numpy (1 byte a pixel on the
    wire); `RandomState(seed + epoch)` shuffles as the JAX loader does, so
    both packages give the same batches in the same order;
  - `shard_for_host`: the contiguous per-rank slice of the index space
    (rank and world size from `torch.distributed` when it is initialized;
    the port's loops run in one process, so nothing calls it yet);
  - `DeviceBatchLoader`: the whole corpus on the card as uint8 tensors,
    each batch gathered there by an index tensor (the epoch's shuffled
    indices are copied to the card once an epoch, not once a step);
  - `device_prefetch`: pinned host buffers copied `non_blocking` on a side
    CUDA stream, `depth` batches ahead, each with an event that the compute
    stream waits on before it reads the batch;
  - `interleave`: round-robin over several loaders.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch


def shard_for_host(
    indices: np.ndarray,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> np.ndarray:
    """Contiguous per-rank shard of the (shuffled) index space."""
    if process_count is None:
        dist = torch.distributed
        initialized = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if initialized else 0
        process_count = dist.get_world_size() if initialized else 1
    per = len(indices) // process_count
    if per == 0:
        raise ValueError(
            f"shard_for_host: {len(indices)} example(s) cannot be sharded "
            f"over {process_count} ranks (need at least one per rank). "
            f"For tiny eval/val splits, enlarge the split or evaluate on "
            f"fewer ranks")
    return indices[process_index * per : (process_index + 1) * per]


def epoch_indices(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    """The epoch's index order: arange(n), shuffled by RandomState(seed +
    epoch) when `shuffle` (the JAX loaders' order)."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    return idx


class BatchLoader:
    """Iterates dict batches {input: (B,H,W,3) u8, gt: ..., name: list}.

    drop_last=False keeps a ragged final batch, as the JAX loop asks for on
    one device.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling per epoch (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        return epoch_indices(len(self.dataset), self.shuffle, self.seed,
                             self.epoch)

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _assemble(self, pool: ThreadPoolExecutor, batch_idx: np.ndarray) -> dict:
        get_batch = getattr(self.dataset, "get_batch", None)
        if get_batch is not None:
            out = get_batch(batch_idx)
            if out is not None:  # fused native decode+resize path
                return out
        items = list(pool.map(self.dataset.__getitem__, batch_idx))
        out: dict = {}
        for key, v0 in items[0].items():
            vals = [it[key] for it in items]
            if isinstance(v0, (np.ndarray, int, float, np.integer, np.floating)):
                out[key] = np.stack([np.asarray(v) for v in vals])
            else:
                out[key] = vals  # e.g. filename strings
        return out

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        nb = len(self)
        if nb == 0:
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # Gives up once the consumer has gone, so the thread ends.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        lo = b * self.batch_size
                        if not put(self._assemble(pool,
                                                  idx[lo : lo + self.batch_size])):
                            return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join(timeout=10.0)


class DeviceBatchLoader:
    """BatchLoader-compatible iterator whose corpus lives on the device.

    The dataset is staged to `device` once, at construction, as uint8
    (a 44-pair 256² corpus is 17 MB); every batch is then gathered there
    with `index_select` by an index tensor. Batch composition is identical
    to `BatchLoader`'s for the same (seed, epoch, batch_size, drop_last).
    One process, as in the JAX package.
    """

    device_resident = True

    def __init__(
        self,
        dataset,
        batch_size: int,
        device,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        keys: tuple = ("input", "gt"),
    ):
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.n = len(dataset)
        host: dict = {k: [] for k in keys}
        self.names: list = []
        for i in range(self.n):
            item = dataset[i]
            for k in keys:
                host[k].append(np.asarray(item[k]))
            self.names.append(item.get("name"))
        self.corpus = {k: torch.from_numpy(np.stack(v)).to(self.device)
                       for k, v in host.items()}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return (self.n // self.batch_size if self.drop_last
                else -(-self.n // self.batch_size))

    def __iter__(self) -> Iterator[dict]:
        idx = epoch_indices(self.n, self.shuffle, self.seed, self.epoch)
        idx_dev = torch.from_numpy(idx).to(self.device)
        for b in range(len(self)):
            lo, hi = b * self.batch_size, (b + 1) * self.batch_size
            out = {k: v.index_select(0, idx_dev[lo:hi])
                   for k, v in self.corpus.items()}
            out["name"] = [self.names[i] for i in idx[lo:hi]]
            yield out


def device_prefetch(iterator: Iterator[dict], device,
                    depth: int = 2) -> Iterator[dict]:
    """Overlap the host→device copies with the card's compute.

    Each numpy array of a batch is copied into pinned host memory and sent
    `non_blocking` on a side CUDA stream, up to `depth` batches ahead of
    the one the caller holds; before a batch is handed over, the caller's
    stream waits on that batch's event, and its tensors are recorded as in
    use on the caller's stream (so the allocator does not reuse them while
    the step still reads them). On the CPU the arrays become tensors and
    nothing is ahead.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                   for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)
    buf: collections.deque = collections.deque()

    def put(batch: dict):
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    out[k] = torch.from_numpy(v).pin_memory().to(
                        device, non_blocking=True)
                else:
                    out[k] = v
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def ready(item) -> dict:
        out, event = item
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)
        return out

    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())


def interleave(*loaders) -> Iterator[dict]:
    """Round-robin over several loaders until all are exhausted — the
    reference's multi-dataloader interleaving (rotinas.py:487-519), used to
    mix underwater and atmospheric batches within an epoch."""
    iters = [iter(l) for l in loaders]
    alive = [True] * len(iters)
    while any(alive):
        for i, it in enumerate(iters):
            if not alive[i]:
                continue
            try:
                yield next(it)
            except StopIteration:
                alive[i] = False
