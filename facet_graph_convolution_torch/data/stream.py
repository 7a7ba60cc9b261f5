"""Streaming sharded datasets with a prefetching loader thread (host).

The port's own copy of ``facet_graph_convolution_tpu/data/stream.py``. The
reference unpickles the whole training set into memory
(preprocess.py:33-34, train.py:1901-1906), which fails on a corpus larger
than host memory:

- :func:`save_sharded` / :class:`ShardedDataset`: the set split into npz
  shards (each a :func:`..data.dataset.save_dataset` file) with an
  ``index.json``; training loads only the shards it samples, at most
  ``cache_shards`` at once (least recently used first out). The format is
  the JAX package's, so either package reads the other's shards;
- :class:`PrefetchLoader`: a background thread that draws patch indices in
  shard-aware order from ``np.random.default_rng(seed)`` (the JAX loader's
  sequence for the same seed), runs the caller's ``prepare`` on each and
  queues the results, or windows of them, a bounded depth ahead.

In the port the loader thread does host work only (NumPy): the trainer
(``training/trainer.py::train_normals_streaming``) copies what it prepared
to the card on its own thread, so no CUDA call is made from the loader
thread, where it would serialise with the training stream or break a CUDA
graph capture.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from facet_graph_convolution_torch.data.dataset import (
    MeshDataset,
    load_dataset,
    save_dataset,
)


def save_sharded(ds: MeshDataset, out_dir: str, patches_per_shard: int = 32) -> int:
    """Split ``ds`` into npz shards of ``patches_per_shard`` patches and an
    ``index.json`` (with ``max_num_nodes``, the largest patch, so that a
    consumer picks one bucket without touching a shard); returns the number
    of shards."""
    os.makedirs(out_dir, exist_ok=True)
    num = len(ds.patches)
    shards = []
    for si, start in enumerate(range(0, num, patches_per_shard)):
        sub = MeshDataset(
            max_patch_size=ds.max_patch_size,
            coarsening_steps=ds.coarsening_steps,
            coarsening_levels=ds.coarsening_levels,
            k_faces=ds.k_faces,
        )
        sub.patches = ds.patches[start:start + patches_per_shard]
        name = f"shard_{si:05d}.npz"
        save_dataset(sub, os.path.join(out_dir, name))
        shards.append({"file": name, "num_patches": len(sub.patches)})
    with open(os.path.join(out_dir, "index.json"), "w") as fh:
        json.dump(
            {
                "num_patches": num,
                "patches_per_shard": patches_per_shard,
                "max_num_nodes": max((p.num_nodes for p in ds.patches), default=0),
                "shards": shards,
            },
            fh,
            indent=2,
        )
    return len(shards)


class ShardedDataset:
    """Lazy view of a :func:`save_sharded` directory: patches load on
    demand, with at most ``cache_shards`` shards in memory."""

    def __init__(self, shard_dir: str, cache_shards: int = 2):
        self.shard_dir = shard_dir
        with open(os.path.join(shard_dir, "index.json")) as fh:
            self.index = json.load(fh)
        self.num_patches = self.index["num_patches"]
        self._locate: List[Tuple[int, int]] = []
        for si, shard in enumerate(self.index["shards"]):
            for li in range(shard["num_patches"]):
                self._locate.append((si, li))
        self._cache: "collections.OrderedDict[int, MeshDataset]" = collections.OrderedDict()
        self.cache_shards = cache_shards
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self.num_patches

    def _shard(self, si: int) -> MeshDataset:
        with self._lock:
            if si in self._cache:
                self._cache.move_to_end(si)
                return self._cache[si]
        loaded = load_dataset(os.path.join(self.shard_dir, self.index["shards"][si]["file"]))
        with self._lock:
            self._cache[si] = loaded
            while len(self._cache) > self.cache_shards:
                self._cache.popitem(last=False)
        return loaded

    def patch(self, i: int):
        si, li = self._locate[i]
        return self._shard(si).patches[li]

    @property
    def max_num_nodes(self) -> int:
        """The largest patch's node count: from the index where
        :func:`save_sharded` wrote it, else found by loading every shard
        once."""
        cached = self.index.get("max_num_nodes")
        if cached:
            return int(cached)
        best = 0
        for si in range(len(self.index["shards"])):
            best = max(best, max(p.num_nodes for p in self._shard(si).patches))
        self.index["max_num_nodes"] = best
        return best


class PrefetchLoader:
    """Prepared training items from a background thread.

    ``prepare(patch, index)`` maps a patch and its global index (a stable
    memo key: patch objects are made anew when a shard is loaded again) to
    what the consumer takes. ``depth`` bounds the queued items. With
    ``window``, the thread gathers ``window`` prepared items, hands the list
    to ``collate`` (default: the list itself) and queues ``(collated,
    count)``; the last window may be shorter. ``num_items`` items are
    prepared in all (None: without end), then iteration stops. An exception
    on the thread is raised in the consumer at its next item.

    The order is shard-aware: each epoch visits the shards in a new random
    order and each shard's patches in a random order, so that one shard's
    load serves all of its patches.
    """

    def __init__(
        self,
        dataset: ShardedDataset,
        prepare: Callable,
        seed: int = 0,
        depth: int = 2,
        num_items: Optional[int] = None,
        window: Optional[int] = None,
        collate: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.prepare = prepare
        self.num_items = num_items
        self.window = window
        self.collate = collate
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._rng = np.random.default_rng(seed)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _indices(self):
        """Patch indices without end: shuffled shards, shuffled within."""
        shards = self.dataset.index["shards"]
        starts = np.cumsum([0] + [s["num_patches"] for s in shards])
        while True:
            for si in self._rng.permutation(len(shards)):
                for li in self._rng.permutation(shards[si]["num_patches"]):
                    yield int(starts[si] + li)

    def _run(self):
        produced = 0
        order = self._indices()
        pending = []
        try:
            while not self._stop.is_set():
                if self.num_items is not None and produced >= self.num_items:
                    if pending:
                        self._emit(self._collate(pending))
                    self._emit(StopIteration)
                    return
                idx = next(order)
                item = self.prepare(self.dataset.patch(idx), idx)
                produced += 1
                if self.window is None:
                    self._emit(item)
                else:
                    pending.append(item)
                    if len(pending) == self.window:
                        self._emit(self._collate(pending))
                        pending = []
        except Exception as exc:            # raised in the consumer, at its next item
            self._emit(exc)

    def _collate(self, items):
        return (self.collate(items) if self.collate else list(items), len(items))

    def _emit(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is StopIteration:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the thread and drop what it queued; it ends within one
        ``prepare`` and a 0.2 s wait."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60)
