"""Dataset protocol and a threaded, prefetching batch loader.

The port's copy of ``enhancing_tpu/data/base.py``: worker threads build
samples, batches are stacked numpy arrays, and a bounded queue keeps a few
batches ahead. One process loads everything (the JAX copy's per-host
sharding has no counterpart on one card).
"""
from __future__ import annotations

import queue
import random
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


class Dataset:
    """Minimal map-style dataset protocol: __len__ + __getitem__ -> dict."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        raise NotImplementedError


def _stack(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Threaded batch loader with shuffling and bounded prefetch."""

    def __init__(self, dataset: Dataset, batch_size: int,
                 shuffle: bool = False, num_workers: int = 4,
                 drop_last: bool = True, seed: int = 0,
                 prefetch: int = 4) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        bs = self.batch_size
        batches = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        self._epoch += 1
        if not batches:
            return iter(())

        work: "queue.Queue" = queue.Queue()
        done: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        for i, b in enumerate(batches):
            work.put((i, b))
        stop = threading.Event()

        def put(item) -> bool:
            # give up once the consumer has gone, so no worker blocks on a
            # full queue after the loop that read it stopped
            while not stop.is_set():
                try:
                    done.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                try:
                    i, b = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    if hasattr(self.dataset, "get_batch"):
                        item = self.dataset.get_batch(b)
                    else:
                        item = _stack([self.dataset[j] for j in b])
                except Exception as e:  # surface in the consumer
                    item = e
                if not put((i, item)):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def gen():
            # emit batches in submission order
            pending: Dict[int, Any] = {}
            nxt = 0
            try:
                while nxt < len(batches):
                    while nxt not in pending:
                        i, item = done.get()
                        pending[i] = item
                    item = pending.pop(nxt)
                    nxt += 1
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()

        return gen()


class DataModuleFromConfig:
    """Config-built train/val/test loaders."""

    def __init__(self, batch_size: int, train: Optional[dict] = None,
                 validation: Optional[dict] = None,
                 test: Optional[dict] = None,
                 num_workers: Optional[int] = None) -> None:
        from ..utils.config import initialize_from_config
        self._init = initialize_from_config
        self.batch_size = batch_size
        self.num_workers = num_workers if num_workers is not None \
            else batch_size * 2
        self.dataset_configs = {}
        if train is not None:
            self.dataset_configs["train"] = train
        if validation is not None:
            self.dataset_configs["validation"] = validation
        if test is not None:
            self.dataset_configs["test"] = test
        self.datasets: Dict[str, Dataset] = {}

    def prepare_data(self) -> None:
        for cfg in self.dataset_configs.values():
            self._init(cfg)

    def setup(self, stage: Optional[str] = None) -> None:
        self.datasets = {k: self._init(cfg)
                         for k, cfg in self.dataset_configs.items()}

    def _loader(self, split: str, shuffle: bool) -> DataLoader:
        if split not in self.datasets:
            self.setup()
        return DataLoader(self.datasets[split], self.batch_size,
                          shuffle=shuffle, num_workers=self.num_workers,
                          drop_last=shuffle)

    def train_dataloader(self) -> DataLoader:
        return self._loader("train", True)

    def val_dataloader(self) -> DataLoader:
        return self._loader("validation", False)

    def test_dataloader(self) -> DataLoader:
        return self._loader("test", False)
