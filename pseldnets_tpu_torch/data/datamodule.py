"""SELDDataModule: concatenated per-corpus datasets + threaded prefetching
loaders producing numpy batches ready for device_put.

Parity: reference src/data/datamodule.py:13-98 (train/valid/test set assembly
from the cfg.data.*_dataset {name: rooms} dicts, custom infinite train
sampler, sequential full-dataset val/test on every rank). A copy of the JAX package's
data/datamodule.py.
"""

import queue
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional

import numpy as np

from .dataset import USER_DATASETS
from .sampler import DistributedBatchSampler


class ConcatDataset:
    def __init__(self, datasets: List):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[d][idx - self.offsets[d]]


def collate(samples: List[Dict]) -> Dict:
    """Stack array fields, keep str fields as lists (torch default_collate-ish)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        else:
            out[key] = vals
    return out


class _PrefetchIterator:
    """Background prefetch over an index-batch iterator.

    Batch items are fetched through a thread pool — the native FLAC/WAV
    decoder releases the GIL inside ctypes, so item decode parallelizes
    across host cores (the reference's stated throughput bottleneck,
    SURVEY §3.1 hot loop 4)."""

    def __init__(self, dataset, batch_iter: Iterator, num_batches: Optional[int],
                 prefetch: int = 4, num_threads: Optional[int] = None):
        import os

        self.dataset = dataset
        self.batch_iter = batch_iter
        self.num_batches = num_batches
        self.num_threads = num_threads or min(os.cpu_count() or 1, 8)
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._produced = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        from concurrent.futures import ThreadPoolExecutor

        try:
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                for batch_idx in self.batch_iter:
                    if self._stop.is_set():
                        return
                    if self.num_batches is not None and self._produced >= self.num_batches:
                        break
                    if self.num_threads > 1 and len(batch_idx) > 1:
                        items = list(pool.map(self.dataset.__getitem__,
                                              [int(i) for i in batch_idx]))
                    else:
                        items = [self.dataset[int(i)] for i in batch_idx]
                    batch = collate(items)
                    self._produced += 1
                    if not self._put(batch):
                        return
        finally:
            self._put(None)

    def _put(self, item) -> bool:
        """Bounded put that keeps checking the stop flag — a consumer that
        abandons the iterator mid-stream (an exception) must
        not leave this thread blocked in q.put forever, leaking the thread,
        its executor pool and open file handles every epoch."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        """Unblock and retire the worker; safe to call multiple times."""
        self._stop.set()
        try:  # drain one slot so a worker blocked in q.put exits promptly
            self.q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close()


class SELDDataModule:
    def __init__(self, cfg, dataset, stage="fit"):
        self.cfg = cfg
        self.dataset = dataset
        self.seed = cfg.get("seed", 2024)
        self.paths_dict = OrderedDict()
        self.valid_gt_dcaseformat = OrderedDict()
        method = cfg["model"]["method"]
        ds_cls = USER_DATASETS[method]

        if stage == "fit":
            train_sets, val_sets = [], []
            for name, rooms in cfg["data"]["train_dataset"].items():
                train_sets.append(ds_cls(cfg, dataset, name, rooms, "train"))
            self.train_set = ConcatDataset(train_sets)
            for name, rooms in cfg["data"]["valid_dataset"].items():
                s = ds_cls(cfg, dataset, name, rooms, "valid")
                val_sets.append(s)
                self.paths_dict.update(s.paths_dict)
                self.valid_gt_dcaseformat.update(s.valid_gt_dcaseformat)
            self.val_set = ConcatDataset(val_sets)
            self.train_batch_size = cfg["model"]["batch_size"]
        elif stage == "test":
            test_sets = []
            for name, rooms in cfg["data"]["test_dataset"].items():
                s = ds_cls(cfg, dataset, name, rooms, "test")
                test_sets.append(s)
                self.paths_dict.update(s.paths_dict)
            self.test_set = ConcatDataset(test_sets)
            self.test_batch_size = cfg["model"]["batch_size"]

    def steps_per_epoch(self) -> int:
        sampler = DistributedBatchSampler(len(self.train_set),
                                          self.train_batch_size, seed=self.seed)
        return len(sampler)

    def train_dataloader(self, num_batches: Optional[int] = None):
        sampler = DistributedBatchSampler(len(self.train_set),
                                          self.train_batch_size, seed=self.seed)
        if num_batches is None:
            num_batches = len(sampler)
        return _PrefetchIterator(self.train_set, iter(sampler), num_batches)

    def _sequential_loader(self, dataset, batch_size):
        def gen():
            idx = np.arange(len(dataset))
            for i in range(0, len(idx), batch_size):
                yield idx[i:i + batch_size]

        return _PrefetchIterator(dataset, gen(), None)

    def val_dataloader(self):
        return self._sequential_loader(self.val_set, self.train_batch_size)

    def test_dataloader(self):
        return self._sequential_loader(self.test_set, self.test_batch_size)
